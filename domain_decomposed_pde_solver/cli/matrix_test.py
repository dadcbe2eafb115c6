"""Power-method driver — the ``ExodusMatrixTest`` executable.

Parity with ``ExodusMatrixTest.cpp:131-171``: build the full-mesh Laplacian
(``IO::getMatrix``) and run 500 power iterations at tol 1e-2, reporting every
50 (``:166, :95``).  With ``--partitions >= 2`` the operator is sharded over
the device mesh, matching the reference's >= 2-rank requirement
(``ExodusMatrixTest.cpp:146-149``); single-device runs are also allowed.

Usage::

    python -m domain_decomposed_pde_solver.cli.matrix_test \
        --input data/2blocks.exo --partitions 2
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--tolerance", type=float, default=1e-2)
    ap.add_argument("--reportFrequency", type=int, default=50)
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from ..io import read_exodus
    from ..models import assemble_full_laplacian

    from ..io import ExodusReadError

    try:
        mesh = read_exodus(args.input)
    except (ExodusReadError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    L = assemble_full_laplacian(mesh)
    rng = np.random.default_rng(args.seed)
    z0_host = rng.uniform(size=L.n_rows)

    if args.partitions > 1:
        from ..ops import coo_to_csr
        from ..parallel import (
            ShardedOperator,
            build_halo_plan,
            make_device_mesh,
            partition_graph,
            sharded_power_method,
        )

        rows = np.repeat(np.arange(L.n_rows), L.row_lengths())
        off = rows != L.indices
        adj = coo_to_csr(
            rows[off], L.indices[off], np.ones(int(off.sum())), L.shape,
            sum_dups=False,
        )
        parts = partition_graph(adj, args.partitions, coords=mesh.coords)
        plan = build_halo_plan(L, parts, args.partitions)
        op = ShardedOperator.from_plan(plan, make_device_mesh(args.partitions))
        res = sharded_power_method(
            op, op.put_vector(z0_host), maxiter=args.iterations,
            tol=args.tolerance, check_every=args.reportFrequency,
        )
    else:
        import jax.numpy as jnp

        from ..ops import ell_from_csr, pad_vector
        from ..solvers import power_method

        A = ell_from_csr(L, dtype=jnp.float64)
        z0 = pad_vector(z0_host, A.n_pad)
        # Chunked so intermediate lambda estimates print every
        # reportFrequency iterations, like the reference
        # (``ExodusMatrixTest.cpp:95-107``).
        done = 0
        z = z0
        res = power_method(A, z0, maxiter=0, tol=args.tolerance, check_every=1)
        while done < args.iterations:
            step = min(args.reportFrequency, args.iterations - done)
            res = power_method(
                A, z, maxiter=step, tol=args.tolerance, check_every=step
            )
            z = res.eigenvector
            done += max(int(res.iterations), 1)
            print(
                f"  iteration {done}: lambda ~= {float(res.eigenvalue):.10g} "
                f"residual {float(res.residual):.3e}"
            )
            if bool(res.converged):
                break

    total = done if args.partitions <= 1 else int(res.iterations)
    print(
        f"lambda_max ~= {float(res.eigenvalue):.10g} after "
        f"{total} iterations (residual "
        f"{float(res.residual):.3e}, converged={bool(res.converged)})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

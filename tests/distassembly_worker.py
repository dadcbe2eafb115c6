"""Worker for the 2-process distributed-assembly test (>=1M DOF).

Run as: python distassembly_worker.py <pid> <nproc> <port> <outdir> <mesh.exo>

Each process reads ONLY its element slice of a 1,030,301-node box, ships
edge keys to row owners over a cross-process device all_to_all (gloo),
assembles only its 4 parts' rows, and uploads only its blocks.  Rank 0
additionally builds the global matrix the single-host way and asserts its
own packed blocks are bit-identical to the global halo plan's; both ranks
then run one sharded SpMV and rank 0 checks it against the scipy matvec.
The global CSR is never materialized on the distributed path itself.
"""

import sys


def main():
    pid, nproc, port, outdir, mesh_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5],
    )
    import os

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from domain_decomposed_pde_solver.parallel.multihost import (
        initialize_multihost,
    )

    got = initialize_multihost(f"localhost:{port}", nproc, pid)
    assert got == pid
    nparts = 4 * nproc
    assert len(jax.devices()) == nparts

    import numpy as np

    from domain_decomposed_pde_solver.parallel.distassembly import (
        assemble_heat_multihost,
    )

    op, b_s, plan, state = assemble_heat_multihost(mesh_path, nparts=nparts)
    assert state.n_free >= 1_000_000, state.n_free
    k = nparts // nproc

    if pid == 0:
        # Single-host reference: global assembly + global plan; this
        # rank's distributed blocks must be bit-identical slices of it.
        from domain_decomposed_pde_solver.io import read_exodus
        from domain_decomposed_pde_solver.models import (
            assemble_heat_system,
        )
        from domain_decomposed_pde_solver.parallel.halo import (
            build_halo_plan,
        )

        mesh = read_exodus(mesh_path)
        sys_ = assemble_heat_system(mesh)
        plan_g = build_halo_plan(sys_.A, state.owner_free, nparts)
        assert plan.n_local == plan_g.n_local
        assert plan.halo_width == plan_g.halo_width
        np.testing.assert_array_equal(plan.ell_cols, plan_g.ell_cols[:k])
        np.testing.assert_array_equal(plan.ell_vals, plan_g.ell_vals[:k])
        np.testing.assert_array_equal(plan.send_idx, plan_g.send_idx[:k])
        S = sys_.A.to_scipy()
        b_ref = sys_.b
    # One sharded SpMV across both hosts' devices vs the scipy matvec.
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from domain_decomposed_pde_solver.parallel.sharded import (
        AXIS,
        _local_spmv,
    )

    rng = np.random.default_rng(7)  # same seed -> same x on both ranks
    x = rng.standard_normal(state.n_free)
    x_s = op.put_vector(x)

    def body(cols, vals, send_idx, xb):
        return _local_spmv(cols[0], vals[0], send_idx[0], xb[0])[None]

    y_s = jax.shard_map(
        body,
        mesh=op.mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=True,
    )(op.cols, op.vals, op.send_idx, x_s)

    from jax.experimental import multihost_utils

    y_full = np.asarray(multihost_utils.process_allgather(y_s, tiled=True))
    b_full = np.asarray(multihost_utils.process_allgather(b_s, tiled=True))
    y = plan.gather_vector(y_full)
    b = plan.gather_vector(b_full)

    if pid == 0:
        np.testing.assert_allclose(y, S @ x, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(b, b_ref, rtol=0, atol=0)

    with open(os.path.join(outdir, f"dok.{pid}"), "w") as f:
        f.write(
            f"n_free={state.n_free} H={plan.halo_width} "
            f"ynorm={np.linalg.norm(y):.12e}\n"
        )


if __name__ == "__main__":
    main()

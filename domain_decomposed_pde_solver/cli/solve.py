"""Heat-equation solve driver — the ``BelosMueLuSolver`` executable.

Pipeline parity with ``BelosMueLuSolver.cpp:141-218``:
open → assemble → dump A and B (``[Laplacian: A]`` / ``[RHS: B]`` sections to
``$PREFIX$PART.out``) → create the solution file containing the mesh
decomposed into ``max(2, nparts)`` partition blocks (``:206-210``) → Krylov
solve with per-iteration solution snapshots (``:112-133``) → dump X
(``[Solution: X]``).

Differences from the reference: the solver is CG by default (GMRES available with
``--solver gmres`` for literal parity), the preconditioner is
Jacobi/Chebyshev/AMG instead of ILUT, and multi-device runs shard over a
``jax.sharding.Mesh`` (``--partitions N``) instead of MPI ranks.

Usage::

    python -m domain_decomposed_pde_solver.cli.solve \
        --input data/tet-cube-heat.exo --solution solution.exo \
        --tolerance 1e-12 --iterations 300 --partitions 4
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    from ..utils.config import add_solve_args, config_from_args

    add_solve_args(ap)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--x64", action="store_true", help="enable float64")
    ap.add_argument(
        "--debug-nans", action="store_true",
        help="abort on NaN/Inf in any device computation (the framework's "
        "sanitizer switch; the reference compiled ASan into every binary, "
        "build.sh:77)",
    )
    args = ap.parse_args(argv)
    cfg = config_from_args(args)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.x64 or cfg.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    from ..utils.compilecache import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp

    from ..io import ExodusSolutionWriter, read_exodus
    from ..models import assemble_heat_system
    from ..parallel import decompose_mesh
    from ..solvers import cg_solve_snapshots, gmres_solve
    from ..utils import PhaseTimer, print_csr_matrix, print_vector

    timer = PhaseTimer()
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    from ..io import ExodusReadError

    with timer.phase("read"):
        try:
            mesh = read_exodus(cfg.input)
        except (ExodusReadError, FileNotFoundError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if cfg.refine > 0:
        from ..io import refine_uniform

        with timer.phase("refine"):
            mesh = refine_uniform(mesh, cfg.refine)
        print(f"Refined x{cfg.refine}: {mesh.num_nodes} nodes, {mesh.num_elem} elements")
    if cfg.verbose:
        print(
            f"Title: {mesh.title}\n# of Nodes: {mesh.num_nodes}\n"
            f"# of Elements: {mesh.num_elem}\n# of Element Blocks: "
            f"{len(mesh.blocks)}\n# of Node Sets: {len(mesh.node_sets)}\n"
            f"# of Side Sets: {len(mesh.side_sets)}"
        )

    with timer.phase("assemble"):
        system = assemble_heat_system(mesh)
    print(
        f"Assembled {system.n_free} x {system.n_free} Laplacian "
        f"(nnz={system.A.nnz}) from {mesh.num_nodes} nodes"
    )

    if cfg.output_prefix:
        with timer.phase("debug-dumps"):
            print_csr_matrix(system.A, "Laplacian: A", cfg.output_prefix)
            print_vector(system.b, "RHS: B", cfg.output_prefix)

    # Solution file: mesh decomposed into max(2, nparts) partition blocks
    # (the reference hardwires the same, ``BelosMueLuSolver.cpp:210``).
    with timer.phase("decompose"):
        viz_parts = max(2, cfg.partitions)
        out_mesh = decompose_mesh(mesh, viz_parts)

    # Initial X randomized like the reference (``ExodusIO.hpp:664-666``).
    rng = np.random.default_rng(cfg.seed)
    x0_host = rng.uniform(-1.0, 1.0, size=system.n_free)

    if cfg.partitions > 1:
        writer = ExodusSolutionWriter(cfg.solution, out_mesh)
        writer.write_boundary_timestep()

        def snap_cb(total, x_now):
            writer.write_solution(x_now, system.free_to_node, total)

        with timer.phase("solve"):
            result, x_host = _solve_sharded(
                cfg, system, x0_host, dtype,
                snapshot_cb=snap_cb if cfg.snapshots else None,
            )
        if not cfg.snapshots:
            writer.write_solution(
                x_host, system.free_to_node, int(result.iterations)
            )
        writer.close()
    elif (
        cfg.dtype == "float64"
        and cfg.precond == "amg"
        and cfg.solver == "cg"
        and not cfg.snapshots
        and not cfg.checkpoint
        and np.all(
            system.A.data.astype(np.float32).astype(np.float64)
            == system.A.data
        )
    ):
        # f64 + AMG + CG without per-iteration snapshots: mixed-
        # precision iterative refinement — f32 inner CG+AMG sweeps
        # with an f64 outer residual reach f64 accuracy
        # (solvers/mixed.py).
        from ..solvers.mixed import iterative_refinement_solve
        from ..solvers.precond.amg import (
            infer_free_grid,
            smoothed_aggregation_setup,
        )
        from ..ops import choose_operator

        op_dims = (
            infer_free_grid(system.mesh, system.free_to_node)
            if system.mesh is not None
            else None
        )
        with timer.phase("operator"):
            A32 = choose_operator(
                system.A, dtype=jnp.float32, grid_dims=op_dims
            )
        with timer.phase("precond-setup"):
            M32 = smoothed_aggregation_setup(
                system.A, dtype=jnp.float32, grid_dims=op_dims
            )
        with timer.phase("solve"):
            mr = iterative_refinement_solve(
                system.A, system.b, x0=x0_host,
                tol=cfg.tolerance, inner_maxiter=cfg.iterations,
                precond=M32, operator=A32,
            )
        from ..solvers.cg import CGResult

        result = CGResult(
            x=mr.x, iterations=mr.inner_iterations, relres=mr.relres,
            converged=mr.converged,
        )
        x_host = mr.x
        writer = ExodusSolutionWriter(cfg.solution, out_mesh)
        writer.write_boundary_timestep()
        writer.write_solution(
            x_host, system.free_to_node, int(mr.inner_iterations)
        )
        writer.close()
    else:
        from ..ops import choose_operator
        from ..solvers.precond.amg import infer_free_grid

        op_dims = (
            infer_free_grid(system.mesh, system.free_to_node)
            if system.mesh is not None
            else None
        )
        with timer.phase("operator"):
            A = choose_operator(system.A, dtype=dtype, grid_dims=op_dims)
        if cfg.verbose:
            print(f"operator format: {type(A).__name__}")
        b = (
            # Boundary-sparse RHS: ship only the nonzeros when the
            # operator supports it (~3% of rows at 10M DOF).
            A.put_vector_sparse(system.b.astype(np.dtype(dtype)))
            if hasattr(A, "put_vector_sparse")
            else A.put_vector(system.b.astype(np.dtype(dtype)))
        )
        x0 = A.put_vector(x0_host.astype(np.dtype(dtype)))
        with timer.phase("precond-setup"):
            precond = _make_precond(cfg, A, system)
        writer = ExodusSolutionWriter(cfg.solution, out_mesh)
        writer.write_boundary_timestep()
        with timer.phase("solve"):
            if cfg.solver == "gmres":
                if cfg.snapshots:
                    # One snapshot per restart cycle, warm-started — the
                    # convergence-animation behavior of the reference's
                    # solve/writeSolution/reset loop
                    # (``BelosMueLuSolver.cpp:112-133``) without its
                    # Krylov-space-destroying per-iteration reset.  With
                    # --snapshot-every-iteration the reset IS reproduced
                    # literally: one outer iteration per solve call, then
                    # write X and restart from it (animation parity).
                    per_iter = cfg.snapshot_every_iteration
                    x_cur = x0
                    total = 0
                    result = None
                    while total < cfg.iterations:
                        step = (
                            1 if per_iter
                            else min(cfg.restart, cfg.iterations - total)
                        )
                        result = gmres_solve(
                            A, b, x_cur, precond=precond,
                            # restart=1 makes each call exactly one
                            # Arnoldi step from a fresh (reset) Krylov
                            # space — Belos with maxiter 1 per solve.
                            restart=1 if per_iter else cfg.restart,
                            tol=cfg.tolerance, maxiter=step,
                        )
                        x_cur = result.x
                        total += max(int(result.iterations), 1)
                        writer.write_solution(
                            A.get_vector(x_cur),
                            system.free_to_node, total,
                        )
                        if cfg.verbose:
                            print(f"iter {total}: relres {float(result.relres):.3e}")
                        if bool(result.converged):
                            break
                    result = dataclasses_replace_iters(result, total)
                else:
                    result = gmres_solve(
                        A, b, x0, precond=precond, restart=cfg.restart,
                        tol=cfg.tolerance, maxiter=cfg.iterations,
                    )
                    writer.write_solution(
                        A.get_vector(result.x),
                        system.free_to_node, int(result.iterations),
                    )
                x_host = A.get_vector(result.x)
            elif cfg.solver == "bicgstab":
                from ..solvers import bicgstab_solve

                result = bicgstab_solve(
                    A, b, x0, precond=precond, tol=cfg.tolerance,
                    maxiter=cfg.iterations,
                )
                x_host = A.get_vector(result.x)
                writer.write_solution(
                    x_host, system.free_to_node, int(result.iterations)
                )
            elif cfg.checkpoint:
                from ..solvers import cg_solve_resumable

                result = cg_solve_resumable(
                    A, b, x0, checkpoint_path=cfg.checkpoint,
                    checkpoint_every=cfg.checkpoint_every,
                    precond=precond, tol=cfg.tolerance, maxiter=cfg.iterations,
                )
                x_host = A.get_vector(result.x)
                writer.write_solution(
                    x_host, system.free_to_node, int(result.iterations)
                )
            else:

                def snapshot(k, x, relres):
                    if cfg.snapshots:
                        writer.write_solution(
                            A.get_vector(x), system.free_to_node, k
                        )
                    if cfg.verbose and k % cfg.report_after_iterations == 0:
                        print(f"iter {k}: relres {relres:.3e}")

                result = cg_solve_snapshots(
                    A, b, x0, precond=precond, tol=cfg.tolerance,
                    maxiter=cfg.iterations, callback=snapshot,
                )
                x_host = A.get_vector(result.x)
                if not cfg.snapshots:
                    writer.write_solution(
                        x_host, system.free_to_node, int(result.iterations)
                    )
        writer.close()

    conv = bool(result.converged)
    # Convergence reporting parity (``BelosMueLuSolver.cpp:118-130``).
    print(
        ("Converged" if conv else "DID NOT converge")
        + f" in {int(result.iterations)} iterations "
        f"(achieved tolerance {float(result.relres):.6e})"
    )
    if cfg.output_prefix:
        print_vector(
            np.asarray(x_host), "Solution: X", cfg.output_prefix
        )
    if cfg.verbose:
        print(timer.report())
    return 0 if conv else 1


def dataclasses_replace_iters(result, total):
    import dataclasses

    import jax.numpy as jnp

    return dataclasses.replace(result, iterations=jnp.int32(total))


def _make_precond(cfg, A, system):
    from ..solvers import (
        chebyshev_preconditioner,
        estimate_lmax_dinv_a,
        jacobi_preconditioner,
        smoothed_aggregation_setup,
    )

    if cfg.precond == "none":
        return None
    if cfg.precond == "jacobi":
        return jacobi_preconditioner(A)
    if cfg.precond == "chebyshev":
        lmax = estimate_lmax_dinv_a(A)
        return chebyshev_preconditioner(A, lmax)
    if cfg.precond == "ilu0":
        # Reference-parity incomplete factorization (the reference's
        # production preconditioner family, ``BelosMueLuSolver.cpp:92-97``);
        # host factorization + level-scheduled device triangular solves.
        from ..solvers import ilu0_preconditioner

        return ilu0_preconditioner(system.A, n_pad=A.n_pad, dtype=A.dtype)
    if cfg.precond == "ilut":
        # The literal Ifpack2-ILUT analogue at its defaults
        # (level-of-fill 1.0, drop tol 0 — ``BelosMueLuSolver.cpp:92-97``).
        from ..solvers import ilut_preconditioner

        return ilut_preconditioner(system.A, n_pad=A.n_pad, dtype=A.dtype)
    if cfg.precond == "amg":
        from ..solvers.precond.amg import infer_free_grid

        # Structured meshes get gather-free brick transfers (see
        # precond/amg.py); unstructured meshes return None here.
        dims = (
            infer_free_grid(system.mesh, system.free_to_node)
            if system.mesh is not None
            else None
        )
        return smoothed_aggregation_setup(
            system.A, dtype=A.dtype, grid_dims=dims
        )
    raise ValueError(cfg.precond)


def _solve_sharded(cfg, system, x0_host, dtype, snapshot_cb=None):
    import jax.numpy as jnp
    import numpy as np

    from ..ops import coo_to_csr
    from ..parallel import (
        ShardedOperator,
        build_halo_plan,
        make_device_mesh,
        partition_graph,
        sharded_cg_solve,
        sharded_gmres_solve,
    )

    # Structured meshes + AMG: the sharded *global* hierarchy (slab fine
    # level + local brick transfers + replicated coarse tail) gives
    # P-independent iteration counts — identical to the single-device
    # hierarchy (parallel/slabamg.py).  Falls through to block-Schwarz for
    # unstructured meshes.
    if cfg.precond == "amg" and cfg.solver != "gmres":
        from ..parallel.slabamg import build_slab_amg, slab_amg_cg_solve
        from ..solvers.precond.amg import infer_free_grid

        dims = (
            infer_free_grid(system.mesh, system.free_to_node)
            if system.mesh is not None
            else None
        )
        if dims is not None and int(np.prod(dims)) == system.A.n_rows:

            samg = build_slab_amg(
                system.A, dims, cfg.partitions, dtype=np.dtype(dtype)
            )
            if samg is not None:
                if cfg.verbose:
                    print("distributed preconditioner: slab global AMG")
                x_host, result = slab_amg_cg_solve(
                    samg,
                    system.b.astype(np.dtype(dtype)),
                    x0_host.astype(np.dtype(dtype)),
                    tol=cfg.tolerance,
                    maxiter=cfg.iterations,
                )
                if snapshot_cb is not None:
                    snapshot_cb(int(result.iterations), x_host)
                return result, x_host

    A = system.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(
        rows[off], A.indices[off], np.ones(int(off.sum())), A.shape, sum_dups=False
    )
    coords = (
        system.mesh.coords[system.free_to_node] if system.mesh is not None else None
    )
    parts = partition_graph(adj, cfg.partitions, coords=coords)
    plan = build_halo_plan(A, parts, cfg.partitions, dtype=np.dtype(dtype))
    op = ShardedOperator.from_plan(plan, make_device_mesh(cfg.partitions))
    b = op.put_vector(system.b)
    x0 = op.put_vector(x0_host)
    # Honor --precond.  For amg + CG the default is the sharded GLOBAL
    # hierarchy (parallel/haloamg.py — P-independent iteration counts);
    # block-Schwarz (communication-free local V-cycles) remains the
    # fallback if the global build fails.
    block_amg = None
    halo_amg = None
    if cfg.precond == "none":
        inv_d = None
    else:
        # Guard degree-0 rows (orphan free nodes): 1/0 -> inf would
        # NaN-poison the distributed CG through the preconditioner apply.
        deg = np.where(system.degree > 0, system.degree, 1.0)
        inv_d = op.put_vector(1.0 / deg)
        if cfg.precond == "amg":
            if cfg.solver == "gmres":
                print(
                    "warning: distributed AMG is CG-only; "
                    "using Jacobi for the multi-device GMRES solve"
                )
            else:
                from ..parallel.haloamg import build_halo_amg

                halo_amg = build_halo_amg(A, plan, dtype=np.dtype(dtype))
                if halo_amg is None:
                    from ..parallel.schwarz import build_block_amg

                    block_amg = build_block_amg(A, plan, dtype=np.dtype(dtype))
                    if block_amg is None:
                        print("warning: AMG build failed; using Jacobi")
    if cfg.verbose:
        kind = (
            "halo global AMG" if halo_amg is not None
            else "block-Schwarz AMG" if block_amg is not None
            else "diagonal"
        )
        print(f"distributed preconditioner: {kind}")
    if halo_amg is not None and snapshot_cb is None:
        from ..parallel.haloamg import halo_amg_cg_solve

        x_host, result = halo_amg_cg_solve(
            op, halo_amg, system.b.astype(np.dtype(dtype)),
            x0_host.astype(np.dtype(dtype)),
            tol=cfg.tolerance, maxiter=cfg.iterations,
        )
        return result, x_host
    if halo_amg is not None:
        from ..parallel.haloamg import halo_amg_cg_solve

        print(
            "note: per-chunk snapshots are not yet supported with the "
            "sharded global AMG; writing only the final state"
        )
        x_host, result = halo_amg_cg_solve(
            op, halo_amg, system.b.astype(np.dtype(dtype)),
            x0_host.astype(np.dtype(dtype)),
            tol=cfg.tolerance, maxiter=cfg.iterations,
        )
        snapshot_cb(int(result.iterations), x_host)
        return result, x_host
    if cfg.solver == "gmres":
        result = sharded_gmres_solve(
            op, b, x0, precond_diag=inv_d, restart=cfg.restart,
            tol=cfg.tolerance, maxiter=cfg.iterations,
        )
        if snapshot_cb is not None:
            snapshot_cb(int(result.iterations), op.get_vector(result.x))
        return result, op.get_vector(result.x)

    # For the graph Laplacian, D^-1 A = I - D^-1 Adj has spectrum in
    # [0, 2], so lmax = 2 is an exact Chebyshev bound — no estimation
    # pass needed for the distributed preconditioner.
    cheb = 2.0 if cfg.precond == "chebyshev" else None
    if snapshot_cb is None:
        result = sharded_cg_solve(
            op, b, x0, precond_diag=inv_d, cheb_lmax=cheb,
            block_amg=block_amg, tol=cfg.tolerance, maxiter=cfg.iterations,
        )
        return result, op.get_vector(result.x)

    if block_amg is not None:
        # Chunked state threading doesn't carry the block-AMG path yet; do
        # one continuous solve and snapshot the final state.
        print(
            "note: per-chunk snapshots are not yet supported with "
            "distributed block-AMG; writing only the final state"
        )
        result = sharded_cg_solve(
            op, b, x0, precond_diag=inv_d, cheb_lmax=cheb,
            block_amg=block_amg, tol=cfg.tolerance, maxiter=cfg.iterations,
        )
        snapshot_cb(int(result.iterations), op.get_vector(result.x))
        return result, op.get_vector(result.x)

    # Snapshot mode: chunked solves threading the exact CG state between
    # chunks — one distributed gather + Exodus timestep per chunk (the
    # reference's per-iteration writeSolution, ``BelosMueLuSolver.cpp:
    # 112-133``) at a configurable cadence (--reportAfterIterations), with
    # NO Krylov restart penalty.
    from ..parallel import sharded_cg_chunk

    chunk = max(1, cfg.report_after_iterations)
    x_cur = x0
    state = None
    total = 0
    result = None
    while total < cfg.iterations:
        step = min(chunk, cfg.iterations - total)
        result, state = sharded_cg_chunk(
            op, b, x_cur, state, precond_diag=inv_d, cheb_lmax=cheb,
            tol=cfg.tolerance, maxiter=step,
        )
        x_cur = result.x
        total += max(int(result.iterations), 1)
        snapshot_cb(total, op.get_vector(x_cur))
        if bool(result.converged):
            break
    result = dataclasses_replace_iters(result, total)
    return result, op.get_vector(result.x)


if __name__ == "__main__":
    sys.exit(main())

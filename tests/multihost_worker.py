"""Worker for tests/test_multihost.py — one 'host' of a 2-process solve.

Run as: python multihost_worker.py <process_id> <num_processes> <port> <outdir>

Each process: distributed init (gloo over localhost), per-host device
placement of its slabs, SPMD slab CG across all 8 global devices, full
allgather, residual check, sharded checkpoint write/readback.
"""

import sys


def main():
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    import os

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    from domain_decomposed_pde_solver.parallel.multihost import (
        initialize_multihost,
        load_sharded_checkpoint,
        multihost_slab_cg_solve,
        save_sharded_checkpoint,
    )

    got = initialize_multihost(f"localhost:{port}", nproc, pid)
    assert got == pid, (got, pid)
    assert len(jax.devices()) == 4 * nproc

    import numpy as np

    from domain_decomposed_pde_solver.io.boxmesh import box_mesh
    from domain_decomposed_pde_solver.models import assemble_heat_system
    from domain_decomposed_pde_solver.parallel.slab import build_slab_plan

    # Every process reads the same mesh (the reference's model:
    # ``ExodusIO.hpp:88-100``); device data is placed per host.
    mesh = box_mesh(16, 16, 32, elem_type="TETRA4")
    sy = assemble_heat_system(mesh)
    plan = build_slab_plan(sy.A, nparts=4 * nproc)
    assert plan is not None

    b = sy.b.astype(np.float32) / float(np.abs(sy.b).max())
    x, res = multihost_slab_cg_solve(
        plan, b, np.zeros_like(b), tol=1e-6, maxiter=2000
    )
    assert bool(res.converged), float(res.relres)

    import scipy.sparse as sp

    S = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr), shape=sy.A.shape)
    relres = np.linalg.norm(S @ x.astype(np.float64) - b) / np.linalg.norm(b)
    assert relres < 1e-4, relres

    # Sharded checkpoint round-trip: each process writes only its shards.
    ck = save_sharded_checkpoint(os.path.join(outdir, "ck"), {"x": res.x})
    back = load_sharded_checkpoint(os.path.join(outdir, "ck"))
    total_rows = sum(v.shape[0] for v in back["x"].values())
    assert total_rows * plan.slab >= plan.n // nproc

    with open(os.path.join(outdir, f"ok.{pid}"), "w") as f:
        f.write(f"iters={int(res.iterations)} relres={relres:.3e}\n")


if __name__ == "__main__":
    main()

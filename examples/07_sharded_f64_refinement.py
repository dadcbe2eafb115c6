"""Distributed f64-accurate solve: sharded CG + global SA-AMG in f64.

The slab engine (z-slab sharded operator with ppermute halo strips, global
sharded SA-AMG hierarchy with local brick transfers and a replicated
coarse tail, ``parallel/slabamg.py``) runs CG in f64 to a true residual
below anything a pure-f32 solve can reach, on P devices, with the
single-device iteration count.  The reference has no distributed AMG
(`BelosMueLuSolver.cpp:87-139` is f64 GMRES+ILUT throughout).

Run (8 virtual devices on CPU):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/07_sharded_f64_refinement.py
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")  # or leave default for the GPU
jax.config.update("jax_enable_x64", True)

import numpy as np
import scipy.sparse as sp

from domain_decomposed_pde_solver.io import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.parallel import (
    build_slab_amg,
    slab_amg_cg_solve,
)
from domain_decomposed_pde_solver.solvers.precond.amg import (
    infer_free_grid,
)


def main():
    mesh = box_mesh(26, 26, 46, elem_type="TETRA4")
    system = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, system.free_to_node)
    print(f"{system.n_free} free DOF, free grid {dims}")
    S = sp.csr_matrix(
        (system.A.data, system.A.indices, system.A.indptr),
        shape=system.A.shape,
    )

    for P in (2, 4):
        if len(jax.devices()) < P:
            continue
        samg = build_slab_amg(system.A, dims, P, dtype=np.float64)
        if samg is None:
            print(f"P={P}: slab layout unavailable for these dims")
            continue
        x, res = slab_amg_cg_solve(
            samg, system.b, np.zeros(system.n_free), tol=1e-10
        )
        true_rr = np.linalg.norm(S @ x - system.b) / np.linalg.norm(system.b)
        print(
            f"P={P}: {int(res.iterations)} f64 CG iterations "
            f"-> true f64 residual {true_rr:.1e}"
        )
        assert true_rr < 1e-9


if __name__ == "__main__":
    main()

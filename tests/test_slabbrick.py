"""Two-level brick-Schwarz preconditioner for the slab decomposition."""

import numpy as np
import pytest

from domain_decomposed_pde_solver.io.boxmesh import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.parallel.slab import (
    build_slab_plan,
    slab_cg_solve,
)
from domain_decomposed_pde_solver.parallel.slabbrick import (
    build_slab_brick_precond,
)
from domain_decomposed_pde_solver.solvers.precond.amg import (
    infer_free_grid,
)


@pytest.fixture(scope="module")
def slab_problem():
    mesh = box_mesh(26, 26, 26, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sys_.free_to_node)
    mx, my, _ = dims
    plan = build_slab_plan(sys_.A, 8, dtype=np.float64, row_align=mx * my)
    return sys_, dims, plan


def test_brick_precond_beats_jacobi_and_matches_direct(slab_problem):
    import scipy.sparse.linalg as spla

    sys_, dims, plan = slab_problem
    x0 = np.zeros(sys_.n_free)
    _, r_j = slab_cg_solve(plan, sys_.b, x0, tol=1e-10, maxiter=3000)
    bp = build_slab_brick_precond(plan, dims, brick=4, dtype=np.float64)
    x_b, r_b = slab_cg_solve(
        plan, sys_.b, x0, tol=1e-10, maxiter=3000, brick_precond=bp
    )
    assert bool(r_b.converged)
    assert int(r_b.iterations) < int(r_j.iterations)
    xd = spla.spsolve(sys_.A.to_scipy().tocsc(), sys_.b)
    assert np.abs(x_b - xd).max() / np.abs(xd).max() < 1e-8


def test_brick_precond_with_global_coarse_converges(slab_problem):
    import scipy.sparse.linalg as spla

    sys_, dims, plan = slab_problem
    bp = build_slab_brick_precond(
        plan, dims, brick=4, dtype=np.float64,
        global_coarse=True, A=sys_.A,
    )
    x_b, r_b = slab_cg_solve(
        plan, sys_.b, np.zeros(sys_.n_free), tol=1e-10, maxiter=3000,
        brick_precond=bp,
    )
    assert bool(r_b.converged)
    xd = spla.spsolve(sys_.A.to_scipy().tocsc(), sys_.b)
    assert np.abs(x_b - xd).max() / np.abs(xd).max() < 1e-8


def test_misaligned_slab_raises(slab_problem):
    sys_, dims, _ = slab_problem
    bad_plan = build_slab_plan(sys_.A, 8, dtype=np.float64)  # 8-aligned only
    with pytest.raises(ValueError, match="z-layers"):
        build_slab_brick_precond(bad_plan, dims, brick=4)

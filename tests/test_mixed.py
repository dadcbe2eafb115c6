"""Mixed-precision iterative refinement: f64 answers from an f32 device."""

import numpy as np
import pytest

from domain_decomposed_pde_solver.io import box_mesh, read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.solvers.mixed import iterative_refinement_solve


def test_refinement_reaches_f64_accuracy(data_dir):
    """The BASELINE 1e-8 match requirement, with the device in f32."""
    sys_ = assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))
    res = iterative_refinement_solve(sys_.A, sys_.b, tol=1e-10)
    assert res.converged
    import scipy.sparse.linalg as spla

    xd = spla.spsolve(sys_.A.to_scipy().tocsc(), sys_.b)
    assert np.abs(res.x - xd).max() / np.abs(xd).max() < 1e-8
    # Should need only a couple of sweeps (contraction ~ inner_tol per sweep).
    assert res.refinements <= 4


def test_refinement_on_dia_operator():
    sys_ = assemble_heat_system(box_mesh(15, 15, 15, elem_type="TETRA4"))
    res = iterative_refinement_solve(sys_.A, sys_.b, tol=1e-10)
    assert res.converged and res.relres < 1e-10


def test_refinement_warm_start(data_dir):
    sys_ = assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))
    res1 = iterative_refinement_solve(sys_.A, sys_.b, tol=1e-10)
    # Warm start from the solution: zero additional refinements needed.
    res2 = iterative_refinement_solve(sys_.A, sys_.b, x0=res1.x, tol=1e-9)
    assert res2.refinements == 0 and res2.converged


@pytest.mark.parametrize("prestaged", [False, True])
def test_refinement_device_residual_path(prestaged):
    """The fused on-device f64-residual loop engages for stencil operators
    (f32-exact Laplacian data) and matches the host path's accuracy, with
    the RHS uploaded by the solver or pre-staged on the device."""
    import jax.numpy as jnp

    from domain_decomposed_pde_solver.ops import choose_operator
    from domain_decomposed_pde_solver.solvers.precond.amg import (
        infer_free_grid,
    )

    mesh = box_mesh(14, 14, 14, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sys_.free_to_node)
    A = choose_operator(sys_.A, dtype=jnp.float32, grid_dims=dims)
    assert type(A).__name__ == "StencilOperator"
    b_dev = A.put_vector(sys_.b, dtype=np.float64) if prestaged else None
    res = iterative_refinement_solve(
        sys_.A, sys_.b, operator=A, tol=1e-11, b_device=b_dev
    )
    assert res.converged and res.relres < 1e-11
    res_host = iterative_refinement_solve(
        sys_.A, sys_.b, operator=A, tol=1e-11, device_residual=False
    )
    import scipy.sparse as sp

    S = sp.csr_matrix(
        (sys_.A.data, sys_.A.indices, sys_.A.indptr), shape=sys_.A.shape
    )
    for r in (res, res_host):
        assert (
            np.linalg.norm(S @ r.x - sys_.b) / np.linalg.norm(sys_.b) < 1e-11
        )


def test_refinement_over_unstructured_operator(data_dir):
    """f64-accurate answers (1e-10) with the unstructured f32 operator that
    ``choose_operator`` picks as the inner solver's matvec."""
    import jax.numpy as jnp
    import numpy as np

    from domain_decomposed_pde_solver.io import read_exodus
    from domain_decomposed_pde_solver.models import assemble_heat_system
    from domain_decomposed_pde_solver.ops import choose_operator
    from domain_decomposed_pde_solver.solvers import iterative_refinement_solve

    mesh = read_exodus(str(data_dir / "brick.exo"))
    sy = assemble_heat_system(mesh)
    B = choose_operator(sy.A, dtype=jnp.float32)
    assert type(B).__name__ in ("SplitELLMatrix", "ELLMatrix")
    res = iterative_refinement_solve(
        sy.A, sy.b, operator=B, tol=1e-10, inner_tol=1e-5
    )
    assert res.converged
    assert res.relres < 1e-10
    import scipy.sparse as sp

    S = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr), shape=sy.A.shape)
    assert (
        np.linalg.norm(S @ res.x - sy.b) / np.linalg.norm(sy.b) < 1e-9
    )


def test_f32_exact_gate_memoized():
    """The device_residual='auto' exactness scan is O(nnz) (1 GB of CSR
    data at 10M DOF) and sits on the per-call path — it must run once per
    matrix object and be correct both ways."""
    from domain_decomposed_pde_solver.solvers.mixed import _f32_exact

    sys_ = assemble_heat_system(box_mesh(8, 8, 8, elem_type="TETRA4"))
    A = sys_.A
    assert not hasattr(A, "_f32_exact_cache")
    assert _f32_exact(A) is True  # graph Laplacian: small integers
    assert A._f32_exact_cache is True
    # Memo hit: mutating the data no longer changes the answer (the cache
    # is per-object; callers that edit data in place build a new matrix).
    A.data[0] = np.float64(1) + np.float64(2) ** -40
    assert _f32_exact(A) is True
    # A fresh object with non-representable data reports False.
    from domain_decomposed_pde_solver.ops.csr import CSRMatrix

    B = CSRMatrix(
        indptr=A.indptr, indices=A.indices, data=A.data.copy(), shape=A.shape
    )
    assert _f32_exact(B) is False


def test_adaptive_inner_tol_schedule():
    """The final sweep's inner tolerance widens to the remaining gap (a
    full-depth inner solve would overshoot the target by orders of
    magnitude); early sweeps keep the configured inner_tol; the result is
    clamped to a solver-meaningful range."""
    from domain_decomposed_pde_solver.solvers.mixed import (
        _adaptive_inner_tol,
    )

    # First sweep (relres = 1): gap is tiny, keep inner_tol.
    assert _adaptive_inner_tol(1e-6, 1e-8, 1.0) == 1e-6
    # Near the target: only one decade left -> widen to ~0.25 * 10^-1.
    assert _adaptive_inner_tol(1e-6, 1e-8, 1e-7) == pytest.approx(0.025)
    # A hair above the target: a shallow inner solve suffices.
    assert _adaptive_inner_tol(1e-6, 1e-8, 2e-8) == pytest.approx(0.125)
    # Already converged input degenerates safely.
    assert _adaptive_inner_tol(1e-6, 1e-8, 0.0) == 0.5


def test_refinement_adaptive_tol_saves_inner_iterations():
    """Adaptive inner tolerance converges to the same target with fewer
    total inner iterations than it would overshoot to — the achieved
    relres should land near (below) tol rather than orders below it."""
    mesh = box_mesh(10, 10, 10, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    res = iterative_refinement_solve(sys_.A, sys_.b, tol=1e-8, inner_tol=1e-6)
    assert res.converged and res.relres < 1e-8
    import scipy.sparse as sp

    S = sp.csr_matrix(
        (sys_.A.data, sys_.A.indices, sys_.A.indptr), shape=sys_.A.shape
    )
    assert np.linalg.norm(S @ res.x - sys_.b) / np.linalg.norm(sys_.b) < 1e-7

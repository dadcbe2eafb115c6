"""Lattice-stencil operator: exact decomposition + pattern-broadcast SpMV.

Locks in the defining guarantees: (a) the decomposition verifier accepts
only matrices it can represent EXACTLY (per-entry check against the DIA
data), (b) the matvec matches DIA/CSR to f32 rounding on both stencil
periods (HEX8 period-1, 5-tet period-2), (c) the operator drops into the
solver/preconditioner stack unchanged.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from domain_decomposed_pde_solver.io.boxmesh import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import choose_operator, dia_from_csr
from domain_decomposed_pde_solver.ops.stencil import (
    StencilOperator,
    stencil_from_dia,
)
from domain_decomposed_pde_solver.solvers.precond.amg import infer_free_grid


def _case(elem_type, n):
    mesh = box_mesh(*n, elem_type=elem_type)
    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    assert dims is not None
    return sy, dims


@pytest.mark.parametrize(
    "elem_type,n,period",
    [("TETRA4", (14, 12, 13), 2), ("HEX8", (13, 11, 12), 1)],
)
def test_stencil_matvec_matches_dia(elem_type, n, period):
    sy, dims = _case(elem_type, n)
    A = dia_from_csr(sy.A, dtype=jnp.float32)
    S = stencil_from_dia(A, dims)
    assert S is not None and S.period == period
    x = np.random.default_rng(0).standard_normal(sy.n_free).astype(np.float32)
    xp = S.put_vector(x)
    y_dia = np.asarray(A.matvec(xp[: A.n_pad]))[: sy.n_free]
    y_st = np.asarray(S.matvec(xp))[: sy.n_free]
    np.testing.assert_allclose(y_st, y_dia, rtol=3e-6, atol=3e-5)


def test_stencil_diagonal_matches_dia():
    sy, dims = _case("TETRA4", (12, 13, 12))
    A = dia_from_csr(sy.A, dtype=jnp.float32)
    S = stencil_from_dia(A, dims)
    np.testing.assert_array_equal(
        np.asarray(S.diagonal_padded())[: sy.n_free],
        np.asarray(A.diagonal_padded())[: sy.n_free],
    )


def test_choose_operator_selects_stencil_with_dims():
    sy, dims = _case("TETRA4", (12, 12, 12))
    A = choose_operator(sy.A, dtype=jnp.float32, grid_dims=dims)
    assert isinstance(A, StencilOperator)
    # Without dims it stays DIA; with wrong dims it must reject.
    from domain_decomposed_pde_solver.ops.dia import DIAMatrix

    assert isinstance(choose_operator(sy.A, dtype=jnp.float32), DIAMatrix)
    assert not isinstance(
        choose_operator(sy.A, dtype=jnp.float32, grid_dims=(7, 9, 100)),
        StencilOperator,
    )


def test_verifier_rejects_perturbed_matrix():
    """One off-pattern off-diagonal entry must make the decomposition
    refuse (never a silently-wrong operator)."""
    sy, dims = _case("TETRA4", (10, 10, 10))
    A = dia_from_csr(sy.A, dtype=jnp.float32)
    data = np.array(A.data.astype(jnp.float32))
    d_off = next(d for d, o in enumerate(A.offsets) if o != 0)
    i_mid = int(np.nonzero(data[d_off, : sy.n_free])[0][sy.n_free // 4])
    data[d_off, i_mid] *= 2.0
    import dataclasses

    A2 = dataclasses.replace(A, data=jnp.asarray(data), compute_dtype="")
    assert stencil_from_dia(A2, dims) is None


def test_stencil_in_cg_with_jacobi():
    from domain_decomposed_pde_solver.solvers import (
        cg_solve,
        jacobi_preconditioner,
    )

    sy, dims = _case("TETRA4", (11, 12, 13))
    S = choose_operator(sy.A, dtype=jnp.float32, grid_dims=dims)
    assert isinstance(S, StencilOperator)
    b = S.put_vector((sy.b / np.abs(sy.b).max()).astype(np.float32))
    res = cg_solve(S, b, jnp.zeros_like(b), precond=jacobi_preconditioner(S),
                   tol=1e-6, maxiter=500)
    assert bool(res.converged)
    import scipy.sparse as sp

    x = S.get_vector(res.x).astype(np.float64)
    M = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr), shape=sy.A.shape)
    bb = sy.b / np.abs(sy.b).max()
    assert np.linalg.norm(M @ x - bb) / np.linalg.norm(bb) < 1e-5


def test_amg_setup_uses_stencil_fine_level():
    from domain_decomposed_pde_solver.solvers import cg_solve
    from domain_decomposed_pde_solver.solvers.precond.amg import (
        smoothed_aggregation_setup,
    )

    sy, dims = _case("TETRA4", (13, 13, 13))
    M = smoothed_aggregation_setup(sy.A, dtype=jnp.float32, grid_dims=dims)
    assert isinstance(M.levels[0].A, StencilOperator)
    A = choose_operator(sy.A, dtype=jnp.float32, grid_dims=dims)
    b = A.put_vector((sy.b / np.abs(sy.b).max()).astype(np.float32))
    res = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-6, maxiter=60)
    assert bool(res.converged)
    assert int(res.iterations) <= 20

"""DIA (stencil) format tests — the gather-free SpMV path."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import box_mesh, read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import (
    DIAMatrix,
    ELLMatrix,
    choose_operator,
    dia_from_csr,
    operator_bytes,
    pad_vector,
    unpad_vector,
)
from domain_decomposed_pde_solver.solvers import cg_solve
from domain_decomposed_pde_solver.solvers.precond.jacobi import (
    DiagonalPreconditioner,
)


@pytest.mark.parametrize("et", ["TETRA4", "HEX8"])
def test_dia_matvec_matches_csr(et):
    mesh = box_mesh(8, 7, 6, elem_type=et)
    sys_ = assemble_heat_system(mesh)
    A = dia_from_csr(sys_.A, dtype=jnp.float64)
    assert A is not None and A.ndiags <= 32
    x = np.random.default_rng(0).standard_normal(sys_.A.n_rows)
    y = unpad_vector(A.matvec(pad_vector(x, A.n_pad)), sys_.A.n_rows)
    np.testing.assert_allclose(y, sys_.A.matvec(x), rtol=1e-12, atol=1e-12)
    # Padded tail must stay exactly zero.
    full = np.asarray(A.matvec(pad_vector(x, A.n_pad)))
    np.testing.assert_array_equal(full[sys_.A.n_rows :], 0.0)


def test_dia_diagonal_padded():
    mesh = box_mesh(5, 5, 5, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    A = dia_from_csr(sys_.A, dtype=jnp.float64)
    d = np.asarray(A.diagonal_padded(fill=1.0))
    np.testing.assert_allclose(d[: sys_.n_free], sys_.degree)
    np.testing.assert_array_equal(d[sys_.n_free :], 1.0)


def test_choose_operator_selects_by_structure(data_dir):
    from domain_decomposed_pde_solver.ops import SplitELLMatrix

    box = assemble_heat_system(box_mesh(10, 10, 10, elem_type="TETRA4"))
    assert isinstance(choose_operator(box.A), DIAMatrix)
    unstructured = assemble_heat_system(
        read_exodus(str(data_dir / "tet-cube-heat.exo"))
    )
    # Tet meshes have high row-width variance -> the width-capped Split-ELL
    # wins the op-count model over plain ELL.
    assert isinstance(
        choose_operator(unstructured.A), (ELLMatrix, SplitELLMatrix)
    )


def test_dia_refuses_unstructured(data_dir):
    sys_ = assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))
    assert dia_from_csr(sys_.A, max_diags=64) is None


def test_cg_on_dia_operator():
    mesh = box_mesh(10, 10, 10, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    A = dia_from_csr(sys_.A, dtype=jnp.float64)
    b = pad_vector(sys_.b, A.n_pad)
    M = DiagonalPreconditioner(1.0 / A.diagonal_padded())
    res = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-12, maxiter=2000)
    assert bool(res.converged)
    import scipy.sparse.linalg as spla

    xd = spla.spsolve(sys_.A.to_scipy().tocsc(), sys_.b)
    x = unpad_vector(res.x, sys_.n_free)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-9


def test_operator_bytes_sane():
    mesh = box_mesh(6, 6, 6, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    dia = dia_from_csr(sys_.A, dtype=jnp.float32)
    from domain_decomposed_pde_solver.ops import ell_from_csr

    ell = ell_from_csr(sys_.A, dtype=jnp.float32)
    # DIA payload must be smaller than ELL's (no index storage).
    assert operator_bytes(dia) < operator_bytes(ell)


def test_dia_matvec_roll_matches_windowed():
    mesh = box_mesh(7, 6, 5, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    A = dia_from_csr(sys_.A, dtype=jnp.float64)
    x = pad_vector(
        np.random.default_rng(3).standard_normal(A.n_pad), A.n_pad
    )
    np.testing.assert_allclose(
        np.asarray(A.matvec_roll(x)), np.asarray(A.matvec(x)),
        rtol=1e-14, atol=1e-12,
    )


def test_dia_bf16_storage_is_bit_exact():
    """Graph-Laplacian entries (integer degrees, -1s) round-trip bfloat16
    exactly, so auto narrow storage must not change the matvec at all."""
    mesh = box_mesh(9, 8, 7, elem_type="HEX8")
    sys_ = assemble_heat_system(mesh)
    A = dia_from_csr(sys_.A, dtype=jnp.float32)  # storage="auto" default
    assert A.data.dtype == jnp.bfloat16
    assert A.dtype == jnp.float32  # compute/vector dtype unchanged
    full = dia_from_csr(sys_.A, dtype=jnp.float32, storage="full")
    assert full.data.dtype == jnp.float32
    x = pad_vector(
        np.random.default_rng(1).standard_normal(A.n_pad).astype(np.float32),
        A.n_pad,
    )
    np.testing.assert_array_equal(
        np.asarray(A.matvec(x)), np.asarray(full.matvec(x))
    )
    # Jacobi diagonal also comes back in compute precision.
    assert A.diagonal_padded().dtype == jnp.float32
    np.testing.assert_array_equal(
        np.asarray(A.diagonal_padded()), np.asarray(full.diagonal_padded())
    )
    # Narrow storage must be reflected in the traffic model.
    assert operator_bytes(A) < operator_bytes(full)


def test_dia_bf16_rejected_for_inexact_entries():
    mesh = box_mesh(6, 6, 6, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    csr = sys_.A
    csr.data = csr.data * 1.0000001  # not bf16-representable
    A = dia_from_csr(csr, dtype=jnp.float32)
    assert A.data.dtype == jnp.float32

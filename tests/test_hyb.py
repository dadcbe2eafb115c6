"""Hybrid DIA+ELL format and RCM permutation tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import pad_vector, unpad_vector
from domain_decomposed_pde_solver.ops.hyb import hyb_from_csr, rcm_permute
from domain_decomposed_pde_solver.solvers import cg_solve
from domain_decomposed_pde_solver.solvers.precond.jacobi import (
    DiagonalPreconditioner,
)


@pytest.fixture(scope="module")
def system(data_dir):
    return assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))


def test_rcm_permute_preserves_operator(system):
    Ap, perm = rcm_permute(system.A)
    if perm is None:
        pytest.skip("native library unavailable")
    x = np.random.default_rng(0).standard_normal(system.A.n_rows)
    np.testing.assert_allclose(
        Ap.matvec(x[perm]), system.A.matvec(x)[perm], rtol=1e-12
    )


def test_hyb_matvec_matches_csr(system):
    Ap, perm = rcm_permute(system.A)
    H = hyb_from_csr(Ap, dtype=jnp.float64, min_occupancy=0.02)
    x = np.random.default_rng(1).standard_normal(Ap.n_rows)
    y = unpad_vector(H.matvec(pad_vector(x, H.n_pad)), Ap.n_rows)
    np.testing.assert_allclose(y, Ap.matvec(x), rtol=1e-12, atol=1e-10)
    # Split must be complete: dia nnz + ell nnz == csr nnz.
    dia_nnz = int((np.asarray(H.dia.data) != 0).sum())
    ell_nnz = int((np.asarray(H.ell.vals) != 0).sum())
    assert dia_nnz + ell_nnz == Ap.nnz


def test_hyb_diagonal(system):
    Ap, perm = rcm_permute(system.A)
    H = hyb_from_csr(Ap, dtype=jnp.float64, min_occupancy=0.02)
    d = unpad_vector(H.diagonal_padded(), Ap.n_rows)
    np.testing.assert_allclose(d, Ap.diagonal())


def test_cg_on_hyb_with_permutation_roundtrip(system):
    """Full pipeline: permute, solve on HYB, un-permute; must match the
    unpermuted dense solve."""
    Ap, perm = rcm_permute(system.A)
    if perm is None:
        pytest.skip("native library unavailable")
    H = hyb_from_csr(Ap, dtype=jnp.float64, min_occupancy=0.02)
    b_perm = system.b[perm]
    b = pad_vector(b_perm, H.n_pad)
    M = DiagonalPreconditioner(1.0 / H.diagonal_padded())
    res = cg_solve(H, b, jnp.zeros_like(b), precond=M, tol=1e-12, maxiter=2000)
    assert bool(res.converged)
    x_perm = unpad_vector(res.x, Ap.n_rows)
    x = np.zeros_like(x_perm)
    x[perm] = x_perm  # invert: perm[new] = old
    xd = np.linalg.solve(system.A.to_dense(), system.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-8

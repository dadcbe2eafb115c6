"""Split-ELL format tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import coo_to_csr, pad_vector, unpad_vector
from domain_decomposed_pde_solver.ops.splitell import splitell_from_csr
from domain_decomposed_pde_solver.solvers import cg_solve
from domain_decomposed_pde_solver.solvers.precond.jacobi import (
    DiagonalPreconditioner,
)


@pytest.fixture(scope="module")
def system(data_dir):
    return assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))


def test_splitell_matvec_matches_csr(system):
    A = splitell_from_csr(system.A, dtype=jnp.float64)
    assert A.row_width < system.A.max_row_nnz  # the cap actually capped
    x = np.random.default_rng(0).standard_normal(system.A.n_rows)
    y = unpad_vector(A.matvec(pad_vector(x, A.n_pad)), system.A.n_rows)
    np.testing.assert_allclose(y, system.A.matvec(x), rtol=1e-12, atol=1e-10)


def test_splitell_total_ops_reduced(system):
    from domain_decomposed_pde_solver.ops import ell_from_csr

    ell = ell_from_csr(system.A, dtype=jnp.float32)
    spl = splitell_from_csr(system.A, dtype=jnp.float32)
    ops_ell = ell.n_pad * ell.row_width
    ops_spl = spl.n_pad * spl.row_width + 2 * int(spl.tail_rows.shape[0])
    assert ops_spl < ops_ell


def test_splitell_diagonal(system):
    A = splitell_from_csr(system.A, dtype=jnp.float64)
    d = unpad_vector(A.diagonal_padded(), system.A.n_rows)
    np.testing.assert_allclose(d, system.degree)


def test_splitell_uniform_rows_no_tail():
    """A matrix with uniform row widths needs no tail at all."""
    n = 32
    rows = np.repeat(np.arange(n), 3)
    cols = (rows + np.tile([0, 1, 2], n)) % n
    csr = coo_to_csr(rows, cols, np.ones(rows.size), (n, n), sum_dups=False)
    A = splitell_from_csr(csr, dtype=jnp.float64)
    assert A.row_width == 3
    assert np.all(np.asarray(A.tail_vals) == 0)


def test_cg_on_splitell(system):
    A = splitell_from_csr(system.A, dtype=jnp.float64)
    b = pad_vector(system.b, A.n_pad)
    M = DiagonalPreconditioner(1.0 / A.diagonal_padded())
    res = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-12, maxiter=2000)
    assert bool(res.converged)
    xd = np.linalg.solve(system.A.to_dense(), system.b)
    x = unpad_vector(res.x, system.A.n_rows)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-8

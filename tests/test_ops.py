"""CSR/ELL format and SpMV kernel tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import (
    CSRMatrix,
    coo_to_csr,
    ell_from_csr,
    ell_spmv,
    pad_vector,
    unpad_vector,
)


def random_csr(rng, n, m, density=0.1):
    mask = rng.random((n, m)) < density
    dense = np.where(mask, rng.standard_normal((n, m)), 0.0)
    rows, cols = np.nonzero(dense)
    return coo_to_csr(rows, cols, dense[rows, cols], (n, m)), dense


def test_coo_to_csr_sums_duplicates():
    rows = np.array([0, 0, 1, 0])
    cols = np.array([1, 1, 0, 2])
    vals = np.array([1.0, 2.0, 5.0, 4.0])
    csr = coo_to_csr(rows, cols, vals, (2, 3))
    np.testing.assert_allclose(
        csr.to_dense(), [[0.0, 3.0, 4.0], [5.0, 0.0, 0.0]]
    )


def test_csr_roundtrip_and_ops():
    rng = np.random.default_rng(0)
    csr, dense = random_csr(rng, 37, 41)
    np.testing.assert_allclose(csr.to_dense(), dense)
    x = rng.standard_normal(41)
    np.testing.assert_allclose(csr.matvec(x), dense @ x, rtol=1e-12)
    np.testing.assert_allclose(csr.transpose().to_dense(), dense.T)
    sub = csr.select_rows(np.array([3, 1, 30]))
    np.testing.assert_allclose(sub.to_dense(), dense[[3, 1, 30]])


def test_csr_diagonal():
    rng = np.random.default_rng(1)
    csr, dense = random_csr(rng, 29, 29, density=0.3)
    np.testing.assert_allclose(csr.diagonal(), np.diag(dense))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_ell_spmv_matches_csr(dtype):
    rng = np.random.default_rng(2)
    csr, dense = random_csr(rng, 50, 50, density=0.15)
    A = ell_from_csr(csr, dtype=dtype)
    assert A.n_pad % 8 == 0
    x = rng.standard_normal(50)
    xp = pad_vector(x.astype(np.dtype(dtype)), A.n_pad)
    y = unpad_vector(ell_spmv(A, xp), 50)
    rtol = 1e-5 if dtype == jnp.float32 else 1e-12
    np.testing.assert_allclose(y, dense @ x, rtol=rtol, atol=1e-5 if dtype == jnp.float32 else 1e-12)
    # Padded region must stay exactly zero.
    np.testing.assert_array_equal(np.asarray(ell_spmv(A, xp))[50:], 0.0)


def test_ell_diagonal_padded(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    A = ell_from_csr(sys_.A, dtype=jnp.float64)
    d = np.asarray(A.diagonal_padded(fill=1.0))
    np.testing.assert_allclose(d[: sys_.n_free], sys_.degree)
    np.testing.assert_array_equal(d[sys_.n_free :], 1.0)

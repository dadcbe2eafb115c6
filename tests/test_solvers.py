"""Krylov solver + preconditioner + power-method tests (golden vs dense)."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import (
    assemble_full_laplacian,
    assemble_heat_system,
)
from domain_decomposed_pde_solver.ops import ell_from_csr, ell_spmv, pad_vector, unpad_vector
from domain_decomposed_pde_solver.solvers import (
    cg_solve,
    cg_solve_snapshots,
    chebyshev_preconditioner,
    estimate_lmax_dinv_a,
    gmres_solve,
    jacobi_preconditioner,
    power_method,
)


def setup_system(data_dir, name, dtype=jnp.float64):
    mesh = read_exodus(str(data_dir / name))
    sys_ = assemble_heat_system(mesh)
    A = ell_from_csr(sys_.A, dtype=dtype)
    b = pad_vector(sys_.b.astype(np.dtype(dtype)), A.n_pad)
    return mesh, sys_, A, b


@pytest.mark.parametrize("name", ["rectangle-tris-boundary.exo", "brick.exo"])
def test_cg_matches_dense_solve(data_dir, name):
    _, sys_, A, b = setup_system(data_dir, name)
    res = cg_solve(A, b, jnp.zeros_like(b), precond=jacobi_preconditioner(A),
                   tol=1e-13, maxiter=2000)
    assert bool(res.converged)
    x = unpad_vector(res.x, sys_.n_free)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    rel = np.abs(x - xd).max() / max(np.abs(xd).max(), 1e-30)
    assert rel < 1e-8


@pytest.mark.parametrize("name", ["rectangle-tris-boundary.exo", "brick.exo"])
def test_gmres_matches_dense_solve(data_dir, name):
    _, sys_, A, b = setup_system(data_dir, name)
    res = gmres_solve(A, b, jnp.zeros_like(b), precond=jacobi_preconditioner(A),
                      restart=40, tol=1e-13, maxiter=3000)
    assert bool(res.converged)
    x = unpad_vector(res.x, sys_.n_free)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    rel = np.abs(x - xd).max() / max(np.abs(xd).max(), 1e-30)
    assert rel < 1e-8


def test_gmres_nonsymmetric():
    rng = np.random.default_rng(3)
    n = 40
    dense = np.eye(n) * 10 + rng.standard_normal((n, n)) * 0.5  # nonsymmetric
    from domain_decomposed_pde_solver.ops import coo_to_csr

    rows, cols = np.nonzero(dense)
    csr = coo_to_csr(rows, cols, dense[rows, cols], (n, n))
    A = ell_from_csr(csr, dtype=jnp.float64)
    b_np = rng.standard_normal(n)
    b = pad_vector(b_np, A.n_pad)
    res = gmres_solve(A, b, jnp.zeros_like(b),
                      restart=20, tol=1e-12, maxiter=500)
    assert bool(res.converged)
    np.testing.assert_allclose(
        unpad_vector(res.x, n), np.linalg.solve(dense, b_np), rtol=1e-8, atol=1e-8
    )


def test_cg_snapshots_converges_and_calls_back(data_dir):
    _, sys_, A, b = setup_system(data_dir, "rectangle-tris-boundary.exo")
    seen = []
    res = cg_solve_snapshots(
        A, b, jnp.zeros_like(b), precond=jacobi_preconditioner(A),
        tol=1e-13, maxiter=300, callback=lambda k, x, rr: seen.append((k, rr)),
    )
    assert bool(res.converged)
    assert len(seen) == int(res.iterations)
    # Residuals reported must be monotone-ish decreasing overall.
    assert seen[-1][1] < seen[0][1]


def test_chebyshev_preconditioner_accelerates(data_dir):
    _, sys_, A, b = setup_system(data_dir, "brick.exo")
    lmax = estimate_lmax_dinv_a(A, iters=30)
    cheb = chebyshev_preconditioner(A, lmax, degree=4)
    res_j = cg_solve(A, b, jnp.zeros_like(b), precond=jacobi_preconditioner(A),
                     tol=1e-10, maxiter=2000)
    res_c = cg_solve(A, b, jnp.zeros_like(b), precond=cheb, tol=1e-10, maxiter=2000)
    assert bool(res_c.converged)
    assert int(res_c.iterations) < int(res_j.iterations)
    x = unpad_vector(res_c.x, sys_.n_free)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-7


def test_power_method_matches_numpy_eig(data_dir):
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    L = assemble_full_laplacian(mesh)
    A = ell_from_csr(L, dtype=jnp.float64)
    z0 = pad_vector(np.random.default_rng(0).uniform(size=L.n_rows), A.n_pad)
    res = power_method(A, z0, maxiter=5000, tol=1e-8,
                       check_every=10)
    lam_true = np.linalg.eigvalsh(L.to_dense()).max()
    # Symmetric operator: the Rayleigh quotient is within the residual norm
    # of a true eigenvalue (Bauer-Fike), and must have locked onto lam_max.
    assert abs(float(res.eigenvalue) - lam_true) <= max(float(res.residual), 1e-8)
    assert abs(float(res.eigenvalue) - lam_true) / lam_true < 1e-3


def test_bicgstab_spd_and_nonsymmetric(data_dir):
    from domain_decomposed_pde_solver.solvers import bicgstab_solve

    _, sys_, A, b = setup_system(data_dir, "brick.exo")
    res = bicgstab_solve(A, b, jnp.zeros_like(b),
                         precond=jacobi_preconditioner(A), tol=1e-11,
                         maxiter=2000)
    assert bool(res.converged)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    x = unpad_vector(res.x, sys_.n_free)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-8

    rng = np.random.default_rng(3)
    n = 60
    dense = np.eye(n) * 10 + rng.standard_normal((n, n)) * 0.5
    from domain_decomposed_pde_solver.ops import coo_to_csr

    rows, cols = np.nonzero(dense)
    csr = coo_to_csr(rows, cols, dense[rows, cols], (n, n))
    An = ell_from_csr(csr, dtype=jnp.float64)
    bn = pad_vector(rng.standard_normal(n), An.n_pad)
    rn = bicgstab_solve(An, bn, jnp.zeros_like(bn), tol=1e-12, maxiter=500)
    assert bool(rn.converged)
    np.testing.assert_allclose(
        unpad_vector(rn.x, n),
        np.linalg.solve(dense, np.asarray(bn)[:n]),
        rtol=1e-8, atol=1e-10,
    )


def test_cg_terminates_on_breakdown():
    """A singular system with incompatible RHS must terminate (not hang):
    NaN residuals make the while_loop condition false — the framework's
    failure-detection behavior (converged=False, finite iteration count)."""
    from domain_decomposed_pde_solver.ops import coo_to_csr

    # Singular: the zero matrix.
    n = 16
    csr = coo_to_csr(np.arange(n), np.arange(n), np.zeros(n), (n, n))
    A = ell_from_csr(csr, dtype=jnp.float64)
    b = pad_vector(np.ones(n), A.n_pad)
    res = cg_solve(A, b, jnp.zeros_like(b), tol=1e-12, maxiter=50)
    assert not bool(res.converged)
    assert int(res.iterations) <= 50


def test_lanczos_spectrum_extremes(data_dir):
    """Lanczos must recover both spectrum edges to high accuracy (vs the
    power method, which only sees lambda_max and converges slowly)."""
    from domain_decomposed_pde_solver.solvers.lanczos import lanczos_extremes

    _, sys_, A, _ = setup_system(data_dir, "brick.exo")
    rng = np.random.default_rng(0)
    z0 = np.zeros(A.n_pad)
    z0[: sys_.n_free] = rng.standard_normal(sys_.n_free)
    res = lanczos_extremes(A, jnp.asarray(z0), k=60)
    ev = np.linalg.eigvalsh(sys_.A.to_dense())
    assert abs(float(res.lmax) - ev[-1]) / ev[-1] < 1e-6
    assert abs(float(res.lmin) - ev[0]) / ev[0] < 0.05
    assert abs(float(res.condition) - ev[-1] / ev[0]) / (ev[-1] / ev[0]) < 0.05

"""ILU(0) factorization + level-scheduled device apply.

Parity component for the reference's Ifpack2 ILUT production preconditioner
(``BelosMueLuSolver.cpp:92-106``).  Checks the defining ILU(0) property
((LU)_ij == A_ij on the sparsity pattern), exactness of the device
triangular sweeps against dense solves, and solver acceleration.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from domain_decomposed_pde_solver.ops.csr import CSRMatrix
from domain_decomposed_pde_solver.ops.ell import pad_to, pad_vector
from domain_decomposed_pde_solver.solvers.precond.ilu import (
    ilu0_factor,
    ilu0_preconditioner,
)


def _laplacian(n, deg, seed):
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    keep = u != v
    u, v = u[keep], v[keep]
    M = sp.coo_matrix(
        (np.ones(2 * u.size), (np.r_[u, v], np.r_[v, u])), shape=(n, n)
    ).tocsr()
    M.data[:] = -1.0
    M.setdiag(0)
    M.eliminate_zeros()
    M.setdiag(-np.asarray(M.sum(axis=1)).ravel() + 1.0)  # SPD (shifted)
    M = M.tocsr()
    M.sort_indices()
    return M


def _to_csr(S):
    return CSRMatrix(
        indptr=S.indptr.astype(np.int64),
        indices=S.indices.astype(np.int64),
        data=S.data.astype(np.float64),
        shape=S.shape,
    )


def _lu_dense(S, lu, diag_pos):
    """Reassemble dense L (unit) and U from the in-pattern factors."""
    n = S.shape[0]
    L = np.eye(n)
    U = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(S.indptr))
    for p, (i, j) in enumerate(zip(rows, S.indices)):
        if j < i:
            L[i, j] = lu[p]
        else:
            U[i, j] = lu[p]
    return L, U


@pytest.mark.parametrize("use_native", [True, False])
def test_ilu0_pattern_property(use_native, monkeypatch):
    if not use_native:
        monkeypatch.setenv("DDPS_NO_NATIVE", "1")
        import domain_decomposed_pde_solver.utils.native as nat

        monkeypatch.setattr(nat, "_tried", False)
        monkeypatch.setattr(nat, "_lib", None)
    S = _laplacian(120, 6, 0)
    csr = _to_csr(S)
    lu, diag_pos = ilu0_factor(csr)
    L, U = _lu_dense(S, lu, diag_pos)
    P = L @ U
    A = S.toarray()
    mask = A != 0
    np.testing.assert_allclose(P[mask], A[mask], rtol=1e-12, atol=1e-12)


def test_ilu0_native_matches_fallback(monkeypatch):
    S = _laplacian(200, 8, 1)
    csr = _to_csr(S)
    lu_n, dp_n = ilu0_factor(csr)

    monkeypatch.setenv("DDPS_NO_NATIVE", "1")
    import domain_decomposed_pde_solver.utils.native as nat

    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.setattr(nat, "_lib", None)
    lu_p, dp_p = ilu0_factor(csr)
    np.testing.assert_allclose(lu_n, lu_p, rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(dp_n, dp_p)


def test_ilu0_apply_is_exact_triangular_solve():
    """M(r) must equal U^-1 L^-1 r exactly (up to f32)."""
    S = _laplacian(300, 7, 2)
    csr = _to_csr(S)
    lu, diag_pos = ilu0_factor(csr)
    L, U = _lu_dense(S, lu, diag_pos)
    n_pad = pad_to(300)
    M = ilu0_preconditioner(csr, n_pad=n_pad)
    r = np.random.default_rng(3).standard_normal(300)
    want = np.linalg.solve(U, np.linalg.solve(L, r))
    got = np.asarray(M(pad_vector(r.astype(np.float32), n_pad)))[:300]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_ilu0_tridiagonal_exact_inverse():
    """For a tridiagonal SPD matrix ILU(0) == full LU, so one apply solves
    the system exactly."""
    n = 64
    S = sp.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    S.sort_indices()
    csr = _to_csr(S)
    M = ilu0_preconditioner(csr, n_pad=pad_to(n))
    rng = np.random.default_rng(4)
    x_true = rng.standard_normal(n)
    b = S @ x_true
    got = np.asarray(M(pad_vector(b.astype(np.float32), pad_to(n))))[:n]
    np.testing.assert_allclose(got, x_true, rtol=2e-4, atol=2e-4)


def test_ilu0_accelerates_gmres():
    from domain_decomposed_pde_solver.ops.ell import ell_from_csr
    from domain_decomposed_pde_solver.solvers import gmres_solve

    # Ill-conditioned: near-singular Laplacian (tiny shift), like the
    # reduced heat system with few boundary nodes.
    S = _laplacian(500, 8, 5) - 0.995 * sp.eye(500)
    S = S.tocsr()
    S.sort_indices()
    csr = _to_csr(S)
    A = ell_from_csr(csr)
    b = pad_vector(
        np.random.default_rng(6).standard_normal(500).astype(np.float32), A.n_pad
    )
    import jax.numpy as jnp

    x0 = jnp.zeros_like(b)
    res_plain = gmres_solve(A, b, x0, restart=30, tol=1e-6, maxiter=400)
    M = ilu0_preconditioner(csr, n_pad=A.n_pad)
    res_ilu = gmres_solve(A, b, x0, precond=M, restart=30, tol=1e-6, maxiter=400)
    assert bool(res_ilu.converged)
    assert int(res_ilu.iterations) < int(res_plain.iterations)


def test_ilu0_zero_pivot_raises():
    # Explicit zero on the diagonal (stored): structurally present, zero value.
    csr = CSRMatrix(
        indptr=np.array([0, 2, 4], np.int64),
        indices=np.array([0, 1, 0, 1], np.int64),
        data=np.array([0.0, 1.0, 1.0, 1.0]),
        shape=(2, 2),
    )
    with pytest.raises(ZeroDivisionError):
        ilu0_factor(csr)


# ---------------------------------------------------------------------------
# ILUT (threshold incomplete LU — the literal Ifpack2-ILUT analogue)
# ---------------------------------------------------------------------------


def test_ilut_native_matches_fallback(monkeypatch):
    """Native and NumPy ILUT agree exactly when no top-p tie-breaking is
    involved (high fill keeps everything); at capped fill both must still
    produce same-sized factors and equal diagonals (the top-p selection may
    break |value| ties differently — both are valid ILUTs)."""
    from domain_decomposed_pde_solver.solvers.precond.ilu import _ilut_factor

    S = _laplacian(150, 6, 11)
    csr = _to_csr(S)
    nat_full = _ilut_factor(csr, 50.0, 0.0)
    nat_cap = _ilut_factor(csr, 1.0, 0.0)

    monkeypatch.setenv("DDPS_NO_NATIVE", "1")
    import domain_decomposed_pde_solver.utils.native as natmod

    monkeypatch.setattr(natmod, "_tried", False)
    monkeypatch.setattr(natmod, "_lib", None)
    py_full = _ilut_factor(csr, 50.0, 0.0)
    for a, b in zip(nat_full, py_full):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    py_cap = _ilut_factor(csr, 1.0, 0.0)
    # Capped fill: tie-breaking changes which entries (and hence which
    # downstream fill-ins) survive, so factors differ — but both must
    # respect the per-row cap and keep nonzero diagonals.
    caps = np.maximum(1, np.ceil(1.0 * np.diff(csr.indptr)))
    for fac in (nat_cap, py_cap):
        assert np.all(np.diff(fac[0]) <= caps)
        assert np.all(np.diff(fac[3]) <= caps)
        assert np.all(fac[6] != 0)


def test_ilut_high_fill_is_exact_lu():
    """With unlimited fill and no dropping, ILUT == complete LU: one apply
    solves the system exactly."""
    from domain_decomposed_pde_solver.solvers.precond.ilu import (
        ilut_preconditioner,
    )

    S = _laplacian(80, 6, 12)
    csr = _to_csr(S)
    M = ilut_preconditioner(csr, fill_factor=100.0, droptol=0.0)
    rng = np.random.default_rng(13)
    x_true = rng.standard_normal(80)
    b = S @ x_true
    got = np.asarray(M(pad_vector(b.astype(np.float32), pad_to(80))))[:80]
    np.testing.assert_allclose(got, x_true, rtol=5e-4, atol=5e-4)


def test_ilut_default_beats_jacobi_in_gmres():
    """GMRES + ILUT(1.0, 0) — the reference's production configuration —
    needs far fewer iterations than Jacobi on an ill-conditioned system."""
    import jax.numpy as jnp

    from domain_decomposed_pde_solver.ops.ell import ell_from_csr
    from domain_decomposed_pde_solver.solvers import gmres_solve
    from domain_decomposed_pde_solver.solvers.precond.ilu import (
        ilut_preconditioner,
    )

    S = (_laplacian(500, 8, 5) - 0.995 * sp.eye(500)).tocsr()
    S.sort_indices()
    csr = _to_csr(S)
    A = ell_from_csr(csr)
    b = pad_vector(
        np.random.default_rng(6).standard_normal(500).astype(np.float32), A.n_pad
    )
    x0 = jnp.zeros_like(b)
    r_plain = gmres_solve(A, b, x0, restart=30, tol=1e-5, maxiter=400)
    M = ilut_preconditioner(csr, n_pad=A.n_pad)
    r_ilut = gmres_solve(A, b, x0, precond=M, restart=30, tol=1e-5, maxiter=400)
    assert bool(r_ilut.converged)
    # Measured: 9 iterations vs hundreds unpreconditioned.
    assert int(r_ilut.iterations) < int(r_plain.iterations) // 2


def test_ilut_droptol_reduces_fill():
    from domain_decomposed_pde_solver.solvers.precond.ilu import _ilut_factor

    S = _laplacian(300, 8, 14)
    csr = _to_csr(S)
    full = _ilut_factor(csr, 10.0, 0.0)
    dropped = _ilut_factor(csr, 10.0, 0.2)
    assert dropped[0][-1] + dropped[3][-1] < full[0][-1] + full[3][-1]

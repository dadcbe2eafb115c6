"""Preconditioner comparison harness — the ILUT parity story.

The reference preconditions GMRES with Ifpack2 ILUT
(``BelosMueLuSolver.cpp:92-97``).  ILUT's sequential triangular solves do
not parallelize, so this framework's plan of record (SURVEY §7) is to match
*answers*, not the preconditioner — and to demonstrate that the device
preconditioners need no more (usually far fewer) Krylov iterations than the
reference's ILUT.  This harness produces that comparison: iteration counts
to a fixed tolerance for scipy's ILU (a superset of ILUT, via SuperLU),
Jacobi, Chebyshev, and SA-AMG on the same operator.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.csr import CSRMatrix

__all__ = ["compare_preconditioners"]


def _count_iters_scipy(A, b, M=None, tol=1e-10, maxiter=2000, restart=30):
    """GMRES(30) iteration count — the reference's solver
    (``BelosMueLuSolver.cpp:105-106``); works for nonsymmetric
    preconditioners like ILU where CG would break."""
    import scipy.sparse.linalg as spla

    count = {"n": 0}

    def cb(rk):
        count["n"] += 1

    x, info = spla.gmres(
        A, b, rtol=tol, maxiter=maxiter, M=M, restart=restart,
        callback=cb, callback_type="pr_norm",
    )
    return count["n"], info == 0


def compare_preconditioners(
    A: CSRMatrix, b: np.ndarray, tol: float = 1e-10, maxiter: int = 2000,
    plan=None,
) -> Dict[str, dict]:
    """Iteration counts of GMRES(30) under each preconditioner (host, f64).

    GMRES is the reference's solver (``BelosMueLuSolver.cpp:105-106``) and
    the only fair one here: ILU preconditioning is nonsymmetric, so CG
    would be invalid for that row.  Returns
    ``{name: {"iterations": k, "converged": bool}}`` for
    none / jacobi / ilut (scipy SuperLU ILU ~ Ifpack2 ILUT) / amg, plus —
    when a :class:`..parallel.halo.HaloPlan` is passed as ``plan`` — a
    ``schwarz_ilut`` row: the distributed additive-Schwarz per-part ILUT
    (:func:`..parallel.schwarzilu.build_block_ilu`), i.e. exactly what the
    reference's per-rank Ifpack2 ILUT does under ``mpirun -n P``
    (``BelosMueLuSolver.cpp:92-97``), applied through the same stacked
    factors the sharded solvers use.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    S = A.to_scipy().tocsc()
    n = A.n_rows
    out: Dict[str, dict] = {}

    k, ok = _count_iters_scipy(S, b, tol=tol, maxiter=maxiter)
    out["none"] = {"iterations": k, "converged": ok}

    d = S.diagonal()
    Mj = spla.LinearOperator((n, n), matvec=lambda v: v / d)
    k, ok = _count_iters_scipy(S, b, M=Mj, tol=tol, maxiter=maxiter)
    out["jacobi"] = {"iterations": k, "converged": ok}

    try:
        ilu = spla.spilu(S, drop_tol=1e-4, fill_factor=10)
        Mi = spla.LinearOperator((n, n), matvec=ilu.solve)
        k, ok = _count_iters_scipy(S, b, M=Mi, tol=tol, maxiter=maxiter)
        out["ilut"] = {"iterations": k, "converged": ok}
    except RuntimeError as e:  # singular factor etc.
        out["ilut"] = {"iterations": -1, "converged": False, "error": str(e)}

    import jax.numpy as jnp

    from ..solvers.precond.amg import smoothed_aggregation_setup

    M_amg = smoothed_aggregation_setup(A, dtype=jnp.float64)
    n_pad = M_amg.levels[0].A.n_pad if M_amg.levels else n

    def amg_mv(v):
        vp = np.zeros(n_pad)
        vp[:n] = np.ravel(v)
        return np.array(M_amg(jnp.asarray(vp)))[:n]

    Ma = spla.LinearOperator((n, n), matvec=amg_mv)
    k, ok = _count_iters_scipy(S, b, M=Ma, tol=tol, maxiter=maxiter)
    out["amg"] = {"iterations": k, "converged": ok}

    if plan is not None:
        import jax

        from ..parallel.schwarzilu import build_block_ilu

        dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        Ms = build_block_ilu(A, plan, dtype=dt)
        if Ms is None:
            out["schwarz_ilut"] = {
                "iterations": -1, "converged": False, "error": "zero pivot"
            }
        else:
            # One vmapped dispatch over the stacked part axis per GMRES
            # iteration — the per-part Python loop paid plan.nparts jit
            # dispatches per iteration (measured 259 s for the brick P=8
            # row on CPU; ~8x less overhead this way).
            apply_all = jax.jit(jax.vmap(lambda M, r: M(r)))

            def schwarz_mv(v):
                rp = plan.scatter_vector(np.ravel(v).astype(np.float64))
                outp = np.asarray(apply_all(Ms, jnp.asarray(rp, dt)))
                return plan.gather_vector(outp.astype(np.float64))

            Msl = spla.LinearOperator((n, n), matvec=schwarz_mv)
            k, ok = _count_iters_scipy(S, b, M=Msl, tol=tol, maxiter=maxiter)
            out["schwarz_ilut"] = {
                "iterations": k, "converged": ok, "nparts": plan.nparts
            }
    return out

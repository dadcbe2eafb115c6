"""Mixed-precision solve: f32 device Krylov + f64 iterative refinement.

f32 moves half the bytes of f64 through every bandwidth-bound SpMV, and
the answers must still match the f64 reference to 1e-8 relative residual.
Classical iterative refinement gives both:

    repeat:  r = b - A x        (f64, host CSR — one cheap matvec)
             solve A d ~= r     (f32 CG on device, loose tolerance)
             x := x + d         (f64 accumulation)

The device does all the heavy lifting in f32; the f64 outer loop
(a handful of host matvecs) recovers f64-accurate residuals.  Convergence:
each sweep contracts the error by ~the f32 solve tolerance until the f64
residual floor.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.csr import CSRMatrix
from ..ops.dia import choose_operator
from .cg import cg_solve
from .precond.jacobi import DiagonalPreconditioner

__all__ = ["MixedSolveResult", "iterative_refinement_solve"]


def _f32_exact(A: CSRMatrix) -> bool:
    """True iff every CSR entry round-trips f64 -> f32 -> f64 exactly
    (so the f32-stored device operator IS the f64 operator).  Memoized on
    the matrix object: the scan reads ~2.6 GB at 10M DOF / 132M nnz
    (~20 s under CPU contention on the 1-core box) and sits on the
    per-call path of :func:`iterative_refinement_solve`."""
    cached = getattr(A, "_f32_exact_cache", None)
    if cached is None:
        cached = bool(
            np.all(A.data.astype(np.float32).astype(np.float64) == A.data)
        )
        A._f32_exact_cache = cached
    return cached


@partial(jax.jit, static_argnames=("inner_maxiter",))
def _refine_sweep(A32, M, b64, x64, r64, *, inner_tol, inner_maxiter):
    """One refinement sweep entirely on device (a single dispatch):
    scaled f32 inner CG on the CURRENT f64 residual -> f64 update -> new
    f64 residual.  ``r64 = b64 - A x64`` is threaded between sweeps (each
    sweep ends by computing exactly the residual the next one starts
    from), so a sweep costs ONE f64 matvec, and the first sweep of a zero
    initial guess costs one too (``r0 = b64``).
    Returns (x_new, r_new, ||r_new||, inner iterations)."""
    rnorm = jnp.sqrt(jnp.vdot(r64, r64))
    rnorm = jnp.where(rnorm == 0, jnp.asarray(1.0, r64.dtype), rnorm)
    r32 = (r64 / rnorm).astype(jnp.float32)
    res = cg_solve(
        A32, r32, jnp.zeros_like(r32), precond=M,
        tol=inner_tol, maxiter=inner_maxiter,
    )
    x_new = x64 + res.x.astype(jnp.float64) * rnorm
    rn = b64 - A32.matvec(x_new)
    return x_new, rn, jnp.sqrt(jnp.vdot(rn, rn)), res.iterations


def _adaptive_inner_tol(inner_tol: float, tol: float, relres: float) -> float:
    """Inner CG tolerance for the next refinement sweep.

    One sweep contracts the outer residual by roughly the inner solve's
    achieved relative tolerance, so the FINAL sweep only needs
    ``~tol/relres`` — running it to the full ``inner_tol`` overshoots the
    target by orders of magnitude at the cost of several extra inner
    iterations (the 10M 1e-8 bench reached 8e-12).  A 4x safety margin
    absorbs the estimate's slack; early sweeps (large gap) keep
    ``inner_tol``."""
    gap = 0.25 * tol / max(relres, 1e-300)
    return float(min(0.5, max(inner_tol, gap)))


@dataclasses.dataclass
class MixedSolveResult:
    x: np.ndarray  # f64 solution
    refinements: int
    inner_iterations: int
    relres: float  # f64 relative residual
    converged: bool
    # Device path only: {"stage_ms", "sweeps_ms", "fetch_ms"} — the sweep
    # loop (dispatch + device work + scalar sync per sweep) is the solve;
    # staging/fetch are the one-time vector transfers.
    timings: Optional[dict] = None


def _refine_device(
    A32, b, x, bnorm, M, *, tol, inner_tol, inner_maxiter, max_refinements,
    b_device=None, x0_is_zero=False,
) -> MixedSolveResult:
    """Device-resident refinement loop: one dispatch + one scalar fetch
    per sweep (see :func:`_refine_sweep`).

    Host<->device staging is minimized: ``b_device`` lets callers pre-stage the RHS
    once, a zero ``x0`` is created device-side, and the known ``r0 = b``
    residual skips the initial dispatch."""
    import time as _time

    t0 = _time.perf_counter()
    b64 = (
        b_device.astype(jnp.float64)
        if b_device is not None
        else A32.put_vector(b, dtype=np.float64)
    )
    if x0_is_zero:
        x64 = jnp.zeros(A32.n_pad, jnp.float64)
        r64 = b64  # r0 = b exactly, no dispatch
        relres = 1.0
    else:
        x64 = A32.put_vector(x, dtype=np.float64)
        r64 = b64 - A32.matvec(x64)
        relres = float(jnp.sqrt(jnp.vdot(r64, r64))) / bnorm
    t1 = _time.perf_counter()
    inner_total = 0
    refinements = 0
    while relres > tol and refinements < max_refinements:
        x_new, r_new, rnorm_new, iters = _refine_sweep(
            A32, M, b64, x64, r64,
            inner_tol=_adaptive_inner_tol(inner_tol, tol, relres),
            inner_maxiter=inner_maxiter,
        )
        new_relres = float(rnorm_new) / bnorm  # host fetch = the sync point
        inner_total += int(iters)
        refinements += 1
        if new_relres >= relres:  # stagnation at the f32 floor
            break
        x64, r64, relres = x_new, r_new, new_relres
    t2 = _time.perf_counter()
    x_host = np.asarray(A32.get_vector(x64), dtype=np.float64)
    t3 = _time.perf_counter()
    return MixedSolveResult(
        x=x_host,
        refinements=refinements,
        inner_iterations=inner_total,
        relres=relres,
        converged=relres <= tol,
        timings={
            "stage_ms": (t1 - t0) * 1e3,
            "sweeps_ms": (t2 - t1) * 1e3,
            "fetch_ms": (t3 - t2) * 1e3,
        },
    )


def iterative_refinement_solve(
    A: CSRMatrix,
    b: np.ndarray,
    x0: Optional[np.ndarray] = None,
    *,
    tol: float = 1e-10,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 1000,
    max_refinements: int = 20,
    precond: Any = "jacobi",
    operator=None,
    device_residual: Any = "auto",
    b_device=None,
) -> MixedSolveResult:
    """Solve ``A x = b`` to f64 accuracy using an f32 device solver.

    ``A``/``b`` are host f64; the device operator is built once (auto
    DIA/ELL via :func:`..ops.dia.choose_operator`) in f32.  ``precond``:
    ``"jacobi"`` | ``None`` | a callable pytree built by the caller.

    ``device_residual``: run the f64 outer residual on device through the
    stencil operator's dtype-generic path, fusing each sweep (residual +
    inner CG + update) into ONE dispatch — the host path pays 2 host CSR
    matvecs plus an upload/download of the full vector per sweep.
    ``"auto"`` enables it when the operator is a StencilOperator, x64 is
    on, and the CSR data are f32-exact (so
    the f32-stored stencil coefficients ARE the f64 operator — always
    true for the graph Laplacian's integer entries).  ``b_device``: an
    optional pre-staged padded device RHS (any float dtype, the operator's
    space) so repeated solves skip the host->device upload; device path
    only."""
    n = A.n_rows
    b = np.asarray(b, dtype=np.float64)
    x = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64).copy()
    bnorm = float(np.linalg.norm(b)) or 1.0

    A32 = operator if operator is not None else choose_operator(A, dtype=jnp.float32)
    if precond == "jacobi":
        M = DiagonalPreconditioner(1.0 / A32.diagonal_padded(fill=1.0))
    else:
        M = precond

    if device_residual == "auto":
        from ..ops.stencil import StencilOperator

        device_residual = (
            isinstance(A32, StencilOperator)
            and bool(jax.config.jax_enable_x64)
            and _f32_exact(A)
        )
    if device_residual:
        return _refine_device(
            A32, b, x, bnorm, M,
            tol=tol, inner_tol=inner_tol, inner_maxiter=inner_maxiter,
            max_refinements=max_refinements, b_device=b_device,
            x0_is_zero=x0 is None,
        )

    inner_total = 0
    refinements = 0
    relres = float(np.linalg.norm(b - A.matvec(x))) / bnorm
    while relres > tol and refinements < max_refinements:
        r = b - A.matvec(x)  # f64 residual on host
        rnorm = float(np.linalg.norm(r)) or 1.0
        # Scale so the f32 inner solve works near unit magnitude.  The
        # uniform put/get interface keeps this agnostic to the operator's
        # internal layout.
        r32 = A32.put_vector((r / rnorm).astype(np.float32))
        res = cg_solve(
            A32,
            r32,
            jnp.zeros_like(r32),
            precond=M,
            tol=_adaptive_inner_tol(inner_tol, tol, relres),
            maxiter=inner_maxiter,
        )
        d = A32.get_vector(res.x).astype(np.float64) * rnorm
        x = x + d
        inner_total += int(res.iterations)
        refinements += 1
        new_relres = float(np.linalg.norm(b - A.matvec(x))) / bnorm
        if new_relres >= relres:  # stagnation at the f32 floor
            x = x - d  # keep the better iterate; reported relres stays its
            break
        relres = new_relres
    return MixedSolveResult(
        x=x,
        refinements=refinements,
        inner_iterations=inner_total,
        relres=relres,
        converged=relres <= tol,
    )

"""Preconditioned conjugate gradient, pure JAX.

The JAX successor to the reference's Belos GMRES loop
(``BelosMueLuSolver.cpp:87-139``) for the SPD reduced Laplacian: CG is the
right Krylov method for this matrix (GMRES parity lives in :mod:`.gmres`).

Design for XLA: the whole iteration is a ``lax.while_loop`` over statically
shaped arrays — one compiled program, no host round-trips.  Dot products are
plain ``jnp.vdot`` on one device and become ``lax.psum``-reduced partial dots
under ``shard_map`` (see :mod:`..parallel.sharded`), replacing Tpetra's
``MPI_Allreduce``-backed ``dot``/``norm2``.

API note — **operators and preconditioners are pytree arguments**, not
closures: the operator is any pytree with a ``.matvec(x)`` method
(:class:`..ops.ell.ELLMatrix`, sharded block operators, ...) and the
preconditioner any callable pytree (:mod:`.precond`).  Closing a jit over
concrete device arrays embeds them as constants, which this platform
penalizes catastrophically (see the project performance notes).

A separate snapshot driver (:func:`cg_solve_snapshots`) reproduces the
reference's 1-iteration-per-solve + ``writeSolution`` animation loop
(``BelosMueLuSolver.cpp:112-133``) without resetting the Krylov space.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "CGResult",
    "cg_solve",
    "cg_solve_snapshots",
    "cg_solve_resumable",
    "IdentityPrecond",
]


@partial(jax.tree_util.register_dataclass, data_fields=[], meta_fields=[])
@dataclasses.dataclass
class IdentityPrecond:
    """No-op preconditioner (callable pytree)."""

    def __call__(self, r):
        return r


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["x", "iterations", "relres", "converged"],
    meta_fields=[],
)
@dataclasses.dataclass
class CGResult:
    x: jax.Array
    iterations: jax.Array  # int32
    relres: jax.Array  # achieved ||r|| / ||b||
    converged: jax.Array  # bool


def cg_solve(
    A: Any,
    b: jax.Array,
    x0: jax.Array,
    *,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    dot: Callable = jnp.vdot,
) -> CGResult:
    """Solve ``A x = b`` with (preconditioned) CG.

    ``A``: pytree with ``.matvec(x)``.  ``precond``: callable pytree or None.
    ``tol`` is a *relative* residual tolerance ``||r||/||b||`` — the same
    convergence scaling Belos applies to the tolerance the reference passes
    (``BelosMueLuSolver.cpp:101-106``).  ``dot`` is injectable so the sharded
    path can supply a psum-reducing dot.
    """
    result, _ = cg_solve_with_state(
        A, b, x0, precond=precond, tol=tol, maxiter=maxiter, dot=dot
    )
    return result


# ``tol`` is traced (it only scales the while_loop target), so sweeping
# tolerances — e.g. the adaptive inner tolerance of iterative refinement —
# reuses one compiled program instead of recompiling per value.
@partial(jax.jit, static_argnames=("maxiter", "dot"))
def cg_solve_with_state(
    A: Any,
    b: jax.Array,
    x0: jax.Array,
    *,
    state: Any = None,  # None or (r, p, rz) to continue a prior run exactly
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    dot: Callable = jnp.vdot,
):
    """Like :func:`cg_solve` but returns (result, (r, p, rz)) and can resume
    from a prior state — the building block for chunked solves that snapshot
    between chunks *without* restarting the Krylov recurrence (what the
    reference's reset-per-iteration loop destroys,
    ``BelosMueLuSolver.cpp:112-133``)."""
    M = precond if precond is not None else IdentityPrecond()
    bnorm = jnp.sqrt(dot(b, b))
    bnorm = jnp.where(bnorm == 0, jnp.asarray(1.0, b.dtype), bnorm)
    target = jnp.asarray(tol, b.dtype) * bnorm

    if state is None:
        r0 = b - A.matvec(x0)
        z0 = M(r0)
        p0 = z0
        rz0 = dot(r0, z0)
    else:
        r0, p0, rz0 = state
    rnorm0 = jnp.sqrt(dot(r0, r0))

    def cond(s):
        return jnp.logical_and(s[4] > target, s[5] < maxiter)

    def body(s):
        x, r, p, rz, _, k = s
        Ap = A.matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + rz_new / rz * p
        return (x, r, p, rz_new, jnp.sqrt(dot(r, r)), k + 1)

    x, r, p, rz, rnorm, k = jax.lax.while_loop(
        cond, body, (x0, r0, p0, rz0, rnorm0, jnp.int32(0))
    )
    return (
        CGResult(x=x, iterations=k, relres=rnorm / bnorm, converged=rnorm <= target),
        (r, p, rz),
    )


@partial(jax.jit, static_argnames=("dot",))
def _cg_step(A, M, x, r, p, rz, dot=jnp.vdot):
    Ap = A.matvec(p)
    alpha = rz / dot(p, Ap)
    x = x + alpha * p
    r = r - alpha * Ap
    z = M(r)
    rz_new = dot(r, z)
    p = z + rz_new / rz * p
    return x, r, p, rz_new, jnp.sqrt(dot(r, r))


def cg_solve_resumable(
    A: Any,
    b: jax.Array,
    x0: jax.Array,
    *,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    dot: Callable = jnp.vdot,
) -> "CGResult":
    """CG with periodic checkpointing and exact resume.

    If ``checkpoint_path`` holds a prior state (same problem), the recurrence
    continues from it — the capability the reference lacks entirely
    (SURVEY §5 "no solver restart capability").  The CG three-term state
    ``(x, r, p, rz, k)`` fully determines the remaining iterations, so a
    resumed run is identical to an uninterrupted one.
    """
    import hashlib

    import numpy as np

    from ..utils.checkpoint import CGCheckpoint, load_checkpoint, save_checkpoint

    M = precond if precond is not None else IdentityPrecond()
    bnorm = float(jnp.sqrt(dot(b, b))) or 1.0
    # Problem fingerprint: resuming a checkpoint from a *different* system
    # would silently converge to the wrong answer (the recurrence drives the
    # stale residual to zero).  Both the RHS and the OPERATOR are hashed —
    # the same b against a modified matrix (different refine level / BC set)
    # is exactly the failure mode the guard exists to stop.
    def _blake(arrs):
        h = hashlib.blake2b(digest_size=16)
        for a in arrs:
            a = np.asarray(a)
            h.update(str((a.shape, a.dtype.str)).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    b_hash = _blake([b])
    a_hash = _blake(jax.tree_util.tree_leaves(A))

    ck = load_checkpoint(checkpoint_path)
    if ck is not None and (
        ck.meta.get("b_hash") not in (None, b_hash)
        or ck.meta.get("a_hash") not in (None, a_hash)
    ):
        raise ValueError(
            f"checkpoint {checkpoint_path!r} belongs to a different problem "
            f"(RHS hash {ck.meta.get('b_hash')} vs {b_hash}, operator hash "
            f"{ck.meta.get('a_hash')} vs {a_hash}); delete it or use a "
            "different --checkpoint path"
        )
    if ck is not None and ck.x.shape == x0.shape:
        x = jnp.asarray(ck.x)
        r = jnp.asarray(ck.r)
        p = jnp.asarray(ck.p)
        rz = jnp.asarray(ck.rz, b.dtype)
        k = ck.iteration
    else:
        x = x0
        r = b - A.matvec(x0)
        z = M(r)
        p = z
        rz = dot(r, z)
        k = 0
    rnorm = float(jnp.sqrt(dot(r, r)))
    while rnorm / bnorm > tol and k < maxiter:
        x, r, p, rz, rn = _cg_step(A, M, x, r, p, rz, dot=dot)
        rnorm = float(rn)
        k += 1
        if k % checkpoint_every == 0:
            save_checkpoint(
                checkpoint_path,
                CGCheckpoint(
                    x=np.asarray(x), r=np.asarray(r), p=np.asarray(p),
                    rz=float(rz), iteration=k,
                    meta={
                        "bnorm": bnorm,
                        "tol": tol,
                        "b_hash": b_hash,
                        "a_hash": a_hash,
                    },
                ),
            )
    return CGResult(
        x=x,
        iterations=jnp.int32(k),
        relres=jnp.asarray(rnorm / bnorm),
        converged=jnp.asarray(rnorm / bnorm <= tol),
    )


def cg_solve_snapshots(
    A: Any,
    b: jax.Array,
    x0: jax.Array,
    *,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    dot: Callable = jnp.vdot,
    callback: Optional[Callable[[int, jax.Array, float], None]] = None,
):
    """CG with a host callback after every iteration.

    Mirrors the reference's outer loop that snapshots X each iteration for
    the convergence animation (``BelosMueLuSolver.cpp:112-133``) — but keeps
    one continuous Krylov recurrence instead of the reference's
    reset-per-iteration hack (flagged ``TODO: This will not work!`` at
    ``BelosMueLuSolver.cpp:113``).  The per-iteration step is a single jitted
    function; only the snapshot crosses to the host.
    """
    M = precond if precond is not None else IdentityPrecond()
    bnorm = float(jnp.sqrt(dot(b, b)))
    bnorm = bnorm if bnorm != 0 else 1.0
    r = b - A.matvec(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    x = x0
    rnorm = float(jnp.sqrt(dot(r, r)))
    k = 0
    while rnorm / bnorm > tol and k < maxiter:
        x, r, p, rz, rn = _cg_step(A, M, x, r, p, rz, dot=dot)
        rnorm = float(rn)
        k += 1
        if callback is not None:
            callback(k, x, rnorm / bnorm)
    return CGResult(
        x=x,
        iterations=jnp.int32(k),
        relres=jnp.asarray(rnorm / bnorm),
        converged=jnp.asarray(rnorm / bnorm <= tol),
    )

"""Chebyshev polynomial preconditioner / smoother.

The workhorse smoother: k SpMVs, no dots, no sequential dependences —
exactly the trade the hardware wants (HBM-bandwidth SpMVs instead of the
latency-bound triangular solves of the reference's ILUT,
``BelosMueLuSolver.cpp:92-97``).  Used standalone as a preconditioner and as
the smoother inside the AMG V-cycle (:mod:`.amg`), which is the role MueLu's
Chebyshev smoother was meant to play in the reference.

Targets the upper eigenvalue spectrum [lmax/ratio, lmax] of D^-1 A, the
standard smoothed-aggregation configuration.  Implemented as a callable
pytree (see the API note in :mod:`..cg`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ...ops.ell import ELLMatrix

__all__ = [
    "ChebyshevPreconditioner",
    "chebyshev_preconditioner",
    "estimate_lmax_dinv_a",
]


@partial(jax.jit, static_argnames=("iters", "dot"))
def estimate_lmax_dinv_a(
    A: ELLMatrix, iters: int = 20, seed: int = 0, dot: Callable = jnp.vdot
) -> jax.Array:
    """Power-method estimate of lambda_max(D^-1 A) (cf. the reference's
    standalone power method, ``ExodusMatrixTest.cpp:27-129``)."""
    inv_diag = 1.0 / A.diagonal_padded(fill=1.0)
    key = jax.random.PRNGKey(seed)
    q = jax.random.uniform(key, (A.n_pad,), A.dtype)
    # Zero the padding so it never contributes.
    mask = (jnp.arange(A.n_pad) < A.n_rows).astype(A.dtype)
    q = q * mask

    def body(_, q):
        z = inv_diag * A.matvec(q)
        return z / jnp.maximum(jnp.sqrt(dot(z, z)), 1e-30)

    q = jax.lax.fori_loop(0, iters, body, q)
    z = inv_diag * A.matvec(q)
    return dot(q, z)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["A", "inv_diag", "lmax"],
    meta_fields=["degree", "eig_ratio"],
)
@dataclasses.dataclass
class ChebyshevPreconditioner:
    """``M(r) ~ A^{-1} r`` via a degree-k Chebyshev polynomial in D^-1 A
    over [lmax/eig_ratio, 1.1*lmax] (classic three-term recurrence,
    x0 = 0)."""

    A: ELLMatrix
    inv_diag: jax.Array
    lmax: jax.Array
    degree: int = 4
    eig_ratio: float = 30.0

    def __call__(self, r: jax.Array) -> jax.Array:
        upper = 1.1 * self.lmax
        lower = self.lmax / self.eig_ratio
        theta = 0.5 * (upper + lower)
        delta = 0.5 * (upper - lower)
        z = jnp.zeros_like(r)
        d = (1.0 / theta) * (self.inv_diag * r)
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(self.degree):
            z = z + d
            res = self.inv_diag * (r - self.A.matvec(z))
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * res
            rho = rho_new
        return z + d


def chebyshev_preconditioner(
    A: ELLMatrix,
    lmax: float | jax.Array,
    degree: int = 4,
    eig_ratio: float = 30.0,
) -> ChebyshevPreconditioner:
    return ChebyshevPreconditioner(
        A=A,
        inv_diag=1.0 / A.diagonal_padded(fill=1.0),
        lmax=jnp.asarray(lmax, A.dtype),
        degree=degree,
        eig_ratio=eig_ratio,
    )

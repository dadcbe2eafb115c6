"""Jacobi (diagonal) preconditioner.

The device-friendly point preconditioner: one elementwise multiply, fuses into
the surrounding Krylov arithmetic.  Replaces the role of the reference's
Ifpack2 ILUT (``BelosMueLuSolver.cpp:92-97``) on the fast path — ILUT's
sequential triangular solves are hostile to wide SIMD hardware, and for the
graph Laplacian Jacobi/Chebyshev/AMG reach the same answers (SURVEY §7
"ILUT parity").

Implemented as a callable pytree so it can be passed as a jit argument
(see the API note in :mod:`..cg`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax

from ...ops.ell import ELLMatrix

__all__ = ["DiagonalPreconditioner", "jacobi_preconditioner"]


@partial(
    jax.tree_util.register_dataclass, data_fields=["inv_diag"], meta_fields=[]
)
@dataclasses.dataclass
class DiagonalPreconditioner:
    """``M(r) = r * inv_diag`` (callable pytree)."""

    inv_diag: jax.Array

    def __call__(self, r: jax.Array) -> jax.Array:
        return r * self.inv_diag


def jacobi_preconditioner(A: ELLMatrix) -> DiagonalPreconditioner:
    """Build ``M(r) = r / diag(A)`` (padding slots use diag 1)."""
    return DiagonalPreconditioner(inv_diag=1.0 / A.diagonal_padded(fill=1.0))

"""Preconditioner combinators (callable pytrees)."""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax

__all__ = ["CastPreconditioner"]


@partial(
    jax.tree_util.register_dataclass, data_fields=["inner"], meta_fields=["dtype"]
)
@dataclasses.dataclass
class CastPreconditioner:
    """Run ``inner`` in a lower precision and cast back.

    The standard mixed-precision trick: the Krylov recurrence stays in f64
    while the expensive V-cycle/smoother runs in f32 (half the bytes) —
    preconditioner *quality*, not accuracy,
    is what matters for convergence.
    """

    inner: Any
    dtype: Any

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.inner(r.astype(self.dtype)).astype(r.dtype)

"""Hybrid DIA+ELL format and RCM-based bandwidth reduction.

For unstructured meshes no small diagonal set covers the matrix, but after
RCM reordering a significant fraction of nonzeros concentrates on
high-occupancy diagonals.  Since a DIA stream costs ~n elementwise MACs
(VPU streaming) while every ELL entry costs a serialized gather, any
diagonal whose occupancy exceeds a few percent is cheaper to stream than to
gather.  The hybrid operator splits the matrix:

    A = A_dia (popular diagonals, gather-free) + A_ell (remainder)

cutting the gather count — the dominant cost of unstructured SpMV —
by whatever the diagonal coverage reaches (~40% on tet meshes after RCM).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix, coo_to_csr
from .dia import DIAMatrix
from .ell import ELLMatrix, PaddedLayout, ell_from_csr, pad_to

__all__ = ["HYBMatrix", "hyb_from_csr", "rcm_permute"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["dia", "ell"],
    meta_fields=["n_rows"],
)
@dataclasses.dataclass
class HYBMatrix(PaddedLayout):
    """``A = dia + ell`` (both over the same padded row space)."""

    dia: DIAMatrix
    ell: ELLMatrix
    n_rows: int

    @property
    def n_pad(self) -> int:
        return self.dia.n_pad

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def dtype(self):
        return self.dia.dtype

    def matvec(self, x_padded: jax.Array) -> jax.Array:
        return self.dia.matvec(x_padded) + self.ell.matvec(x_padded)

    def diagonal_padded(self, fill: float = 1.0) -> jax.Array:
        d = self.dia.diagonal_padded(fill=0.0) + self.ell.diagonal_padded(
            fill=0.0
        )
        pad_mask = jnp.arange(self.n_pad) >= self.n_rows
        d = jnp.where(d == 0, jnp.asarray(fill, d.dtype), d)
        return jnp.where(pad_mask, jnp.asarray(fill, d.dtype), d)

    def astype(self, dtype) -> "HYBMatrix":
        return HYBMatrix(self.dia.astype(dtype), self.ell.astype(dtype), self.n_rows)


def _dia_part_from_entries(rows, offs, vals, offsets, n, n_pad, dtype):
    data = np.zeros((len(offsets), n_pad), dtype=np.dtype(dtype))
    pos = np.searchsorted(offsets, offs)
    data[pos, rows] = vals.astype(np.dtype(dtype))
    return DIAMatrix(
        data=jnp.asarray(data), offsets=tuple(int(o) for o in offsets), n_rows=n
    )


def hyb_from_csr(
    csr: CSRMatrix,
    dtype=jnp.float32,
    min_occupancy: float = 0.02,
    max_diags: int = 256,
    row_multiple: int = 8,
) -> HYBMatrix:
    """Split into popular diagonals (occupancy >= ``min_occupancy``) + ELL
    remainder.  ``min_occupancy`` ~ the stream-cost / gather-cost ratio per
    element (a diagonal stream of n elements replaces occupancy*n gathers)."""
    n = csr.n_rows
    assert csr.n_cols == n
    n_pad = pad_to(max(n, 1), row_multiple)
    rows = np.repeat(np.arange(n), csr.row_lengths())
    offs = csr.indices - rows
    uniq, inverse, counts = np.unique(offs, return_inverse=True, return_counts=True)
    popular = counts >= max(min_occupancy * n, 1)
    if popular.sum() > max_diags:
        # Keep the max_diags most popular.
        order = np.argsort(-counts)
        keep = np.zeros_like(popular)
        keep[order[:max_diags]] = True
        popular &= keep
    on_dia = popular[inverse]

    dia = _dia_part_from_entries(
        rows[on_dia], offs[on_dia], csr.data[on_dia],
        np.sort(uniq[popular]), n, n_pad, dtype,
    )
    rest = ~on_dia
    ell_csr = coo_to_csr(
        rows[rest], csr.indices[rest], csr.data[rest], (n, n), sum_dups=False
    )
    ell = ell_from_csr(ell_csr, dtype=dtype, row_multiple=row_multiple)
    # Match padded row counts (ELL pads independently).
    if ell.n_pad != n_pad:
        cols = jnp.zeros((n_pad, ell.row_width), dtype=ell.cols.dtype)
        vals = jnp.zeros((n_pad, ell.row_width), dtype=ell.vals.dtype)
        cols = cols.at[: ell.n_pad].set(ell.cols)
        vals = vals.at[: ell.n_pad].set(ell.vals)
        ell = ELLMatrix(cols=cols, vals=vals, n_rows=n, n_cols=n)
    return HYBMatrix(dia=dia, ell=ell, n_rows=n)


def rcm_permute(csr: CSRMatrix) -> Tuple[CSRMatrix, Optional[np.ndarray]]:
    """Symmetric RCM reordering: returns (P A P^T, perm) with ``perm[new] =
    old``; identity fallback (perm=None) when the native library is absent.

    Callers permute vectors with ``b_new = b[perm]`` and invert via
    ``x_old[perm] = x_new``.
    """
    from ..utils.native import rcm_order_native

    perm = rcm_order_native(csr.indptr, csr.indices, csr.n_rows)
    if perm is None:
        return csr, None
    inv = np.zeros_like(perm)
    inv[perm] = np.arange(perm.size)
    rows = np.repeat(np.arange(csr.n_rows), csr.row_lengths())
    permuted = coo_to_csr(
        inv[rows], inv[csr.indices], csr.data, csr.shape, sum_dups=False
    )
    return permuted, perm

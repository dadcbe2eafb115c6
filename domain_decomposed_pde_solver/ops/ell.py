"""Padded ELL sparse format — the device-resident matrix type.

Replaces ``Tpetra::CrsMatrix`` as the device operator storage.  CSR's
variable-length rows force dynamic shapes; ELL pads every row to the same
width K so SpMV becomes a dense-shaped gather + multiply + row-sum that XLA
fuses into one loop.  For the
tet/tri/hex meshes the reference targets, row degree is small (~4-30) and
low-variance, so padding waste is modest (SURVEY §7 "hard parts").

Layout decisions:
- rows are padded to a multiple of 8 — callers keep *vectors*
  padded to the same length so every jitted shape is static;
- padding columns point at row 0 with value 0, so gathers stay in-bounds and
  padded rows/entries contribute exact zeros.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix

__all__ = ["ELLMatrix", "ell_from_csr", "pad_to", "pad_vector", "unpad_vector"]


def pad_to(n: int, multiple: int = 8) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class PaddedLayout:
    """Identity (non-permuting) padded vector layout.

    Uniform host<->device vector interface shared by every operator format
    whose internal vector space is "original order, zero-padded to n_pad"
    (ELL, DIA, Split-ELL, HYB), so solvers and CLIs can stay
    format-agnostic:
    ``A.put_vector(host) -> device``, ``A.get_vector(device) -> host``.
    """

    def put_vector(self, x, dtype=None) -> jax.Array:
        """Host (n,) vector -> device padded vector (input dtype kept)."""
        return pad_vector(np.asarray(x), self.n_pad, dtype=dtype)

    def get_vector(self, xp) -> np.ndarray:
        """Device padded vector -> host (n,) vector."""
        return unpad_vector(xp, self.n_rows)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cols", "vals"],
    meta_fields=["n_rows", "n_cols"],
)
@dataclasses.dataclass
class ELLMatrix(PaddedLayout):
    """Row-padded sparse matrix.

    ``cols``: (n_pad, K) int32 — column index per slot (0 for padding).
    ``vals``: (n_pad, K) float — value per slot (0 for padding).
    ``n_rows``/``n_cols``: logical shape (static pytree metadata).
    """

    cols: jax.Array
    vals: jax.Array
    n_rows: int
    n_cols: int

    @property
    def n_pad(self) -> int:
        return int(self.cols.shape[0])

    @property
    def row_width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def dtype(self):
        return self.vals.dtype

    def astype(self, dtype) -> "ELLMatrix":
        return ELLMatrix(self.cols, self.vals.astype(dtype), self.n_rows, self.n_cols)

    def matvec(self, x_padded: jax.Array) -> jax.Array:
        """SpMV on a padded vector; see :func:`..ops.spmv.ell_spmv`."""
        from .spmv import ell_spmv

        return ell_spmv(self, x_padded)

    def diagonal_padded(self, fill: float = 1.0) -> jax.Array:
        """Diagonal as a padded vector; padding slots get ``fill`` (so
        Jacobi ``1/diag`` stays finite)."""
        n_pad = self.n_pad
        row_ids = jnp.arange(n_pad, dtype=self.cols.dtype)[:, None]
        on_diag = (self.cols == row_ids) & (self.vals != 0)
        d = jnp.sum(jnp.where(on_diag, self.vals, 0), axis=1)
        pad_mask = jnp.arange(n_pad) >= self.n_rows
        return jnp.where(pad_mask, jnp.asarray(fill, d.dtype), d)


def ell_from_csr(
    csr: CSRMatrix,
    dtype=jnp.float32,
    row_multiple: int = 8,
    width_multiple: int = 1,
) -> ELLMatrix:
    """Convert host CSR to device ELL (host-side packing, one device upload)."""
    n_rows, n_cols = csr.shape
    lens = csr.row_lengths()
    k = int(lens.max()) if n_rows else 0
    k = max(pad_to(max(k, 1), width_multiple), 1)
    n_pad = pad_to(max(n_rows, 1), row_multiple)

    from ..utils.native import pack_ell_native

    packed = pack_ell_native(
        csr.indptr, csr.indices, csr.data, n_rows, n_pad, k, dtype
    )
    if packed is not None:
        cols, vals = packed
    else:
        cols = np.zeros((n_pad, k), dtype=np.int32)
        vals64 = np.zeros((n_pad, k), dtype=np.float64)
        # Scatter CSR entries into the padded layout in one shot.
        rows = np.repeat(np.arange(n_rows), lens)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], lens)
        cols[rows, slot] = csr.indices
        vals64[rows, slot] = csr.data
        vals = vals64.astype(np.dtype(dtype))
    return ELLMatrix(
        cols=jnp.asarray(cols),
        vals=jnp.asarray(vals),
        n_rows=n_rows,
        n_cols=n_cols,
    )


def pad_vector(x: np.ndarray, n_pad: int, dtype=None) -> jax.Array:
    x = np.asarray(x)
    out = np.zeros(n_pad, dtype=x.dtype if dtype is None else np.dtype(dtype))
    out[: x.size] = x
    return jnp.asarray(out)


def unpad_vector(x: jax.Array, n: int) -> np.ndarray:
    return np.asarray(x)[:n]

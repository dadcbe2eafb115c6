"""Split-ELL: width-capped ELL + compact overflow — fewer padded slots.

ELL pads every row to the *maximum* row width, and every padded slot still
costs a load and a gather, so the worst row taxes the whole matrix
(tet meshes: mean degree ~14, max ~24 → ~40% wasted gathers).  Split-ELL
caps the dense part at K* chosen to minimize total memory-op count

    cost(K) = n_pad * K  +  2 * Σ_r max(len_r - K, 0)

(the factor 2: each overflow entry needs a gather *and* a scatter-add), and
routes the overflow through flat (row, col, val) triples applied with
``.at[rows].add``.  A drop-in ELLMatrix replacement (same matvec contract).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix
from .ell import PaddedLayout, pad_to

__all__ = ["SplitELLMatrix", "splitell_from_csr"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cols", "vals", "tail_rows", "tail_cols", "tail_vals"],
    meta_fields=["n_rows", "n_cols"],
)
@dataclasses.dataclass
class SplitELLMatrix(PaddedLayout):
    cols: jax.Array  # (n_pad, K*) int32
    vals: jax.Array  # (n_pad, K*)
    tail_rows: jax.Array  # (t_pad,) int32 (0 for padding, with val 0)
    tail_cols: jax.Array  # (t_pad,) int32
    tail_vals: jax.Array  # (t_pad,)
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

    def matvec(self, x_padded: jax.Array) -> jax.Array:
        y = jnp.sum(self.vals * jnp.take(x_padded, self.cols, axis=0), axis=1)
        return y.at[self.tail_rows].add(
            self.tail_vals * jnp.take(x_padded, self.tail_cols, axis=0)
        )

    def diagonal_padded(self, fill: float = 1.0) -> jax.Array:
        row_ids = jnp.arange(self.n_pad, dtype=self.cols.dtype)[:, None]
        on_diag = (self.cols == row_ids) & (self.vals != 0)
        d = jnp.sum(jnp.where(on_diag, self.vals, 0), axis=1)
        tail_diag = jnp.where(
            (self.tail_rows == self.tail_cols) & (self.tail_vals != 0),
            self.tail_vals,
            0,
        )
        d = d.at[self.tail_rows].add(tail_diag)
        pad_mask = jnp.arange(self.n_pad) >= self.n_rows
        return jnp.where(pad_mask, jnp.asarray(fill, d.dtype), d)

    def astype(self, dtype) -> "SplitELLMatrix":
        return SplitELLMatrix(
            self.cols, self.vals.astype(dtype), self.tail_rows, self.tail_cols,
            self.tail_vals.astype(dtype), self.n_rows, self.n_cols,
        )


def splitell_from_csr(
    csr: CSRMatrix, dtype=jnp.float32, row_multiple: int = 8
) -> SplitELLMatrix:
    n_rows, n_cols = csr.shape
    lens = csr.row_lengths()
    kmax = int(lens.max()) if n_rows else 1
    n_pad = pad_to(max(n_rows, 1), row_multiple)

    # Choose the cost-minimizing cap.  overflow(K) = sum_r max(len_r - K, 0)
    # via suffix sums of the row-length histogram: O(kmax), not O(kmax * n).
    ks = np.arange(1, kmax + 1)
    hist = np.bincount(lens, minlength=kmax + 2)
    rows_longer = np.cumsum(hist[::-1])[::-1]  # rows with len >= index
    tail_counts = np.array([int(rows_longer[k + 1 :].sum()) for k in ks])
    cost = n_pad * ks + 2 * tail_counts
    K = int(ks[np.argmin(cost)])

    rows = np.repeat(np.arange(n_rows), lens)
    slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], lens)
    main = slot < K
    cols = np.zeros((n_pad, K), dtype=np.int32)
    vals = np.zeros((n_pad, K), dtype=np.dtype(dtype))
    cols[rows[main], slot[main]] = csr.indices[main]
    vals[rows[main], slot[main]] = csr.data[main]

    t = int((~main).sum())
    t_pad = pad_to(max(t, 1), 8)
    tr = np.zeros(t_pad, dtype=np.int32)
    tc = np.zeros(t_pad, dtype=np.int32)
    tv = np.zeros(t_pad, dtype=np.dtype(dtype))
    tr[:t] = rows[~main]
    tc[:t] = csr.indices[~main]
    tv[:t] = csr.data[~main]
    return SplitELLMatrix(
        cols=jnp.asarray(cols),
        vals=jnp.asarray(vals),
        tail_rows=jnp.asarray(tr),
        tail_cols=jnp.asarray(tc),
        tail_vals=jnp.asarray(tv),
        n_rows=n_rows,
        n_cols=n_cols,
    )

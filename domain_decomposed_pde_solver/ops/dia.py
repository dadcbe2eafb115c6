"""DIA (diagonal/stencil) sparse format — the gather-free SpMV path.

The ELL path (:mod:`.ell`) reads a column index per stored entry and
gathers ``x``.  Structured meshes (the generated boxes used for the 1M/10M-DOF BASELINE
configs, and any lexicographically-numbered grid) produce matrices whose
nonzeros lie on a *fixed small set of diagonals* — e.g. 19 diagonals cover
100% of the 5-tet box Laplacian.  For those, SpMV is a sum of shifted
elementwise multiplies: pure VPU streaming, zero gathers:

    y[i] = sum_d  data[d, i] * x[i + offset_d]

Each shift compiles to two contiguous slices (a roll), so the whole SpMV is
a bandwidth-bound stream.  :func:`choose_operator` picks
DIA automatically when the diagonal count is small enough to win.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix
from .ell import ELLMatrix, PaddedLayout, ell_from_csr, pad_to

__all__ = ["DIAMatrix", "dia_from_csr", "choose_operator", "operator_bytes"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["offsets", "n_rows", "compute_dtype"],
)
@dataclasses.dataclass
class DIAMatrix(PaddedLayout):
    """Diagonal-storage sparse matrix.

    ``data[d, i]`` is the coefficient of ``x[i + offsets[d]]`` in row ``i``
    (zero where that column doesn't exist).  ``offsets`` is a static tuple,
    so the shift loop fully unrolls under jit.

    ``data`` may be stored narrower than the compute dtype (``compute_dtype``
    non-empty, e.g. bfloat16 storage with float32 compute): the matvec
    upcasts each diagonal before the multiply.  :func:`dia_from_csr` only
    selects narrow storage when every entry is *exactly* representable
    (graph-Laplacian entries are small integers), so results are bit-exact
    while the dominant ``ndiags * n`` HBM stream halves.
    """

    data: jax.Array  # (ndiags, n_pad), possibly narrow storage
    offsets: Tuple[int, ...]
    n_rows: int
    compute_dtype: str = ""  # "" -> data.dtype

    @property
    def n_pad(self) -> int:
        return int(self.data.shape[1])

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        """The compute/vector dtype (NOT the storage dtype of ``data``)."""
        if self.compute_dtype:
            return jnp.dtype(self.compute_dtype)
        return self.data.dtype

    def matvec(self, x_padded: jax.Array) -> jax.Array:
        """y = A @ x on padded vectors.

        One edge-padded ``x_ext`` with a static window slice per diagonal
        (a roll would be two slices + a concat), pairwise-tree accumulation to shorten the
        dependency chain.  Wrapped/edge lanes always multiply a
        structurally-zero coefficient (a nonzero data[d, i] implies
        0 <= i+o < n_rows <= n_pad)."""
        h_neg = max(0, -min(self.offsets))
        h_pos = max(0, max(self.offsets))
        x_ext = jnp.pad(x_padded, (h_neg, h_pos))
        n = self.n_pad
        terms = [
            self.data[d].astype(x_padded.dtype)
            * jax.lax.dynamic_slice(x_ext, (h_neg + off,), (n,))
            for d, off in enumerate(self.offsets)
        ]
        while len(terms) > 1:
            pairs = [a + b for a, b in zip(terms[::2], terms[1::2])]
            if len(terms) % 2:
                pairs.append(terms[-1])
            terms = pairs
        return terms[0]

    def matvec_roll(self, x_padded: jax.Array) -> jax.Array:
        """Reference roll-chain variant (``jnp.roll(x, -o)[i] = x[i+o]``);
        kept for cross-checking :meth:`matvec` and for backends where the
        padded-window form loses."""
        y = jnp.zeros_like(x_padded)
        for d, off in enumerate(self.offsets):
            y = y + self.data[d].astype(x_padded.dtype) * jnp.roll(
                x_padded, -off
            )
        return y

    def diagonal_padded(self, fill: float = 1.0) -> jax.Array:
        if 0 in self.offsets:
            d = self.data[self.offsets.index(0)].astype(self.dtype)
        else:
            d = jnp.zeros(self.n_pad, self.dtype)
        pad_mask = jnp.arange(self.n_pad) >= self.n_rows
        d = jnp.where(d == 0, jnp.asarray(fill, self.dtype), d)
        return jnp.where(pad_mask, jnp.asarray(fill, self.dtype), d)

    def astype(self, dtype) -> "DIAMatrix":
        """Materialize storage in ``dtype`` (drops any narrow storage)."""
        return DIAMatrix(self.data.astype(dtype), self.offsets, self.n_rows)


def _bf16_exact(vals: np.ndarray) -> bool:
    """True iff every value survives a round-trip through bfloat16.

    Graph-Laplacian entries (integer degrees and -1s) always do; AMG
    coarse/filtered operators generally don't, so they keep full storage.
    Bit-level check (bfloat16 is float32 with the low 16 mantissa bits
    truncated, so exactness == those bits are zero) — ml_dtypes casts are
    software-emulated and ~100x slower at 10M+ nnz.  A sampled prefix
    short-circuits the common inexact case."""

    from ..utils.native import bf16_exact_native

    res = bf16_exact_native(vals)
    if res is not None:
        return res

    def _ok(chunk: np.ndarray) -> bool:
        f32 = np.ascontiguousarray(chunk, dtype=np.float32)
        if not np.array_equal(f32.astype(np.float64),
                              np.asarray(chunk, dtype=np.float64)):
            return False
        bits = f32.view(np.uint32)
        return bool(((bits & np.uint32(0xFFFF)) == 0).all())

    head = min(4096, vals.size)
    if not _ok(vals[:head]):
        return False
    return _ok(vals[head:]) if vals.size > head else True


def pack_dia_host(
    csr: CSRMatrix,
    dtype=jnp.float32,
    max_diags: int = 64,
    row_multiple: int = 8,
):
    """Host-only DIA detect+pack: ``(offsets, data (ndiags, n_pad))`` NumPy
    arrays, or None when the matrix has more than ``max_diags`` diagonals
    (or is not square).  No device transfer — :func:`choose_operator` runs
    stencil detection on this form before uploading anything (at 10M DOF
    the (27, n) DIA array is ~1.1 GB; an upload+download round-trip through
    it dominated operator build time)."""
    n = csr.n_rows
    if csr.n_cols != n:
        return None
    n_pad = pad_to(max(n, 1), row_multiple)
    if np.dtype(dtype) == np.float32:
        # Native single-pass detect+pack (the NumPy form below needs three
        # nnz-sized temporaries plus a sort: ~3.5 s at 19M nnz vs ~0.2 s).
        from ..utils.native import pack_dia_native

        packed = pack_dia_native(
            csr.indptr, csr.indices, csr.data, n, n_pad, max_diags
        )
        if packed == "toomany":
            return None
        if packed is not None:
            return packed
    rows = np.repeat(np.arange(n), csr.row_lengths())
    offs = csr.indices - rows
    uniq = np.unique(offs)
    if uniq.size > max_diags:
        return None
    data = np.zeros((uniq.size, n_pad), dtype=np.dtype(dtype))
    dpos = np.searchsorted(uniq, offs)
    data[dpos, rows] = csr.data.astype(np.dtype(dtype))
    return uniq, data


def _dia_wrap_device(csr, uniq, data, dtype, storage) -> DIAMatrix:
    compute = ""
    dev_data = jnp.asarray(data)
    if (
        storage == "auto"
        and np.dtype(dtype).itemsize > 2
        and _bf16_exact(csr.data)
    ):
        # Cast via XLA (numpy's ml_dtypes bf16 cast is software-emulated
        # and dominates setup time at 10M+ nnz).
        dev_data = dev_data.astype(jnp.bfloat16)
        compute = np.dtype(dtype).name
    return DIAMatrix(
        data=dev_data,
        offsets=tuple(int(o) for o in uniq),
        n_rows=csr.n_rows,
        compute_dtype=compute,
    )


def dia_from_csr(
    csr: CSRMatrix,
    dtype=jnp.float32,
    max_diags: int = 64,
    row_multiple: int = 8,
    storage: str = "auto",
) -> Optional[DIAMatrix]:
    """Convert to DIA iff every nonzero lies on at most ``max_diags``
    diagonals; returns None otherwise.

    ``storage="auto"`` stores the diagonals in bfloat16 when every entry is
    exactly representable there (bit-exact results, ~2x less SpMV traffic);
    ``storage="full"`` forces storage == compute dtype."""
    packed = pack_dia_host(csr, dtype, max_diags, row_multiple)
    if packed is None:
        return None
    uniq, data = packed
    return _dia_wrap_device(csr, uniq, data, dtype, storage)


def choose_operator(
    csr: CSRMatrix,
    dtype=jnp.float32,
    max_diags: int = 64,
    grid_dims=None,
):
    """Pick the device format for this matrix.

    - with ``grid_dims`` (a lexicographic (mx, my, mz) free-node grid),
      the pattern-broadcast lattice-stencil form when the matrix
      decomposes exactly (:mod:`.stencil`, f32 only);
    - DIA when the diagonal count is small (stencil/structured meshes):
      traffic is ``ndiags * n`` values but zero gathers;
    - for unstructured matrices, Split-ELL when capping the row width
      saves >= 10% of the padded slots;
    - plain ELL otherwise.
    """
    packed = pack_dia_host(csr, dtype=dtype, max_diags=max_diags)
    if packed is not None:
        uniq, data = packed
        if grid_dims is not None and jnp.dtype(dtype) == jnp.float32:
            from .stencil import stencil_from_parts, stencil_parts_from_packed

            # Detect on the HOST pack — a stencil mesh never uploads the
            # (ndiags, n) DIA array at all (~1.1 GB at 10M DOF), and the
            # padded form is built straight from the host parts (no
            # intermediate device operator / corr round-trip).
            parts = stencil_parts_from_packed(
                uniq, data, csr.n_rows, grid_dims
            )
            if parts is not None:
                return stencil_from_parts(parts, dtype=dtype)
        return _dia_wrap_device(csr, uniq, data, dtype, "auto")
    from .splitell import splitell_from_csr

    spl = splitell_from_csr(csr, dtype=dtype)
    ops_spl = spl.n_pad * spl.row_width + 2 * int(spl.tail_rows.shape[0])
    ops_ell = spl.n_pad * max(csr.max_row_nnz, 1)
    if ops_spl <= 0.9 * ops_ell:
        return spl
    return ell_from_csr(csr, dtype=dtype)


def operator_bytes(A) -> int:
    """Minimum HBM traffic of one SpMV with this operator (DIA, ELL,
    Split-ELL, or HYB)."""
    if isinstance(A, DIAMatrix):
        sb = A.data.dtype.itemsize  # storage (possibly bf16)
        vb = A.dtype.itemsize  # x/y vectors in compute dtype
        return A.ndiags * A.n_pad * sb + 2 * A.n_pad * vb
    from .splitell import SplitELLMatrix

    if isinstance(A, SplitELLMatrix):
        vb = A.vals.dtype.itemsize
        ib = A.cols.dtype.itemsize
        tail = int(A.tail_rows.shape[0])
        return (
            A.n_pad * A.row_width * (vb + ib)
            + tail * (vb + 2 * ib)
            + 2 * A.n_pad * vb
        )
    from .hyb import HYBMatrix

    if isinstance(A, HYBMatrix):
        return operator_bytes(A.dia) + operator_bytes(A.ell)
    from .stencil import StencilOperator

    if isinstance(A, StencilOperator):
        # x + y + corr — the patterns broadcast from registers.
        vb = A.dtype.itemsize
        return 3 * A.n_pad * vb
    from .spmv import spmv_bytes

    return spmv_bytes(A)

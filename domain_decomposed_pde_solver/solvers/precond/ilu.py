"""ILU(0) preconditioner — the reference-parity incomplete factorization.

The reference's production configuration is Belos GMRES right-preconditioned
with Ifpack2 **ILUT** (``BelosMueLuSolver.cpp:92-106``, default params).
This module provides the framework's own incomplete-LU family so literal
iteration-count parity runs need no external library: ILU(0) (zero fill —
the standard parity baseline; Ifpack2's ILUT at its default fill ~ILU(0)
for Laplacians whose factors stay within the sparsity pattern).

Factorization runs on host in native C++ (``ddps_native.cpp::ilu0``, NumPy
fallback) — incomplete factorization is inherently sequential and belongs
on the host, exactly like Ifpack2's (SURVEY §7 "ILUT parity").

The *apply* runs on the device: sparse triangular solves are level-scheduled
(``tri_levels``): rows are grouped into dependency levels, each level's rows
are mutually independent, and the device sweeps levels with a
statically-shaped ``lax.fori_loop`` — a dynamic window slice over the
solve-ordered ELL factors + masked scatter per level.  The levels run one
after another, so this is not the performance path (AMG/Chebyshev are); it exists for
answer/iteration parity with the reference's solver stack.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.csr import CSRMatrix
from ...ops.ell import pad_to

__all__ = ["ILU0Preconditioner", "ilu0_preconditioner", "ilu0_factor", "ilut_preconditioner"]


def ilu0_factor(csr: CSRMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """ILU(0) of a column-sorted CSR: returns (lu_data, diag_pos).

    ``lu_data`` holds L (strictly lower, unit-diagonal implied) and U
    (upper including diagonal) in A's sparsity pattern, like Ifpack2's
    ``compute()``.  Native C++ when available, NumPy/Python fallback.
    Raises ``ZeroDivisionError`` on a zero pivot.
    """
    from ...utils.native import ilu0_native

    n = csr.n_rows
    out = ilu0_native(csr.indptr, csr.indices, csr.data, n)
    if out is not None:
        return out

    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    lu = np.asarray(csr.data, dtype=np.float64).copy()
    diag_pos = np.full(n, -1, dtype=np.int64)
    pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        row_cols = indices[s:e]
        pos[row_cols] = np.arange(s, e)
        dp = pos[i]
        if dp < 0:
            raise ZeroDivisionError(f"ILU(0): missing diagonal at row {i}")
        diag_pos[i] = dp
        for p in range(s, e):
            k = indices[p]
            if k >= i:
                break
            pivot = lu[diag_pos[k]]
            if pivot == 0.0:
                raise ZeroDivisionError(f"ILU(0): zero pivot at row {k}")
            lik = lu[p] / pivot
            lu[p] = lik
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            pp = pos[indices[ks:ke]]
            hit = pp >= 0
            lu[pp[hit]] -= lik * lu[ks:ke][hit]
        if lu[dp] == 0.0:
            raise ZeroDivisionError(f"ILU(0): zero pivot at row {i}")
        pos[row_cols] = -1
    return lu, diag_pos


def _tri_levels(indptr, indices, n, lower: bool) -> Tuple[np.ndarray, int]:
    from ...utils.native import tri_levels_native

    out = tri_levels_native(indptr, indices, n, lower)
    if out is not None:
        return out
    level = np.zeros(n, dtype=np.int64)
    nlev = 0
    rng = range(n) if lower else range(n - 1, -1, -1)
    for i in rng:
        deps = indices[indptr[i] : indptr[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        lv = int(level[deps].max()) + 1 if deps.size else 0
        level[i] = lv
        nlev = max(nlev, lv + 1)
    return level, nlev


def _pack_tri_levels(rows_sorted, level_of, nlev, indptr, indices, vals, n_pad):
    """Pack a triangular factor into solve-ordered ELL + level windows.

    Returns (cols (R,K) int32, v (R,K) f32, rows (R,) int32,
    starts (nlev,) int32, counts (nlev,) int32, win) where R = total rows in
    solve order and win = max level size (the static window the device sweep
    slices per level)."""
    lens = np.diff(indptr)[rows_sorted]
    K = max(int(lens.max()) if lens.size else 1, 1)
    R = rows_sorted.size
    cols = np.zeros((R, K), dtype=np.int32)
    v = np.zeros((R, K), dtype=np.float32)
    total = int(lens.sum())
    out_rows = np.repeat(np.arange(R), lens)
    slot = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    src = np.repeat(indptr[rows_sorted], lens) + slot
    cols[out_rows, slot] = indices[src]
    v[out_rows, slot] = vals[src]
    counts = np.bincount(level_of[rows_sorted], minlength=nlev).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    win = int(counts.max()) if counts.size else 1
    # Pad the solve-order arrays so every window slice is in-bounds; padding
    # rows write to the dump slot (n_pad) and are dropped by the scatter.
    pad = max(win - 1, 0)
    if pad:
        cols = np.vstack([cols, np.zeros((pad, K), np.int32)])
        v = np.vstack([v, np.zeros((pad, K), np.float32)])
    rows = np.concatenate(
        [rows_sorted.astype(np.int32), np.full(pad, n_pad, np.int32)]
    )
    return cols, v, rows, starts, counts, win


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "l_cols", "l_vals", "l_rows", "l_starts", "l_counts",
        "u_cols", "u_vals", "u_rows", "u_starts", "u_counts",
        "inv_diag",
    ],
    meta_fields=["n_pad", "l_win", "u_win", "l_nlev", "u_nlev"],
)
@dataclasses.dataclass
class ILU0Preconditioner:
    """Callable pytree: ``M(r) ~= A^{-1} r`` via exact L/U triangular solves
    of the ILU(0) factors, level-parallel on device."""

    l_cols: jax.Array
    l_vals: jax.Array
    l_rows: jax.Array
    l_starts: jax.Array
    l_counts: jax.Array
    u_cols: jax.Array
    u_vals: jax.Array
    u_rows: jax.Array
    u_starts: jax.Array
    u_counts: jax.Array
    inv_diag: jax.Array  # (n_pad,)
    n_pad: int
    l_win: int
    u_win: int
    l_nlev: int
    u_nlev: int

    def __call__(self, r: jax.Array) -> jax.Array:
        y = _tri_sweep(
            r, r,  # L x = r, unit diagonal: x_r = r_r - L.x
            self.l_cols, self.l_vals, self.l_rows,
            self.l_starts, self.l_counts, self.l_win, self.l_nlev,
            self.n_pad, None,
        )
        # U x = y with diagonal scale.
        return _tri_sweep(
            y, y,
            self.u_cols, self.u_vals, self.u_rows,
            self.u_starts, self.u_counts, self.u_win, self.u_nlev,
            self.n_pad, self.inv_diag,
        )


def _tri_sweep(b, x0, cols, vals, rows, starts, counts, win, nlev, n_pad, inv_diag):
    """Level-scheduled triangular solve: x[rows_l] = (b[rows_l] - T x)[*inv_d]."""
    if nlev == 0:
        return x0
    # One dump slot past the end swallows masked/padded writes and reads.
    x = jnp.concatenate([x0, jnp.zeros((1,), x0.dtype)])

    def body(l, x):
        s = starts[l]
        c = counts[l]
        zero = jnp.zeros((), s.dtype)
        wc = jax.lax.dynamic_slice(cols, (s, zero), (win, cols.shape[1]))
        wv = jax.lax.dynamic_slice(vals, (s, zero), (win, vals.shape[1]))
        wr = jax.lax.dynamic_slice(rows, (s,), (win,))
        mask = jnp.arange(win) < c
        acc = jnp.sum(wv * x[wc], axis=1)
        val = b[jnp.minimum(wr, n_pad - 1)] - acc
        if inv_diag is not None:
            val = val * inv_diag[jnp.minimum(wr, n_pad - 1)]
        tgt = jnp.where(mask, wr, n_pad)  # masked rows -> dump slot
        return x.at[tgt].set(jnp.where(mask, val, 0.0))

    x = jax.lax.fori_loop(0, nlev, body, x)
    return x[:-1]


def ilu0_preconditioner(
    csr: CSRMatrix, n_pad: int | None = None, dtype=jnp.float32
) -> ILU0Preconditioner:
    """Factor ``csr`` with ILU(0) and build the device-appliable
    preconditioner.  ``n_pad``: the operator's padded vector length (defaults
    to ``pad_to(n)``); must match the vectors the solver passes."""
    n = csr.n_rows
    lu, diag_pos = ilu0_factor(csr)
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)

    rows_all = np.repeat(np.arange(n), np.diff(indptr))
    lower = indices < rows_all
    upper = indices > rows_all

    def _sub(mask):
        cnt = np.bincount(rows_all[mask], minlength=n)
        p = np.concatenate([[0], np.cumsum(cnt)])
        return p.astype(np.int64), indices[mask], lu[mask]

    Lp, Li, Lx = _sub(lower)
    Up, Ui, Ux = _sub(upper)
    return _build_tri_precond(
        Lp, Li, Lx, Up, Ui, Ux, lu[diag_pos], n, n_pad, dtype
    )


def ilut_preconditioner(
    csr: CSRMatrix,
    n_pad: int | None = None,
    dtype=jnp.float32,
    fill_factor: float = 1.0,
    droptol: float = 0.0,
) -> ILU0Preconditioner:
    """ILUT (Saad's threshold incomplete LU) — the literal analogue of the
    reference's production preconditioner, Ifpack2 ILUT with its defaults
    ``fact: ilut level-of-fill = 1.0`` / ``fact: drop tolerance = 0``
    (``BelosMueLuSolver.cpp:92-97``).

    ``fill_factor``: each factor row keeps at most
    ``ceil(fill_factor * nnz(A_i))`` entries (largest by magnitude);
    ``droptol``: entries below ``droptol * ||row||_2`` are dropped during
    elimination.  Factorization in native C++ (NumPy fallback); the device
    apply is the same level-scheduled triangular sweep as ILU(0)."""
    n = csr.n_rows
    out = _ilut_factor(csr, fill_factor, droptol)
    Lp, Li, Lx, Up, Ui, Ux, diag = out
    return _build_tri_precond(Lp, Li, Lx, Up, Ui, Ux, diag, n, n_pad, dtype)


def _ilut_factor(csr: CSRMatrix, fill_factor: float, droptol: float):
    from ...utils.native import ilut_native

    out = ilut_native(
        csr.indptr, csr.indices, csr.data, csr.n_rows, fill_factor, droptol
    )
    if out is not None:
        return out

    # NumPy/Python fallback (row-wise IKJ with a dense working row).
    n = csr.n_rows
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    data = np.asarray(csr.data, dtype=np.float64)
    Lp = [0]
    Up = [0]
    Li, Lx, Ui, Ux = [], [], [], []
    diag = np.zeros(n)
    Urows = []  # (cols, vals, diag) per finished row for the updates
    w = np.zeros(n)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        w[cols_i] = data[s:e]
        occ = set(cols_i.tolist())
        tau = droptol * np.linalg.norm(data[s:e])
        p_keep = max(1, int(np.ceil(fill_factor * (e - s))))
        # Worklist in ascending column order; lower fill-ins created during
        # elimination are inserted and processed too (they are always > the
        # current pivot column, so ascending order is preserved).
        import bisect

        work = sorted(c for c in occ if c < i)
        idx = 0
        while idx < len(work):
            k = work[idx]
            idx += 1
            if w[k] == 0.0:
                continue
            w[k] /= diag[k]
            if abs(w[k]) < tau:
                w[k] = 0.0
                continue
            ucols, uvals = Urows[k]
            for c, v in zip(ucols, uvals):
                if c not in occ:
                    occ.add(c)
                    if c < i:
                        bisect.insort(work, c, lo=idx)
                w[c] -= w[k] * v
        low = sorted(c for c in occ if c < i and w[c] != 0.0)
        upp = sorted(c for c in occ if c > i and w[c] != 0.0)
        lvals = np.array([w[c] for c in low])
        uvals = np.array([w[c] for c in upp])
        keepl = np.argsort(-np.abs(lvals), kind="stable")[:p_keep]
        keepu = np.argsort(-np.abs(uvals), kind="stable")[:p_keep]
        keepl = np.sort(keepl)
        keepu = np.sort(keepu)
        if w[i] == 0.0:
            raise ZeroDivisionError(f"ILUT: zero pivot at row {i}")
        diag[i] = w[i]
        Li.extend(int(low[j]) for j in keepl)
        Lx.extend(float(lvals[j]) for j in keepl)
        Ui.extend(int(upp[j]) for j in keepu)
        Ux.extend(float(uvals[j]) for j in keepu)
        Lp.append(len(Li))
        Up.append(len(Ui))
        Urows.append(([int(upp[j]) for j in keepu],
                      [float(uvals[j]) for j in keepu]))
        for c in occ:
            w[c] = 0.0
        w[i] = 0.0
    return (
        np.asarray(Lp, np.int64), np.asarray(Li, np.int64),
        np.asarray(Lx, np.float64),
        np.asarray(Up, np.int64), np.asarray(Ui, np.int64),
        np.asarray(Ux, np.float64), diag,
    )


def _build_tri_precond(Lp, Li, Lx, Up, Ui, Ux, diag_vals, n, n_pad, dtype):
    if n_pad is None:
        n_pad = pad_to(max(n, 1))

    l_level, l_nlev = _tri_levels(Lp, Li, n, lower=True)
    u_level, u_nlev = _tri_levels(Up, Ui, n, lower=False)
    l_order = np.argsort(l_level, kind="stable").astype(np.int64)
    u_order = np.argsort(u_level, kind="stable").astype(np.int64)

    lc, lv, lr, ls, lcnt, lwin = _pack_tri_levels(
        l_order, l_level, l_nlev, Lp, Li, Lx, n_pad
    )
    uc, uv, ur, us, ucnt, uwin = _pack_tri_levels(
        u_order, u_level, u_nlev, Up, Ui, Ux, n_pad
    )

    inv_d = np.ones(n_pad, dtype=np.float32)
    inv_d[:n] = 1.0 / diag_vals

    dt = jnp.dtype(dtype)
    return ILU0Preconditioner(
        l_cols=jnp.asarray(lc), l_vals=jnp.asarray(lv.astype(dt)),
        l_rows=jnp.asarray(lr), l_starts=jnp.asarray(ls),
        l_counts=jnp.asarray(lcnt),
        u_cols=jnp.asarray(uc), u_vals=jnp.asarray(uv.astype(dt)),
        u_rows=jnp.asarray(ur), u_starts=jnp.asarray(us),
        u_counts=jnp.asarray(ucnt),
        inv_diag=jnp.asarray(inv_d.astype(dt)),
        n_pad=int(n_pad), l_win=lwin, u_win=uwin,
        l_nlev=int(l_nlev), u_nlev=int(u_nlev),
    )

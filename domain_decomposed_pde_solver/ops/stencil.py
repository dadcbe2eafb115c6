"""Stencil (lattice) SpMV with pattern-broadcast coefficients — 3x over DIA.

DIA SpMV streams ``ndiags * n`` stored coefficients per matvec
(``ops/dia.py``).  But the matrices behind the structured BASELINE configs
are *lattice stencils*: on a regular grid every interior row of the
heat/FEM operator repeats one of a small set of coefficient patterns —
measured on the 5-tet box Laplacian, the pattern depends only on the node's
parity class ``(ix%2, iy%2, iz%2)``, and all off-diagonal couplings equal
the interior value wherever the neighbor exists.  Boundary rows deviate
**only on the main diagonal** (degree drop).  Hence exactly:

    y  =  sum_d  pattern_d(parity) * shift(x, d)  +  corr * x

where ``pattern_d`` is a (p, p, p)-periodic coefficient field (p = 1 or 2)
broadcast on the fly — never stored or streamed — and ``corr`` is the
elementwise diagonal correction.  HBM traffic collapses from
``(ndiags + 2) * n`` values to ``3 * n`` (x, y, corr), exact to f32
rounding.

:func:`stencil_from_dia` verifies the decomposition **exactly** against
the DIA data (per-entry) and returns None when the matrix is not a
period-1/2 lattice stencil, so using it is never a semantics gamble.
(An MXU space-to-depth channel-conv formulation was evaluated and
rejected: XLA lowers tiny-channel 3D convs at ~1% MXU utilization.)

Replaces the SpMV inside the solve loop the reference runs via Tpetra
(``BelosMueLuSolver.cpp:112-133``) for structured meshes.
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix
from .dia import DIAMatrix, dia_from_csr
from .ell import PaddedLayout, pad_to

__all__ = ["StencilOperator", "stencil_from_dia", "stencil_from_csr"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["pats", "const_vals", "corr"],
    meta_fields=[
        "taps", "groups", "group_const", "dims", "period", "n_rows", "n_pad",
    ],
)
@dataclasses.dataclass
class StencilOperator(PaddedLayout):
    """Lattice-stencil operator: pattern-broadcast shifts + diag correction.

    ``pats``: (ndiags, p, p, p) periodic coefficient patterns (class order
    ``[iz%p, iy%p, ix%p]``).  ``taps``: static ((dx, dy, dz), ...) per
    diagonal.  ``corr``: (n_pad,) diagonal correction (0 on interior rows
    and padding).  ``dims`` = (mx, my, mz), node id ``ix + mx*(iy+my*iz)``.

    ``groups``/``group_const``/``const_vals``: taps grouped by *identical*
    coefficient pattern (host-detected at build).  Shifted windows of one
    group are summed BEFORE the coefficient multiply, and groups whose
    pattern is a constant multiply by a scalar — on the heat Laplacian this
    collapses 19 coefficient multiplies to 2-3 (e.g. 12 taps share one
    {0,-1} checker, 6 are constant -1, 1 is the diagonal).
    """

    pats: jax.Array
    const_vals: jax.Array  # (n_groups,) scalar per group (0 if non-const)
    corr: jax.Array
    taps: Tuple[Tuple[int, int, int], ...]
    groups: Tuple[Tuple[int, ...], ...]  # tap indices per group
    group_const: Tuple[bool, ...]
    dims: Tuple[int, int, int]
    period: int
    n_rows: int
    n_pad: int

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def dtype(self):
        return self.corr.dtype

    def matvec(self, x_padded: jax.Array) -> jax.Array:
        mx, my, mz = self.dims
        x3 = x_padded[: self.n_rows].reshape(mz, my, mx)
        y = stencil_core(
            x3, None, None, self.period, self.taps, self.groups,
            self.group_const, self.const_vals, self.pats, x_padded.dtype,
        ).reshape(-1)
        y = jnp.pad(y, (0, self.n_pad - self.n_rows))
        return y + self.corr.astype(x_padded.dtype) * x_padded

    def diagonal_padded(self, fill: float = 1.0) -> jax.Array:
        try:
            didx = self.taps.index((0, 0, 0))
        except ValueError:
            didx = None
        d = self.corr
        if didx is not None:
            mx, my, mz = self.dims
            p = self.period
            pat = self.pats[didx].astype(self.corr.dtype)
            c = pat[jnp.arange(mz) % p]
            c = c[:, jnp.arange(my) % p]
            c = c[:, :, jnp.arange(mx) % p]
            base = jnp.pad(c.reshape(-1), (0, self.n_pad - self.n_rows))
            d = d + base
        pad_mask = jnp.arange(self.n_pad) >= self.n_rows
        d = jnp.where(d == 0, jnp.asarray(fill, d.dtype), d)
        return jnp.where(pad_mask, jnp.asarray(fill, d.dtype), d)


def stencil_core(
    x3: jax.Array,
    z_lo: Optional[jax.Array],
    z_hi: Optional[jax.Array],
    period: int,
    taps,
    groups,
    group_const,
    const_vals: jax.Array,
    pats: jax.Array,
    dtype,
) -> jax.Array:
    """Pattern-grouped stencil application on a (mz, my, mx) grid block.

    ``z_lo``/``z_hi``: optional (my, mx) neighbor z-layers (halo strips
    from adjacent slabs in distributed runs); None means the global grid
    ends there (zero boundary, like the assembled operator's truncation).
    Returns the (mz, my, mx) product WITHOUT the diagonal correction.

    Layout notes: the block view keeps the fastest axis whole, the z/y
    parity axes are explicit, and the x-periodicity folds into a tiny
    tiled (p, p, Mx) strip — so coefficient fields of size n are never
    materialized.  Taps with identical patterns pre-sum their windows and
    constant patterns multiply by scalars (3 multiplies for the 19-tap
    heat stencil).
    """
    mz, my, mx = x3.shape
    p = period
    ex, ey, ez = (-mx) % p, (-my) % p, (-mz) % p
    Mx, My, Mz = mx + ex, my + ey, mz + ez
    lo = jnp.zeros((1, my, mx), x3.dtype) if z_lo is None else z_lo[None]
    hi = jnp.zeros((1, my, mx), x3.dtype) if z_hi is None else z_hi[None]
    xz = jnp.concatenate(
        [lo, x3, hi, jnp.zeros((ez, my, mx), x3.dtype)], axis=0
    )
    xe = jnp.pad(xz, ((0, 0), (1, 1 + ey), (1, 1 + ex)))
    shp5 = (Mz // p, p, My // p, p, Mx)
    terms = []
    for g, tap_idx in enumerate(groups):
        ws = []
        for d in tap_idx:
            dx, dy, dz = taps[d]
            ws.append(
                jax.lax.dynamic_slice(xe, (1 + dz, 1 + dy, 1 + dx), (Mz, My, Mx))
            )
        while len(ws) > 1:  # sum the group's windows BEFORE multiplying
            nx = [a + b for a, b in zip(ws[::2], ws[1::2])]
            if len(ws) % 2:
                nx.append(ws[-1])
            ws = nx
        W = ws[0]
        if group_const[g]:
            terms.append(const_vals[g].astype(dtype) * W)
        else:
            pat = pats[tap_idx[0]].astype(dtype)  # (p, p, p)
            strip = jnp.tile(pat, (1, 1, Mx // p))  # (p, p, Mx)
            terms.append(
                (W.reshape(shp5) * strip[None, :, None, :, :]).reshape(
                    Mz, My, Mx
                )
            )
    while len(terms) > 1:
        nxt = [a + b for a, b in zip(terms[::2], terms[1::2])]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0][:mz, :my, :mx]


def stencil_from_dia(
    dia: DIAMatrix, dims: Tuple[int, int, int], dtype=jnp.float32
) -> Optional[StencilOperator]:
    """Exact lattice-stencil decomposition of a DIA matrix, or None.

    Downloads the diagonal array from device; prefer
    :func:`stencil_from_packed` on the host-packed form when available
    (at 10M DOF this download is ~1.1 GB through the device link).
    """
    n = dia.n_rows
    data = np.asarray(dia.data.astype(jnp.float32))[:, :n]
    return stencil_from_packed(dia.offsets, data, n, dims, dtype=dtype)


def stencil_from_packed(
    offsets,
    data: np.ndarray,
    n: int,
    dims: Tuple[int, int, int],
    dtype=jnp.float32,
) -> Optional[StencilOperator]:
    """Exact lattice-stencil decomposition of host-packed diagonals
    (``offsets``, ``data (ndiags, >= n)``) to a device operator, or None."""
    parts = stencil_parts_from_packed(offsets, data, n, dims)
    if parts is None:
        return None
    return stencil_from_parts(parts, dtype=dtype)


def stencil_parts_from_packed(
    offsets,
    data: np.ndarray,
    n: int,
    dims: Tuple[int, int, int],
) -> Optional[dict]:
    """Exact lattice-stencil decomposition of host-packed diagonals into
    HOST arrays (no device transfer), or None.

    Verifies per-entry that every off-diagonal equals
    ``pattern[class(i), tap] * in_range(i, tap)`` and that the diagonal
    deviation is captured by the elementwise correction.  Tries period 1
    (constant stencil, e.g. HEX8 boxes) then period 2 (parity-alternating,
    e.g. 5-tet boxes).  Returned dict feeds :func:`stencil_from_parts` —
    the split keeps the big ``corr`` vector on the host until the final
    operator decides how to ship it.
    """
    mx, my, mz = (int(v) for v in dims)
    if mx * my * mz != n or min(mx, my, mz) < 7:
        return None
    taps = []
    for o in offsets:
        found = None
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            if dz * mx * my + dy * mx + dx == o:
                found = (dx, dy, dz)
                break
        if found is None:
            return None
        taps.append(found)
    if (0, 0, 0) not in taps:
        return None
    diag_idx = taps.index((0, 0, 0))

    data_full = np.ascontiguousarray(data, dtype=np.float32)
    data = data_full[:, :n]
    _lazy = {}

    def _idx():  # n-sized index arrays, only for the NumPy fallback
        if not _lazy:
            i = np.arange(n)
            _lazy["ix"] = i % mx
            r = i // mx
            _lazy["iy"] = r % my
            _lazy["iz"] = r // my
        return _lazy["ix"], _lazy["iy"], _lazy["iz"]

    from ..utils.native import stencil_verify_corr_native

    for period in (1, 2):
        p = period
        C = p * p * p
        # Class table from the analytic first-interior sample per class —
        # the lexicographically first i with 2 <= ix,iy,iz < m-2 and the
        # right parities (identical to the nonzero()-scan choice; the
        # min(m) >= 7 guard makes it always exist).
        stencil = np.empty((C, len(offsets)), dtype=np.float32)
        for c in range(C):
            pz, py_, px = c // (p * p), (c // p) % p, c % p
            sz = 2 + ((pz - 2) % p)
            sy = 2 + ((py_ - 2) % p)
            sx = 2 + ((px - 2) % p)
            stencil[c] = data[:, sx + mx * (sy + my * sz)]
        res = stencil_verify_corr_native(
            data_full, (mx, my, mz), p, taps, diag_idx, stencil
        )
        if res is not None:
            ok, corr = res
            if not ok:
                continue
        else:
            ix, iy, iz = _idx()
            cls = (iz % p) * p * p + (iy % p) * p + (ix % p)
            ok = True
            for d in range(len(taps)):
                if d == diag_idx:
                    continue
                dx, dy, dz = taps[d]
                in_range = (
                    (ix + dx >= 0) & (ix + dx < mx)
                    & (iy + dy >= 0) & (iy + dy < my)
                    & (iz + dz >= 0) & (iz + dz < mz)
                )
                if not np.array_equal(data[d], stencil[cls, d] * in_range):
                    ok = False
                    break
            if not ok:
                continue
            corr = data[diag_idx] - stencil[cls, diag_idx]
        pats = np.zeros((len(taps), p, p, p), dtype=np.float32)
        for c in range(C):
            pz, py_, px = c // (p * p), (c // p) % p, c % p
            pats[:, pz, py_, px] = stencil[c]
        n_pad = pad_to(max(n, 1))
        corr_pad = np.zeros(n_pad, dtype=np.float32)
        corr_pad[:n] = corr
        # Group taps by identical pattern; record constant-pattern scalars.
        by_pat = {}
        for d in range(len(taps)):
            by_pat.setdefault(pats[d].tobytes(), []).append(d)
        groups = tuple(tuple(v) for v in by_pat.values())
        group_const = tuple(
            bool(np.all(pats[g[0]] == pats[g[0]].ravel()[0])) for g in groups
        )
        const_vals = np.array(
            [
                pats[g[0]].ravel()[0] if c else 0.0
                for g, c in zip(groups, group_const)
            ],
            dtype=np.float32,
        )
        return dict(
            pats=pats,
            const_vals=const_vals,
            corr_pad=corr_pad,
            taps=tuple(taps),
            groups=groups,
            group_const=group_const,
            dims=(mx, my, mz),
            period=p,
            n_rows=n,
            n_pad=n_pad,
        )
    return None


def stencil_from_parts(parts: dict, dtype=jnp.float32) -> StencilOperator:
    """Host decomposition -> device :class:`StencilOperator`.

    The correction vector is nonzero only on grid-boundary rows (~3% of a
    10M box): when sparse enough it ships as (idx, val) pairs and
    scatters on device instead of a dense n-sized upload."""
    corr_pad = parts["corr_pad"]
    n_pad = parts["n_pad"]
    nz = np.flatnonzero(corr_pad)
    if nz.size < 0.25 * n_pad:
        corr_dev = (
            jnp.zeros(n_pad, jnp.dtype(dtype))
            .at[jnp.asarray(nz)]
            .set(jnp.asarray(corr_pad[nz].astype(np.dtype(dtype))))
        )
    else:
        corr_dev = jnp.asarray(corr_pad, jnp.dtype(dtype))
    return StencilOperator(
        pats=jnp.asarray(parts["pats"], jnp.dtype(dtype)),
        const_vals=jnp.asarray(parts["const_vals"], jnp.dtype(dtype)),
        corr=corr_dev,
        taps=parts["taps"],
        groups=parts["groups"],
        group_const=parts["group_const"],
        dims=parts["dims"],
        period=parts["period"],
        n_rows=parts["n_rows"],
        n_pad=n_pad,
    )


def stencil_from_csr(
    csr: CSRMatrix, dims: Tuple[int, int, int], dtype=jnp.float32
) -> Optional[StencilOperator]:
    dia = dia_from_csr(csr, dtype=dtype)
    if dia is None:
        return None
    return stencil_from_dia(dia, dims, dtype=dtype)

"""Slab-sharded DIA operators: banded domain decomposition over ICI.

For banded matrices (DIA-formatted structured meshes, or RCM-ordered
unstructured ones) the natural decomposition is **contiguous row slabs**:
every coupling stays within the bandwidth, so each device only talks to its
two neighbors.  The halo exchange is then two ``lax.ppermute`` shifts of an
H-wide strip — nearest-neighbor traffic only, no all-to-all — and the
local SpMV keeps the gather-free DIA form:

    x_ext = [left_halo | x_own | right_halo]          (2 ppermutes)
    y[i]  = sum_d data[d, i] * x_ext[H + i + off_d]   (static slices)

This is the multi-device engine for the 1M/10M-DOF structured configs
(BASELINE 5): per-device work is pure VPU streaming, per-step communication
volume is 2*H*4 bytes regardless of problem size.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.csr import CSRMatrix
from ..ops.dia import DIAMatrix, dia_from_csr
from ..solvers.cg import CGResult, cg_solve
from ..solvers.precond.jacobi import DiagonalPreconditioner
from .sharded import AXIS, _psum_dot, make_device_mesh

__all__ = ["SlabDIAPlan", "build_slab_plan", "SlabDIAOperator", "slab_cg_solve"]


@dataclasses.dataclass
class SlabDIAPlan:
    """Host-side description of a P-way contiguous slab split of a DIA matrix."""

    nparts: int
    n: int  # logical rows
    slab: int  # rows per device (padded)
    halo: int  # H >= max |offset|
    offsets: Tuple[int, ...]
    data: np.ndarray  # (P, ndiags, slab)

    def scatter_vector(self, x: np.ndarray, dtype=None) -> np.ndarray:
        out = np.zeros(
            (self.nparts, self.slab), dtype=x.dtype if dtype is None else dtype
        )
        flat = out.reshape(-1)
        flat[: self.n] = x
        return out

    def gather_vector(self, x_parts: np.ndarray) -> np.ndarray:
        return np.asarray(x_parts).reshape(-1)[: self.n]


def build_slab_plan(
    A: CSRMatrix | DIAMatrix, nparts: int, dtype=np.float32,
    row_align: int = 8,
) -> Optional[SlabDIAPlan]:
    """Build the slab plan; None if the matrix has no (small) DIA form.

    ``row_align``: slabs are padded to a multiple of this (set to ``mx*my``
    of a lexicographic grid so every slab is a whole number of z-layers —
    required by the two-level brick preconditioner in `slabbrick.py`)."""
    if isinstance(A, DIAMatrix):
        dia = A
        n = A.n_rows
        data_full = np.asarray(A.data)[:, :n]
    else:
        dia = dia_from_csr(A, dtype=dtype)
        if dia is None:
            return None
        n = A.n_rows
        data_full = np.asarray(dia.data)[:, :n]
    offsets = dia.offsets
    H = max(max(abs(o) for o in offsets), 1)
    H = ((H + 7) // 8) * 8
    slab = -(-n // nparts)
    slab = -(-slab // row_align) * row_align
    if slab < H:
        # Slabs thinner than the bandwidth would need beyond-neighbor
        # communication; refuse (caller falls back to the general path).
        return None
    data = np.zeros((nparts, len(offsets), slab), dtype=np.dtype(dtype))
    for p in range(nparts):
        lo = p * slab
        hi = min(lo + slab, n)
        if lo < n:
            data[p, :, : hi - lo] = data_full[:, lo:hi]
    return SlabDIAPlan(
        nparts=nparts, n=n, slab=slab, halo=H, offsets=offsets, data=data
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["offsets", "halo", "slab"],
)
@dataclasses.dataclass
class SlabDIAOperator:
    """Per-device slab block (used inside shard_map)."""

    data: jax.Array  # (ndiags, slab)
    offsets: Tuple[int, ...]
    halo: int
    slab: int

    def matvec(self, x_own: jax.Array) -> jax.Array:
        H, S = self.halo, self.slab
        nd = jax.lax.axis_size(AXIS)
        # Neighbor strips: device p receives p-1's last H (left) and p+1's
        # first H (right); ring edges contribute zeros.
        left = jax.lax.ppermute(
            x_own[S - H :], AXIS, [(i, i + 1) for i in range(nd - 1)]
        )
        right = jax.lax.ppermute(
            x_own[:H], AXIS, [(i + 1, i) for i in range(nd - 1)]
        )
        x_ext = jnp.concatenate([left, x_own, right])  # (S + 2H,)
        y = jnp.zeros_like(x_own)
        for d, off in enumerate(self.offsets):
            y = y + self.data[d] * jax.lax.dynamic_slice(
                x_ext, (H + off,), (S,)
            )
        return y


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["pats", "const_vals", "corr", "mask"],
    meta_fields=["taps", "groups", "group_const", "dims_local", "period"],
)
@dataclasses.dataclass
class SlabStencilOperator:
    """Per-device slab block of a lattice-stencil operator.

    The distributed counterpart of :class:`..ops.stencil.StencilOperator`:
    each device owns whole z-layers (``dims_local = (mx, my, mz_p)``), the
    halo is exactly ONE z-layer per neighbor (vs bandwidth-many rows for
    slab-DIA — the stencil's |dz| <= 1 makes the minimal halo explicit),
    and the local matvec is the same pattern-grouped form (coefficients
    broadcast from registers; measured 6.6x over DIA single-device).
    ``corr`` carries the diagonal correction rows of this slab; ``mask``
    zeroes padded rows past the global grid so dot products stay exact.
    """

    pats: jax.Array  # (ndiags, p, p, p)
    const_vals: jax.Array  # (n_groups,)
    corr: jax.Array  # (slab,)
    mask: jax.Array  # (slab,) 1.0 on real rows, 0.0 on padding
    taps: tuple
    groups: tuple
    group_const: tuple
    dims_local: Tuple[int, int, int]
    period: int

    @property
    def slab(self) -> int:
        mx, my, mz_p = self.dims_local
        return mx * my * mz_p

    def matvec(self, x_own: jax.Array) -> jax.Array:
        from ..ops.stencil import stencil_core

        mx, my, mz_p = self.dims_local
        layer = mx * my
        nd = jax.lax.axis_size(AXIS)
        # One-z-layer halo strips from the ring neighbors (edges get zeros,
        # matching the global operator's truncation at the grid boundary).
        lo = jax.lax.ppermute(
            x_own[self.slab - layer :], AXIS, [(i, i + 1) for i in range(nd - 1)]
        ).reshape(my, mx)
        hi = jax.lax.ppermute(
            x_own[:layer], AXIS, [(i + 1, i) for i in range(nd - 1)]
        ).reshape(my, mx)
        x3 = x_own.reshape(mz_p, my, mx)
        y = stencil_core(
            x3, lo, hi, self.period, self.taps, self.groups,
            self.group_const, self.const_vals, self.pats, x_own.dtype,
        ).reshape(-1)
        return self.mask * (y + self.corr * x_own)


def build_slab_stencil(S, nparts: int, row_align_layers: int = 1):
    """Split a :class:`..ops.stencil.StencilOperator` into P z-layer slabs.

    Returns ``(dims_local, corr (P, slab), mask (P, slab), stencil_meta)``
    or None when the z-extent cannot be split into aligned whole-layer
    slabs.  ``row_align_layers``: each slab's layer count is a multiple of
    this (and of the stencil period)."""
    mx, my, mz = S.dims
    p = S.period
    align = int(np.lcm(row_align_layers, p))
    mz_p = -(-mz // nparts)
    mz_p = -(-mz_p // align) * align
    if mz_p < 2:  # a slab must cover more than the halo depth
        return None
    layer = mx * my
    slab = layer * mz_p
    n = S.n_rows
    corr_full = np.zeros(nparts * slab, dtype=np.float32)
    corr_full[:n] = np.asarray(S.corr)[:n]
    mask_full = np.zeros(nparts * slab, dtype=np.float32)
    mask_full[:n] = 1.0
    meta = dict(
        taps=S.taps, groups=S.groups, group_const=S.group_const,
        dims_local=(mx, my, mz_p), period=p,
    )
    return (
        (mx, my, mz_p),
        corr_full.reshape(nparts, slab),
        mask_full.reshape(nparts, slab),
        meta,
    )


def slab_stencil_cg_solve(
    S,
    nparts: int,
    b: np.ndarray,
    x0: np.ndarray,
    *,
    mesh: Optional[Mesh] = None,
    tol: float = 1e-12,
    maxiter: int = 1000,
    jacobi: bool = True,
):
    """Distributed CG over z-layer slabs of a lattice-stencil operator.

    Same contract as :func:`slab_cg_solve` but the per-device matvec is the
    pattern-broadcast stencil form with one-z-layer ppermute halos.
    Returns (x_host, CGResult-shaped scalars) or None if the operator
    cannot be layer-slabbed.
    """
    built = build_slab_stencil(S, nparts)
    if built is None:
        return None
    dims_local, corr_p, mask_p, meta = built
    slab = corr_p.shape[1]
    n = S.n_rows

    dev_mesh = mesh if mesh is not None else make_device_mesh(nparts)
    sh = NamedSharding(dev_mesh, P(AXIS))
    rep = NamedSharding(dev_mesh, P())

    def scatter(v):
        out = np.zeros((nparts, slab), dtype=np.float32)
        out.reshape(-1)[:n] = v
        return jax.device_put(out, sh)

    d = np.asarray(S.diagonal_padded(fill=1.0))[:n]
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)

    corr_s = jax.device_put(corr_p, sh)
    mask_s = jax.device_put(mask_p, sh)
    b_s = scatter(np.asarray(b, np.float32))
    x0_s = scatter(np.asarray(x0, np.float32))
    invd_s = scatter(inv_d.astype(np.float32))
    pats = jax.device_put(jnp.asarray(S.pats, jnp.float32), rep)
    cvals = jax.device_put(jnp.asarray(S.const_vals, jnp.float32), rep)

    from ..solvers.cg import CGResult, cg_solve
    from ..solvers.precond.jacobi import DiagonalPreconditioner
    from .sharded import _psum_dot

    def body(corr_blk, mask_blk, b_blk, x_blk, invd_blk, pats_arg, cvals_arg):
        op = SlabStencilOperator(
            pats=pats_arg, const_vals=cvals_arg, corr=corr_blk[0],
            mask=mask_blk[0], **meta,
        )
        M = DiagonalPreconditioner(invd_blk[0]) if jacobi else None
        res = cg_solve(
            op, b_blk[0], x_blk[0], precond=M, tol=tol, maxiter=maxiter,
            dot=_psum_dot,
        )
        return res.x[None], res.iterations, res.relres, res.converged

    fn = jax.shard_map(
        body,
        mesh=dev_mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P()),
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=True,
    )
    x_s, iters, relres, conv = fn(
        corr_s, mask_s, b_s, x0_s, invd_s, pats, cvals
    )
    x = np.asarray(x_s).reshape(-1)[:n]
    return x, CGResult(x=x_s, iterations=iters, relres=relres, converged=conv)


def slab_cg_solve(
    plan: SlabDIAPlan,
    b: np.ndarray,
    x0: np.ndarray,
    *,
    mesh: Optional[Mesh] = None,
    tol: float = 1e-12,
    maxiter: int = 1000,
    jacobi: bool = True,
    brick_precond=None,
):
    """Distributed CG over the slab decomposition: one SPMD program.

    ``brick_precond``: an optional `slabbrick.SlabBrickPrecond` — each
    device then preconditions with its communication-free two-level brick
    cycle instead of Jacobi.  Returns (x_host, CGResult-shaped scalars).
    """
    dev_mesh = mesh if mesh is not None else make_device_mesh(plan.nparts)
    sh = NamedSharding(dev_mesh, P(AXIS))
    data = jax.device_put(plan.data, sh)
    b_s = jax.device_put(plan.scatter_vector(b, dtype=plan.data.dtype), sh)
    x0_s = jax.device_put(plan.scatter_vector(x0, dtype=plan.data.dtype), sh)
    offsets, halo, slab = plan.offsets, plan.halo, plan.slab
    bp = brick_precond
    ci = jax.device_put(bp.coarse_inv, sh) if bp is not None else None
    idg = jax.device_put(bp.inv_diag, sh) if bp is not None else None

    def body(data_blk, b_blk, x_blk, ci_blk, id_blk):
        op = SlabDIAOperator(
            data=data_blk[0], offsets=offsets, halo=halo, slab=slab
        )
        if bp is not None:
            M = bp.block(data_blk[0], ci_blk[0], id_blk[0])
        elif jacobi:
            if 0 in offsets:
                d = data_blk[0][offsets.index(0)]
            else:
                d = jnp.ones_like(b_blk[0])
            inv = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 1.0)
            M = DiagonalPreconditioner(inv)
        else:
            M = None
        res = cg_solve(
            op, b_blk[0], x_blk[0], precond=M, tol=tol, maxiter=maxiter,
            dot=_psum_dot,
        )
        return res.x[None], res.iterations, res.relres, res.converged

    if bp is None:
        # Keep the arity static for shard_map: dummy replicated scalars.
        ci = jnp.zeros((plan.nparts, 1, 1), data.dtype)
        idg = jnp.zeros((plan.nparts, 1), data.dtype)
        ci = jax.device_put(ci, sh)
        idg = jax.device_put(idg, sh)

    fn = jax.shard_map(
        body,
        mesh=dev_mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=True,
    )
    x_s, iters, relres, conv = fn(data, b_s, x0_s, ci, idg)
    return plan.gather_vector(np.asarray(x_s)), CGResult(
        x=x_s, iterations=iters, relres=relres, converged=conv
    )

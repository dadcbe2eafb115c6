"""Distributed (sharded) SA-AMG over slab decompositions.

True distributed multigrid — the rung above the communication-free
block-Schwarz cycles (:mod:`.schwarz`, :mod:`.slabbrick`): here the
preconditioner applies the *global* AMG hierarchy, so CG iteration counts
are P-independent by construction (they match the single-device hierarchy
exactly, up to psum reduction rounding).  This is the role MueLu was meant
to play in the reference (``BelosMueLuSolver.cpp:11``).

Layout (one SPMD program under ``shard_map``):

- **Fine level sharded.**  The level-0 DIA operator is slab-split
  (:mod:`.slab`): matvecs exchange two ``ppermute`` halo strips.  Chebyshev
  smoothing is the same algebra as the single-device cycle with the halo
  matvec inside.
- **Transfers local.**  Slabs are aligned to whole ``brick`` z-layers
  (``row_align = mx*my*brick``), so the brick tentative transfer
  (reshape/repeat — :class:`..solvers.precond.amg.BrickProlongator`) never
  crosses a slab boundary; the smoothing half of P/R is one fine-level halo
  matvec.  Restriction therefore costs exactly one ``all_gather`` of the
  coarse slab (the only collective beyond halos).
- **Coarse tail replicated.**  Levels 1+ are tiny (49k rows at 10M DOF);
  every device runs the identical coarse V-cycle redundantly — the
  standard redundant-coarse-solve strategy: those levels are
  latency-bound and replication deletes all their communication.

Setup reuses :func:`..solvers.precond.amg.smoothed_aggregation_setup` for
the global hierarchy, then shards level 0.
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
from ..solvers.cg import CGResult, cg_solve
from ..solvers.precond.amg import (
    AMGPreconditioner,
    BrickProlongator,
    smoothed_aggregation_setup,
)
from .sharded import AXIS, _psum_dot, make_device_mesh
from .slab import SlabDIAOperator, SlabDIAPlan, build_slab_plan

__all__ = ["SlabAMG", "build_slab_amg", "slab_amg_cg_solve"]


@dataclasses.dataclass
class SlabAMG:
    """Host-side bundle: slab plan + sharded level-0 pieces + replicated tail."""

    plan: SlabDIAPlan
    dims_local: Tuple[int, int, int]  # (mx, my, mz_p) per-device fine grid
    brick: int
    tval: np.ndarray  # (P, slab) tentative weights per device
    scale: np.ndarray  # (P, slab) omega/lmax/diag per device
    inv_diag: np.ndarray  # (P, slab)
    lmax: float
    smooth_steps: int
    tail: AMGPreconditioner  # replicated levels 1+ (tiny)
    n_c: int  # true coarse rows
    n_pad_c: int  # tail's padded vector length
    # Optional pattern-stencil form of the fine level (6.6x the DIA matvec;
    # one-z-layer halos): corr/mask are (P, slab), meta is the static
    # SlabStencilOperator metadata.  None -> slab-DIA fine level.
    st_corr: Optional[np.ndarray] = None
    st_mask: Optional[np.ndarray] = None
    st_pats: Optional[np.ndarray] = None
    st_cvals: Optional[np.ndarray] = None
    st_meta: Optional[dict] = None

    @property
    def slab_c(self) -> int:
        mx, my, mz_p = self.dims_local
        b = self.brick
        return (mx // b if mx % b == 0 else -(-mx // b)) * (
            my // b if my % b == 0 else -(-my // b)
        ) * (mz_p // b)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["A", "tval", "scale", "inv_diag", "lmax", "tail"],
    meta_fields=["dims_local", "brick", "slab_c", "n_c", "n_pad_c", "smooth_steps"],
)
@dataclasses.dataclass
class _SlabAMGBlock:
    """Per-device callable pytree (lives inside shard_map)."""

    A: SlabDIAOperator
    tval: jax.Array  # (slab,)
    scale: jax.Array  # (slab,)
    inv_diag: jax.Array  # (slab,)
    lmax: jax.Array  # scalar
    tail: AMGPreconditioner  # replicated
    dims_local: Tuple[int, int, int]
    brick: int
    slab_c: int
    n_c: int
    n_pad_c: int
    smooth_steps: int

    # -- local brick tentative transfer (pure reshapes) ------------------
    def _t_apply(self, x_c_loc: jax.Array) -> jax.Array:
        mx, my, mz = self.dims_local
        b = self.brick
        ncx, ncy, ncz = -(-mx // b), -(-my // b), mz // b
        z = x_c_loc[: ncx * ncy * ncz].reshape(ncz, ncy, ncx)
        z = jnp.repeat(z, b, axis=0)[:mz]
        z = jnp.repeat(z, b, axis=1)[:, :my]
        z = jnp.repeat(z, b, axis=2)[:, :, :mx]
        return self.tval * z.reshape(-1)

    def _t_transpose(self, w: jax.Array) -> jax.Array:
        mx, my, mz = self.dims_local
        b = self.brick
        ncx, ncy, ncz = -(-mx // b), -(-my // b), mz // b
        tw = (self.tval * w).reshape(mz, my, mx)
        tw = jnp.pad(tw, ((0, 0), (0, ncy * b - my), (0, ncx * b - mx)))
        c = tw.reshape(ncz, b, ncy, b, ncx, b).sum(axis=(1, 3, 5))
        return c.reshape(-1)  # (slab_c,)

    # -- smoothed transfers (one halo matvec each) -----------------------
    def _p_apply(self, x_c_loc: jax.Array) -> jax.Array:
        t = self._t_apply(x_c_loc)
        return t - self.scale * self.A.matvec(t)

    def _r_apply(self, w: jax.Array) -> jax.Array:
        s = w - self.A.matvec(self.scale * w)
        return self._t_transpose(s)

    # -- shared Chebyshev smoother, same algebra as AMGPreconditioner --
    def _smooth(self, x: jax.Array, b: jax.Array, x_zero: bool = False):
        from ..solvers.precond.cheby import chebyshev_smooth

        return chebyshev_smooth(
            self.A.matvec, self.inv_diag, self.lmax, self.smooth_steps,
            x, b, x_zero=x_zero,
        )

    def __call__(self, r: jax.Array) -> jax.Array:
        """One global V-cycle on the slab-sharded fine level."""
        x = self._smooth(jnp.zeros_like(r), r, x_zero=True)
        r_c_loc = self._r_apply(r - self.A.matvec(x))  # (slab_c,)
        # The only non-neighbor collective: gather the coarse residual.
        nd = jax.lax.axis_size(AXIS)
        r_c_full = jax.lax.all_gather(r_c_loc, AXIS).reshape(-1)  # (P*slab_c,)
        G = nd * self.slab_c
        if G >= self.n_pad_c:
            r_c = r_c_full[: self.n_pad_c]
        else:
            r_c = jnp.pad(r_c_full, (0, self.n_pad_c - G))
        # Trailing padded coarse slots must be zero for the tail cycle.
        mask = jnp.arange(self.n_pad_c) < self.n_c
        r_c = jnp.where(mask, r_c, 0.0)
        x_c = self.tail(r_c)  # replicated coarse hierarchy (identical/dev)
        if G > self.n_pad_c:
            x_c = jnp.pad(x_c, (0, G - self.n_pad_c))
        p = jax.lax.axis_index(AXIS)
        x_c_loc = jax.lax.dynamic_slice(x_c, (p * self.slab_c,), (self.slab_c,))
        x = x + self._p_apply(x_c_loc)
        return self._smooth(x, r)


def build_slab_amg(
    A: CSRMatrix,
    grid_dims: Tuple[int, int, int],
    nparts: int,
    *,
    brick: int = 6,
    dtype=np.float32,
    **amg_kwargs,
) -> Optional[SlabAMG]:
    """Build the distributed hierarchy; None when the problem doesn't fit
    the slab-brick layout (unstructured fine level, slabs thinner than the
    bandwidth, or z-extent not splittable into whole bricks)."""
    mx, my, mz = (int(v) for v in grid_dims)
    if mx * my * mz != A.n_rows:
        return None
    M = smoothed_aggregation_setup(
        A, dtype=dtype, grid_dims=grid_dims, brick=brick, **amg_kwargs
    )
    if not M.levels:
        return None
    lvl0 = M.levels[0]
    if not isinstance(lvl0.P, BrickProlongator):
        return None  # hierarchy didn't take the brick path
    plan = build_slab_plan(A, nparts, dtype=dtype, row_align=mx * my * brick)
    if plan is None:
        return None
    mz_p = plan.slab // (mx * my)
    if mz_p % brick != 0 or plan.slab % (mx * my) != 0:
        return None

    n = A.n_rows
    d = np.asarray(_diag_of(A))
    d = np.where(d != 0, d, 1.0)
    lmax = float(np.asarray(lvl0.lmax))
    omega_over = np.asarray(lvl0.P.scale)  # (n_pad_f,) = omega/lmax/diag
    tval_full = np.asarray(lvl0.P.tval)

    def _split(v):
        out = np.zeros((plan.nparts, plan.slab), dtype=np.dtype(dtype))
        flat = out.reshape(-1)
        flat[:n] = v[:n]
        return out

    inv_diag_full = np.zeros(n, dtype=np.float64)
    inv_diag_full[:] = 1.0 / d
    tail = AMGPreconditioner(
        levels=list(M.levels[1:]),
        coarse_inv=M.coarse_inv,
        smoother=M.smoother,
        smooth_steps=M.smooth_steps,
    )
    n_pad_c = (
        int(M.levels[1].A.n_pad)
        if len(M.levels) > 1
        else int(M.coarse_inv.shape[-1])
    )
    b_ = brick
    ncx, ncy = -(-mx // b_), -(-my // b_)
    n_c = ncx * ncy * (-(-mz // b_))
    # Pattern-stencil fine level (when the hierarchy's level-0 operator
    # decomposed): split the diagonal correction into the same z-layer
    # slabs; the pattern metadata is replicated.
    from ..ops.stencil import StencilOperator

    st = lvl0.A if isinstance(lvl0.A, StencilOperator) else None
    st_kw = {}
    if st is not None and mz_p % st.period == 0:
        layer = mx * my
        slab_rows = plan.slab
        corr_full = np.zeros(nparts * slab_rows, dtype=np.float32)
        corr_full[:n] = np.asarray(st.corr)[:n]
        mask_full = np.zeros(nparts * slab_rows, dtype=np.float32)
        mask_full[:n] = 1.0
        st_kw = dict(
            st_corr=corr_full.reshape(nparts, slab_rows),
            st_mask=mask_full.reshape(nparts, slab_rows),
            st_pats=np.asarray(st.pats, np.float32),
            st_cvals=np.asarray(st.const_vals, np.float32),
            st_meta=dict(
                taps=st.taps, groups=st.groups,
                group_const=st.group_const,
                dims_local=(mx, my, mz_p), period=st.period,
            ),
        )
    return SlabAMG(
        **st_kw,
        plan=plan,
        dims_local=(mx, my, mz_p),
        brick=brick,
        tval=_split(tval_full),
        scale=_split(omega_over),
        inv_diag=_split(inv_diag_full),
        lmax=lmax,
        smooth_steps=M.smooth_steps,
        tail=tail,
        n_c=n_c,
        n_pad_c=n_pad_c,
    )


def _diag_of(A: CSRMatrix) -> np.ndarray:
    return A.diagonal()


def slab_amg_cg_solve(
    samg: SlabAMG,
    b: np.ndarray,
    x0: np.ndarray,
    *,
    mesh: Optional[Mesh] = None,
    tol: float = 1e-12,
    maxiter: int = 300,
):
    """Distributed CG preconditioned by the sharded global AMG hierarchy.

    Same contract as :func:`.slab.slab_cg_solve`; returns (x_host, result).
    """
    plan = samg.plan
    dev_mesh = mesh if mesh is not None else make_device_mesh(plan.nparts)
    sh = NamedSharding(dev_mesh, P(AXIS))
    rep = NamedSharding(dev_mesh, P())
    # Vector/compute dtype of the hierarchy as BUILT (f32 default, f64 when
    # build_slab_amg(dtype=float64)) — hardcoding f32 here silently
    # downgraded f64 solves and mixed dtypes with plan.data.
    vdt = np.asarray(samg.tval).dtype
    use_st = samg.st_meta is not None
    if use_st:
        # Pattern-stencil fine level: corr/mask sharded, patterns replicated.
        data = jax.device_put(samg.st_corr, sh)
        mask = jax.device_put(samg.st_mask, sh)
        pats = jax.device_put(jnp.asarray(samg.st_pats), rep)
        cvals = jax.device_put(jnp.asarray(samg.st_cvals), rep)
    else:
        data = jax.device_put(plan.data, sh)
        mask = jax.device_put(
            np.zeros((plan.nparts, 1), dtype=plan.data.dtype), sh
        )
        pats = jax.device_put(jnp.zeros((1, 1, 1, 1), jnp.dtype(vdt)), rep)
        cvals = jax.device_put(jnp.zeros((1,), jnp.dtype(vdt)), rep)
    b_s = jax.device_put(plan.scatter_vector(b, dtype=vdt), sh)
    x0_s = jax.device_put(plan.scatter_vector(x0, dtype=vdt), sh)
    tval = jax.device_put(samg.tval, sh)
    scale = jax.device_put(samg.scale, sh)
    inv_d = jax.device_put(samg.inv_diag, sh)
    tail = jax.device_put(samg.tail, rep)
    offsets, halo, slab = plan.offsets, plan.halo, plan.slab
    st_meta = samg.st_meta
    meta = dict(
        dims_local=samg.dims_local,
        brick=samg.brick,
        slab_c=samg.slab_c,
        n_c=samg.n_c,
        n_pad_c=samg.n_pad_c,
        smooth_steps=samg.smooth_steps,
    )
    lmax = samg.lmax

    def body(data_blk, mask_blk, b_blk, x_blk, tval_blk, scale_blk,
             invd_blk, pats_arg, cvals_arg, tail_arg):
        if use_st:
            from .slab import SlabStencilOperator

            op = SlabStencilOperator(
                pats=pats_arg, const_vals=cvals_arg, corr=data_blk[0],
                mask=mask_blk[0], **st_meta,
            )
        else:
            op = SlabDIAOperator(
                data=data_blk[0], offsets=offsets, halo=halo, slab=slab
            )
        M = _SlabAMGBlock(
            A=op,
            tval=tval_blk[0],
            scale=scale_blk[0],
            inv_diag=invd_blk[0],
            lmax=jnp.asarray(lmax, jnp.dtype(vdt)),
            tail=tail_arg,
            **meta,
        )
        res = cg_solve(
            op, b_blk[0], x_blk[0], precond=M, tol=tol, maxiter=maxiter,
            dot=_psum_dot,
        )
        return res.x[None], res.iterations, res.relres, res.converged

    fn = jax.shard_map(
        body,
        mesh=dev_mesh,
        in_specs=(
            P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
            P(), P(), P(),
        ),
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=True,
    )
    x_s, iters, relres, conv = fn(
        data, mask, b_s, x0_s, tval, scale, inv_d, pats, cvals, tail
    )
    return plan.gather_vector(np.asarray(x_s)), CGResult(
        x=x_s, iterations=iters, relres=relres, converged=conv
    )

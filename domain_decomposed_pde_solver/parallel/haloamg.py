"""Distributed (sharded) global SA-AMG over general halo partitions.

The unstructured counterpart of :mod:`.slabamg`: the preconditioner applies
the GLOBAL greedy-aggregation hierarchy over an arbitrary graph partition
(the halo plans of :mod:`.halo`), so CG iteration counts are P-independent
— the same algebra as the single-device hierarchy, just laid out across
devices.  This is the role MueLu was meant to fill in the reference
(``BelosMueLuSolver.cpp:11``) on its actual workload class (unstructured
tet meshes, ``tet-cube-heat.exo``).

Layout (one SPMD program under ``shard_map``):

- **Fine level sharded** over the halo partition: smoothing matvecs are
  the operator's halo-exchange SpMV (ELL local blocks).
- **Factored transfers with a psum restriction.**  The smoothed
  prolongator ``P = (I - s D^-1 A) T`` is applied in factored form: the
  tentative half is a per-device segment-sum into the GLOBAL coarse
  numbering followed by one ``psum`` of the (small) coarse vector — the
  only non-halo collective — and a per-device gather back.
- **Coarse tail replicated**: levels 1+ run redundantly on every device
  (tiny; latency-bound — replication deletes their communication).

Setup reuses :func:`..solvers.precond.amg.smoothed_aggregation_setup`
(via its ``level_info_out`` hook) so the distributed hierarchy is exactly
the single-device one.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.csr import CSRMatrix
from ..solvers.cg import CGResult, cg_solve
from ..solvers.precond.amg import AMGPreconditioner, smoothed_aggregation_setup
from .halo import HaloPlan
from .sharded import AXIS, _psum_dot

__all__ = ["HaloAMG", "build_halo_amg", "halo_amg_cg_solve"]


@dataclasses.dataclass
class HaloAMG:
    """Host-side bundle: per-part level-0 pieces + replicated coarse tail."""

    plan: HaloPlan
    agg: np.ndarray  # (P, n_local) int32 — global coarse id per local row
    tval: np.ndarray  # (P, n_local)
    scale: np.ndarray  # (P, n_local)
    inv_diag: np.ndarray  # (P, n_local)
    lmax: float
    smooth_steps: int
    tail: AMGPreconditioner
    n_c: int
    n_pad_c: int


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["A", "agg", "tval", "scale", "inv_diag", "lmax", "tail"],
    meta_fields=["n_c", "n_pad_c", "smooth_steps"],
)
@dataclasses.dataclass
class _HaloAMGBlock:
    """Per-device callable pytree (lives inside shard_map)."""

    A: object  # halo-exchange local operator (.matvec)
    agg: jax.Array  # (n_local,) int32 global coarse ids (0 on padding)
    tval: jax.Array  # (n_local,) tentative weight (0 on padding)
    scale: jax.Array  # (n_local,) omega/lmax/diag (0 on padding)
    inv_diag: jax.Array  # (n_local,)
    lmax: jax.Array  # scalar
    tail: AMGPreconditioner  # replicated
    n_c: int
    n_pad_c: int
    smooth_steps: int

    def _r_apply(self, w: jax.Array) -> jax.Array:
        """R w -> replicated (n_pad_c,) coarse vector (one psum)."""
        s = w - self.A.matvec(self.scale * w)
        part = jax.ops.segment_sum(
            self.tval * s, self.agg, num_segments=self.n_pad_c
        )
        return jax.lax.psum(part, AXIS)

    def _p_apply(self, x_c: jax.Array) -> jax.Array:
        """P x_c for a replicated coarse vector -> local fine vector."""
        t = self.tval * jnp.take(x_c, self.agg, axis=0)
        return t - self.scale * self.A.matvec(t)

    def _smooth(self, x: jax.Array, b: jax.Array, x_zero: bool = False):
        # The shared Chebyshev smoother (solvers/precond/cheby.py) — the
        # same algebra as the single-device AMGPreconditioner._smooth, so
        # iteration counts stay P-independent by construction.
        from ..solvers.precond.cheby import chebyshev_smooth

        return chebyshev_smooth(
            self.A.matvec, self.inv_diag, self.lmax, self.smooth_steps,
            x, b, x_zero=x_zero,
        )

    def __call__(self, r: jax.Array) -> jax.Array:
        x = self._smooth(jnp.zeros_like(r), r, x_zero=True)
        r_c = self._r_apply(r - self.A.matvec(x))
        mask = jnp.arange(self.n_pad_c) < self.n_c
        r_c = jnp.where(mask, r_c, 0.0)
        x_c = self.tail(r_c)  # replicated coarse cycle — identical per dev
        x = x + self._p_apply(x_c)
        return self._smooth(x, r)


def build_halo_amg(
    A: CSRMatrix,
    plan: HaloPlan,
    *,
    dtype=np.float32,
    **amg_kwargs,
) -> Optional[HaloAMG]:
    """Build the distributed hierarchy over an existing halo plan."""
    info: list = []
    M = smoothed_aggregation_setup(
        A, dtype=dtype, level_info_out=info, **amg_kwargs
    )
    if not M.levels or not info:
        return None
    lv = info[0]
    agg = lv["agg"]
    counts = lv["counts"]
    d = lv["d"]
    lmax = lv["lmax"]
    omega = lv["omega"]
    n_c = int(agg.max()) + 1 if agg.size else 0
    n_pad_c = (
        int(M.levels[1].A.n_pad)
        if len(M.levels) > 1
        else int(M.coarse_inv.shape[-1])
    )
    tail = AMGPreconditioner(
        levels=list(M.levels[1:]),
        coarse_inv=M.coarse_inv,
        smoother=M.smoother,
        smooth_steps=M.smooth_steps,
    )
    tval_g = (1.0 / np.sqrt(counts))[agg]
    scale_g = (omega / lmax) / d
    inv_d_g = 1.0 / d

    agg_p = np.zeros((plan.nparts, plan.n_local), dtype=np.int32)
    agg_p[plan.part_of_row, plan.local_of_row] = agg
    return HaloAMG(
        plan=plan,
        agg=agg_p,
        tval=plan.scatter_vector(tval_g, dtype=np.float32),
        scale=plan.scatter_vector(scale_g, dtype=np.float32),
        inv_diag=plan.scatter_vector(inv_d_g, dtype=np.float32),
        lmax=float(lmax),
        smooth_steps=M.smooth_steps,
        tail=tail,
        n_c=n_c,
        n_pad_c=n_pad_c,
    )


def halo_amg_cg_solve(
    op,
    hamg: HaloAMG,
    b_host: np.ndarray,
    x0_host: np.ndarray,
    *,
    tol: float = 1e-12,
    maxiter: int = 300,
):
    """Distributed CG preconditioned by the sharded global hierarchy.

    ``op``: a :class:`.sharded.ShardedOperator` (ELL local blocks)
    built from the SAME plan.  Returns (x_host, result).
    """
    sh = NamedSharding(op.mesh, P(AXIS))
    rep = NamedSharding(op.mesh, P())
    b = op.put_vector(b_host)
    x0 = op.put_vector(x0_host)
    agg = jax.device_put(hamg.agg, sh)
    tval = jax.device_put(hamg.tval, sh)
    scale = jax.device_put(hamg.scale, sh)
    inv_d = jax.device_put(hamg.inv_diag, sh)
    tail = jax.device_put(hamg.tail, rep)
    meta = dict(
        n_c=hamg.n_c, n_pad_c=hamg.n_pad_c, smooth_steps=hamg.smooth_steps
    )
    lmax = hamg.lmax
    make_block = type(op).make_block

    def body(leaves, b_blk, x_blk, agg_blk, tval_blk, scale_blk, invd_blk,
             tail_arg):
        blk = make_block(op, jax.tree_util.tree_map(lambda a: a[0], leaves))
        M = _HaloAMGBlock(
            A=blk,
            agg=agg_blk[0],
            tval=tval_blk[0],
            scale=scale_blk[0],
            inv_diag=invd_blk[0],
            lmax=jnp.asarray(lmax, jnp.float32),
            tail=tail_arg,
            **meta,
        )
        res = cg_solve(
            blk, b_blk[0], x_blk[0], precond=M, tol=tol, maxiter=maxiter,
            dot=_psum_dot,
        )
        return res.x[None], res.iterations, res.relres, res.converged

    fn = jax.shard_map(
        body,
        mesh=op.mesh,
        in_specs=(P(AXIS),) * 7 + (P(),),
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=True,
    )
    x_s, iters, relres, conv = fn(
        op.block_leaves(), b, x0, agg, tval, scale, inv_d, tail
    )
    return op.get_vector(x_s), CGResult(
        x=x_s, iterations=iters, relres=relres, converged=conv
    )

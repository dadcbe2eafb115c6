"""Two-level brick-Schwarz preconditioner for slab-sharded structured grids.

The distributed-AMG rung for the slab decomposition (`parallel/slab.py`):
contiguous z-layer slabs of a lexicographic grid are themselves grids, so
every device can run a gather-free two-level cycle on its own slab block
with ZERO communication in the preconditioner (CG's psum dots remain the
only collectives):

    M r = S(r) + T A_c^{-1} T^T (r - A_loc S(r)) ... symmetrized V(1,1)

- smoother S: Chebyshev on the local diagonal block (the slab DIA matvec
  with zero halo = the block-Jacobi operator, no ppermute);
- T / T^T: geometric brick aggregation applied as reshape + repeat /
  reshape + block-sum (the :class:`..solvers.precond.amg.BrickProlongator`
  trick, per slab);
- coarse solve: per-slab dense inverse applied as a matmul at full
  precision.

Replaces nothing in the reference (it has no multilevel preconditioner at
all, ``BelosMueLuSolver.cpp:11``); this is the JAX composition of
block-Schwarz (`parallel/schwarz.py`) with the structured-grid transfers.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .slab import SlabDIAPlan

__all__ = ["SlabBrickPrecond", "SlabBrickBlock", "build_slab_brick_precond"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "coarse_inv", "inv_diag", "acc_inv"],
    meta_fields=[
        "offsets", "slab", "local_dims", "brick", "smooth_steps",
        "use_global",
    ],
)
@dataclasses.dataclass
class SlabBrickBlock:
    """One device's slab block of the two-level cycle (a CG preconditioner
    pytree: ``__call__(r)`` applies the cycle; the only collective is one
    scalar ``all_gather`` when the global slab-mean coarse level is on)."""

    data: jax.Array  # (ndiags, slab) local DIA data
    coarse_inv: jax.Array  # (nc, nc) dense inverse of T^T A_loc T
    inv_diag: jax.Array  # (slab,) 1/diag of the local block
    acc_inv: jax.Array  # (P, P) inverse of the slab-mean coarse operator
    offsets: Tuple[int, ...]
    slab: int
    local_dims: Tuple[int, int, int]  # (mx, my, mz_local)
    brick: int
    smooth_steps: int = 2
    use_global: bool = False

    @property
    def coarse_dims(self) -> Tuple[int, int, int]:
        b = self.brick
        mx, my, mz = self.local_dims
        return (-(-mx // b), -(-my // b), -(-mz // b))

    def _matvec_local(self, x):
        """Block-diagonal matvec: the slab DIA form with ZERO halo, which
        exactly drops couplings crossing the slab boundary."""
        S = self.slab
        h = max(max(abs(o) for o in self.offsets), 1)
        x_ext = jnp.pad(x, (h, h))
        y = jnp.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self.data[d].astype(x.dtype) * jax.lax.dynamic_slice(
                x_ext, (h + off,), (S,)
            )
        return y

    def _t_apply(self, xc):
        mx, my, mz = self.local_dims
        ncx, ncy, ncz = self.coarse_dims
        b = self.brick
        z = xc.reshape(ncz, ncy, ncx)
        z = jnp.repeat(z, b, axis=0)[:mz]
        z = jnp.repeat(z, b, axis=1)[:, :my]
        z = jnp.repeat(z, b, axis=2)[:, :, :mx]
        return z.reshape(-1)

    def _t_transpose(self, w):
        mx, my, mz = self.local_dims
        ncx, ncy, ncz = self.coarse_dims
        b = self.brick
        t = w.reshape(mz, my, mx)
        t = jnp.pad(
            t, ((0, ncz * b - mz), (0, ncy * b - my), (0, ncx * b - mx))
        )
        return t.reshape(ncz, b, ncy, b, ncx, b).sum(axis=(1, 3, 5)).reshape(-1)

    def _smooth(self, x, r, x_zero: bool = False):
        """Shared Chebyshev smoother over D^-1 A_loc with the Gershgorin
        bound lmax=2 (exact for normalized graph Laplacians; local
        sub-Laplacians only shrink it)."""
        from ..solvers.precond.cheby import chebyshev_smooth

        return chebyshev_smooth(
            self._matvec_local, self.inv_diag, 2.0, self.smooth_steps,
            x, r, x_zero=x_zero,
        )

    def __call__(self, r: jax.Array) -> jax.Array:
        """One symmetric two-level cycle on this device's slab block, plus
        (optionally) the additive global slab-mean (Nicolaides) correction
        — the piece a per-slab cycle cannot see: the smooth error mode
        varying ACROSS slabs.  Cost: one scalar all_gather + a (P, P)
        matvec, symmetric, so CG stays valid."""
        from .sharded import AXIS

        x = self._smooth(jnp.zeros_like(r), r, x_zero=True)
        rc = self._t_transpose(r - self._matvec_local(x))
        hi = jax.lax.Precision.HIGHEST
        x = x + self._t_apply(jnp.matmul(self.coarse_inv, rc, precision=hi))
        x = self._smooth(x, r)
        if self.use_global:
            rg = jax.lax.all_gather(jnp.sum(r), AXIS)  # (P,)
            xg = jnp.matmul(self.acc_inv, rg, precision=hi)
            x = x + xg[jax.lax.axis_index(AXIS)]
        return x


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "coarse_inv", "inv_diag", "acc_inv"],
    meta_fields=[
        "offsets", "slab", "local_dims", "brick", "smooth_steps",
        "use_global",
    ],
)
@dataclasses.dataclass
class SlabBrickPrecond:
    """Stacked per-slab two-level cycles (leading axis = parts); use
    :meth:`block` inside ``shard_map`` to get this device's
    :class:`SlabBrickBlock`."""

    data: jax.Array  # (P, ndiags, slab)
    coarse_inv: jax.Array  # (P, nc, nc)
    inv_diag: jax.Array  # (P, slab)
    acc_inv: jax.Array  # (P, P) global slab-mean coarse inverse
    offsets: Tuple[int, ...]
    slab: int
    local_dims: Tuple[int, int, int]
    brick: int
    smooth_steps: int = 2
    use_global: bool = False

    def block(self, data_blk, ci_blk, id_blk) -> SlabBrickBlock:
        return SlabBrickBlock(
            data=data_blk,
            coarse_inv=ci_blk,
            inv_diag=id_blk,
            acc_inv=self.acc_inv,  # replicated (small)
            offsets=self.offsets,
            slab=self.slab,
            local_dims=self.local_dims,
            brick=self.brick,
            smooth_steps=self.smooth_steps,
            use_global=self.use_global,
        )


def build_slab_brick_precond(
    plan: SlabDIAPlan,
    grid_dims: Tuple[int, int, int],
    brick: int = 6,
    smooth_steps: int = 2,
    dtype=np.float32,
    global_coarse: bool = False,
    A=None,
) -> SlabBrickPrecond:
    """Host-side setup of the stacked per-slab two-level cycles.

    Requires the plan's slab size to be a whole number of z-layers
    (``plan.slab % (mx*my) == 0`` — build the plan with
    ``build_slab_plan(..., row_align=mx*my)``); raises otherwise.

    ``global_coarse`` adds the additive slab-mean (Nicolaides) correction
    (pass the host CSR via ``A``).  Measured on Dirichlet-walled heat
    problems it does NOT reduce iterations (the boundary already pins the
    slab-constant mode; the limiting errors live at slab interfaces), so
    it defaults off — it exists for weakly-constrained/pure-Neumann
    problems where the near-constant mode is the slow one.
    """
    mx, my, mz = (int(v) for v in grid_dims)
    P, nd, slab = plan.data.shape
    if slab % (mx * my) != 0:
        raise ValueError(
            f"slab size {slab} is not a whole number of z-layers "
            f"(mx*my = {mx * my}); build the slab plan with "
            f"row_align=mx*my"
        )
    mz_l = slab // (mx * my)
    b = brick
    ncx, ncy, ncz = -(-mx // b), -(-my // b), -(-mz_l // b)
    nc = ncx * ncy * ncz

    # Aggregate id per local row (same for every slab).
    f = np.arange(slab)
    ix, rest = f % mx, f // mx
    iy, iz = rest % my, rest // my
    agg = (ix // b) + ncx * ((iy // b) + ncy * (iz // b))

    offsets = np.asarray(plan.offsets)
    data = np.asarray(plan.data, dtype=np.float64)
    # Coarse Galerkin blocks A_c[p] = T^T A_loc T with unit-weight T
    # (normalization is irrelevant for the two-level correction: A_c
    # adapts to whatever T scaling is used).
    Ac = np.zeros((P, nc, nc))
    diag = np.ones((P, slab))
    for d, off in enumerate(offsets):
        i = np.arange(slab)
        j = i + off
        ok = (j >= 0) & (j < slab)
        ii, jj = i[ok], j[ok]
        for p in range(P):
            np.add.at(Ac[p], (agg[ii], agg[jj]), data[p, d, ii])
        if off == 0:
            diag = np.where(data[:, d, :] != 0, data[:, d, :], 1.0)

    # Bricks covering only padding rows (zero local diag everywhere) give
    # zero coarse rows; pin them to identity so the dense solve is sane.
    for p in range(P):
        zero = np.abs(np.diag(Ac[p])) < 1e-30
        Ac[p][zero, :] = 0.0
        Ac[p][:, zero] = 0.0
        Ac[p][zero, zero] = 1.0
    coarse_inv = np.linalg.inv(Ac)

    # Global slab-mean coarse: Acc[p, q] = ones_p^T A ones_q over the FULL
    # matrix (cross-slab couplings included) — needs the host CSR.
    acc_inv = np.zeros((P, P))
    if global_coarse and A is not None:
        rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
        pr = np.minimum(rows // slab, P - 1)
        pc = np.minimum(A.indices // slab, P - 1)
        Acc = np.zeros((P, P))
        np.add.at(Acc, (pr, pc), A.data)
        zero = np.abs(np.diag(Acc)) < 1e-30
        Acc[zero, zero] = 1.0
        acc_inv = np.linalg.inv(Acc)

    return SlabBrickPrecond(
        data=jnp.asarray(plan.data),
        coarse_inv=jnp.asarray(coarse_inv.astype(np.dtype(dtype))),
        inv_diag=jnp.asarray((1.0 / diag).astype(np.dtype(dtype))),
        acc_inv=jnp.asarray(acc_inv.astype(np.dtype(dtype))),
        offsets=tuple(int(o) for o in plan.offsets),
        slab=slab,
        local_dims=(mx, my, mz_l),
        brick=b,
        smooth_steps=smooth_steps,
        use_global=bool(global_coarse and A is not None),
    )

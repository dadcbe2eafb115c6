"""Block-Schwarz AMG: distributed AMG preconditioning for sharded solves.

Additive Schwarz without overlap: each device applies a full SA-AMG V-cycle
to its *local diagonal block* (off-part couplings dropped), so the
preconditioner application needs **zero communication** — only the CG
matvec/dots touch ICI.  Convergence sits between Jacobi and global AMG
(the dropped couplings weaken the cycle as P grows), which is the classical
trade; a coarse-grid correction is the next rung (ROADMAP).

Setup stacks P per-part hierarchies into single arrays with a leading part
axis so the SPMD program is uniform across devices: all parts are rebuilt
to a common level count and padded to common per-level shapes (padding
slots are exact no-ops: zero matrix rows, unit diagonals).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.csr import CSRMatrix, coo_to_csr
from ..ops.ell import ELLMatrix
from ..solvers.precond.amg import (
    AMGLevel,
    AMGPreconditioner,
    smoothed_aggregation_setup,
)
from .halo import HaloPlan

__all__ = ["build_block_amg", "build_coarse_correction", "TwoLevelPrecond"]


def build_coarse_correction(A: CSRMatrix, plan: HaloPlan) -> jax.Array:
    """Nicolaides coarse space: one constant basis vector per part.

    Returns ``inv(Z^T A Z)`` as a dense (P, P) array (tiny), where Z's p-th
    column is the indicator of part p.  Used by :class:`TwoLevelPrecond` to
    add the global coupling that pure block-Schwarz drops — the classical
    two-level additive Schwarz construction that keeps iteration counts
    bounded as the device count grows."""
    P_ = plan.nparts
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    pr = plan.part_of_row[rows].astype(np.int64)
    pc = plan.part_of_row[A.indices].astype(np.int64)
    Ac = np.zeros((P_, P_))
    np.add.at(Ac, (pr, pc), A.data)
    # Graph Laplacians make Z^T A Z singular only when the whole system is
    # (rows sum to zero); the reduced system has boundary mass, so Ac is
    # SPD.  Regularize defensively for the full-Laplacian case.
    Ac += 1e-12 * np.trace(Ac) / P_ * np.eye(P_)
    return jnp.asarray(np.linalg.inv(Ac))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["local", "Ac_inv", "valid"],
    meta_fields=[],
)
@dataclasses.dataclass
class TwoLevelPrecond:
    """Block-Schwarz local cycle + global partition-constant coarse solve.

    ``M(r) = M_local(r) + Z (Z^T A Z)^{-1} Z^T r`` — the coarse term costs
    one all_gather of P scalars plus a (P, P) matvec, replicated on every
    device.  Constructed *inside* the shard_map body (``local`` already
    sliced to this device; ``valid`` masks real rows vs padding).
    """

    local: object
    Ac_inv: jax.Array
    valid: jax.Array

    def __call__(self, r: jax.Array) -> jax.Array:
        from .sharded import AXIS

        x = self.local(r)
        rbar = jnp.sum(r * self.valid)
        rbars = jax.lax.all_gather(rbar, AXIS)  # (P,)
        coef = jnp.matmul(
            self.Ac_inv, rbars, precision=jax.lax.Precision.HIGHEST
        )
        p = jax.lax.axis_index(AXIS)
        return x + coef[p] * self.valid


def _local_diagonal_block(
    A: CSRMatrix, plan: HaloPlan, p: int, rows: np.ndarray,
    pr: np.ndarray, pc: np.ndarray,
) -> CSRMatrix:
    """Part p's rows/cols of A in part-local ordering (off-part entries
    dropped), sized to the uniform padded local width ``plan.n_local``.
    ``rows``/``pr``/``pc`` are the hoisted O(nnz) expansions (computed once
    by the caller, not per part)."""
    keep = (pr == p) & (pc == p)
    lr = plan.local_of_row[rows[keep]]
    lc = plan.local_of_row[A.indices[keep]]
    # Padding rows (local slots beyond the part's real size) get a unit
    # diagonal so the block stays nonsingular; the residual there is always
    # zero, so this is a no-op in the cycle.
    n_real = int((plan.part_of_row == p).sum())
    pad_rows = np.arange(n_real, plan.n_local, dtype=np.int64)
    lr = np.concatenate([lr, pad_rows])
    lc = np.concatenate([lc, pad_rows])
    data = np.concatenate([A.data[keep], np.ones(pad_rows.size)])
    return coo_to_csr(
        lr, lc, data, (plan.n_local, plan.n_local), sum_dups=False
    )


def _pad_ell(e: ELLMatrix, n_pad: int, width: int, n_rows: int, n_cols: int) -> ELLMatrix:
    cols = jnp.zeros((n_pad, width), dtype=e.cols.dtype)
    vals = jnp.zeros((n_pad, width), dtype=e.vals.dtype)
    cols = cols.at[: e.n_pad, : e.row_width].set(e.cols)
    vals = vals.at[: e.n_pad, : e.row_width].set(e.vals)
    return ELLMatrix(cols=cols, vals=vals, n_rows=n_rows, n_cols=n_cols)


def _dia_to_ell(d) -> ELLMatrix:
    """DIA -> ELL: row i, slot k holds column i + offsets[k] (clipped slots
    carry zero values, so gathers stay in-bounds)."""
    n_pad = d.n_pad
    rows = jnp.arange(n_pad)[:, None]
    offs = jnp.asarray(d.offsets)[None, :]
    cols = rows + offs
    valid = (cols >= 0) & (cols < n_pad)
    cols = jnp.clip(cols, 0, n_pad - 1).astype(jnp.int32)
    # d.dtype is the compute dtype (DIA storage may be narrower, e.g. bf16).
    vals = jnp.where(valid, d.data.T.astype(d.dtype), 0)
    return ELLMatrix(cols=cols, vals=vals, n_rows=d.n_rows, n_cols=d.n_rows)


def _pad_vec(v: jax.Array, n: int, fill: float) -> jax.Array:
    out = jnp.full((n,), jnp.asarray(fill, v.dtype))
    return out.at[: v.shape[0]].set(v)


def build_block_amg(
    A: CSRMatrix,
    plan: HaloPlan,
    dtype=jnp.float32,
    max_levels: int = 4,
    coarse_size: int = 64,
    **amg_kwargs,
) -> Optional[AMGPreconditioner]:
    """Build the stacked per-part AMG hierarchies (leading axis = part).

    Returns an :class:`AMGPreconditioner` whose data leaves carry a leading
    part axis; slice every leaf with ``tree_map(lambda x: x[0], M)`` inside
    the shard_map body to get the device-local preconditioner.  Returns
    None if a uniform structure could not be built (fall back to Jacobi).
    """
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    pr = plan.part_of_row[rows]
    pc = plan.part_of_row[A.indices]
    parts_M: List[AMGPreconditioner] = []
    for p in range(plan.nparts):
        local = _local_diagonal_block(A, plan, p, rows, pr, pc)
        parts_M.append(
            smoothed_aggregation_setup(
                local, dtype=dtype, max_levels=max_levels,
                coarse_size=coarse_size, factored_transfers=False,
                operator_format="ell", **amg_kwargs,
            )
        )
    n_levels = min(len(m.levels) for m in parts_M)
    if n_levels == 0:
        return None
    # Rebuild any deeper hierarchies at the common depth.
    for p, m in enumerate(parts_M):
        if len(m.levels) != n_levels:
            local = _local_diagonal_block(A, plan, p, rows, pr, pc)
            parts_M[p] = smoothed_aggregation_setup(
                local, dtype=dtype, max_levels=n_levels + 1,
                coarse_size=coarse_size, factored_transfers=False,
                operator_format="ell", **amg_kwargs,
            )
            if len(parts_M[p].levels) != n_levels:
                return None
    if any(m.coarse_inv.ndim != 2 for m in parts_M):
        return None  # mixed dense/diag coarse solves: bail to Jacobi

    # Per-level common shapes.
    stacked_levels: List[AMGLevel] = []
    for l in range(n_levels):
        lvls = [m.levels[l] for m in parts_M]
        npad_f = max(v.A.n_pad for v in lvls)
        npad_c = max(v.R.n_pad for v in lvls)
        # DIA level operators would need common offsets across parts; the
        # uniform structure is ELL — convert any DIA level.  (P/R are always
        # explicit ELL here: setup ran with factored_transfers=False.)
        As = [a if isinstance(a, ELLMatrix) else _dia_to_ell(a) for a in
              (v.A for v in lvls)]
        kA = max(a.row_width for a in As)
        kP = max(v.P.row_width for v in lvls)
        kR = max(v.R.row_width for v in lvls)
        A_s = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs),
            *[_pad_ell(a, npad_f, kA, npad_f, npad_f) for a in As],
        )
        P_s = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs),
            *[_pad_ell(v.P, npad_f, kP, npad_f, npad_c) for v in lvls],
        )
        R_s = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs),
            *[_pad_ell(v.R, npad_c, kR, npad_c, npad_f) for v in lvls],
        )
        inv_d = jnp.stack([_pad_vec(v.inv_diag, npad_f, 1.0) for v in lvls])
        lmax = jnp.stack([jnp.asarray(v.lmax) for v in lvls])
        stacked_levels.append(
            AMGLevel(
                A=A_s, P=P_s, R=R_s, inv_diag=inv_d, lmax=lmax, n_rows=npad_f
            )
        )

    cmax = max(m.coarse_inv.shape[0] for m in parts_M)
    coarse = []
    for m in parts_M:
        ci = m.coarse_inv
        c = ci.shape[0]
        pad = jnp.eye(cmax, dtype=ci.dtype)
        pad = pad.at[:c, :c].set(ci)
        coarse.append(pad)
    m0 = parts_M[0]
    return AMGPreconditioner(
        levels=stacked_levels,
        coarse_inv=jnp.stack(coarse),
        smoother=m0.smoother,
        smooth_steps=m0.smooth_steps,
        cycles=m0.cycles,
    )

"""Multi-device sharded operators and solvers (shard_map + collectives).

The runtime half of domain decomposition: the :class:`HaloPlan` built on the
host becomes device-resident arrays sharded over a 1-D
``jax.sharding.Mesh``, and the solve runs as ONE jitted SPMD program under
``jax.shard_map``:

- halo exchange = ``lax.all_to_all`` on a fixed (P, H) buffer over ICI —
  replacing Tpetra Import/Export and the reference's MPI windows
  (``ExodusIO.hpp:429-576``);
- dot products / norms = local partial dot + ``lax.psum`` — replacing the
  MPI_Allreduce inside Belos/Tpetra (SURVEY §2.5);
- the Krylov loop itself (:func:`..solvers.cg.cg_solve` etc.) runs unchanged
  inside the shard_map body, with the sharded matvec/dot injected.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers.cg import CGResult, cg_solve
from ..solvers.gmres import GMRESResult, gmres_solve
from ..solvers.power import PowerResult, power_method
from ..solvers.precond.jacobi import DiagonalPreconditioner
from .halo import HaloPlan

__all__ = [
    "ShardedOperator",
    "make_device_mesh",
    "sharded_cg_solve",
    "sharded_gmres_solve",
    "sharded_power_method",
]

AXIS = "parts"


def make_device_mesh(nparts: int, devices: Optional[Sequence] = None) -> Mesh:
    """1-D device mesh over the first ``nparts`` devices."""
    devs = list(devices if devices is not None else jax.devices())[:nparts]
    if len(devs) < nparts:
        raise ValueError(
            f"need {nparts} devices, have {len(devs)} "
            "(set --xla_force_host_platform_device_count for CPU testing)"
        )
    return Mesh(np.array(devs), (AXIS,))


@dataclasses.dataclass
class ShardedOperator:
    """Device-resident sharded sparse operator + exchange plan."""

    mesh: Mesh
    plan: HaloPlan
    cols: jax.Array  # (P, n_local, K) sharded on axis 0
    vals: jax.Array  # (P, n_local, K) sharded on axis 0
    send_idx: jax.Array  # (P, P, H) sharded on axis 0

    @classmethod
    def from_plan(cls, plan: HaloPlan, mesh: Mesh, dtype=None) -> "ShardedOperator":
        sh = NamedSharding(mesh, P(AXIS))
        vals = plan.ell_vals if dtype is None else plan.ell_vals.astype(np.dtype(dtype))
        return cls(
            mesh=mesh,
            plan=plan,
            cols=jax.device_put(plan.ell_cols, sh),
            vals=jax.device_put(vals, sh),
            send_idx=jax.device_put(plan.send_idx, sh),
        )

    @property
    def dtype(self):
        return self.vals.dtype

    def put_vector(self, x_global: np.ndarray) -> jax.Array:
        """Host (n_global,) -> sharded (P, n_local)."""
        xp = self.plan.scatter_vector(np.asarray(x_global, dtype=self.dtype))
        return jax.device_put(xp, NamedSharding(self.mesh, P(AXIS)))

    def get_vector(self, x_sharded: jax.Array) -> np.ndarray:
        return self.plan.gather_vector(np.asarray(x_sharded))

    # -- generic block construction (lets solver entry points stay
    #    agnostic to the local operator format) --------------------------
    def block_leaves(self) -> dict:
        """Pytree of (P, ...) arrays sharded on axis 0."""
        return {"cols": self.cols, "vals": self.vals, "send_idx": self.send_idx}

    def make_block(self, blk: dict):
        """Build the per-device operator from [0]-indexed leaves."""
        return BlockOperator(blk["cols"], blk["vals"], blk["send_idx"])


# ---------------------------------------------------------------------------
# Inside-shard_map building blocks (operate on per-device blocks)
# ---------------------------------------------------------------------------


def _halo_exchange(x_own: jax.Array, send_idx: jax.Array) -> jax.Array:
    """x_own (n_local,), send_idx (P, H) -> halo (P, H) via all_to_all."""
    sendbuf = jnp.take(x_own, send_idx, axis=0)  # (P, H)
    return jax.lax.all_to_all(sendbuf, AXIS, split_axis=0, concat_axis=0, tiled=False)


def _local_spmv(cols, vals, send_idx, x_own):
    halo = _halo_exchange(x_own, send_idx)  # (P, H)
    x_ext = jnp.concatenate([x_own, halo.reshape(-1)])
    return jnp.sum(vals * jnp.take(x_ext, cols, axis=0), axis=1)


def _psum_dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jax.lax.psum(jnp.vdot(a, b), AXIS)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cols", "vals", "send_idx"],
    meta_fields=[],
)
@dataclasses.dataclass
class BlockOperator:
    """Per-device block of the sharded operator (used inside shard_map).

    ``matvec`` performs the halo exchange + local ELL SpMV; a callable
    pytree so the ordinary Krylov solvers run unchanged inside the SPMD
    body (see the API note in :mod:`..solvers.cg`).
    """

    cols: jax.Array  # (n_local, K)
    vals: jax.Array  # (n_local, K)
    send_idx: jax.Array  # (P, H)

    def matvec(self, x: jax.Array) -> jax.Array:
        return _local_spmv(self.cols, self.vals, self.send_idx, x)


# ---------------------------------------------------------------------------
# Sharded solver entry points — one SPMD program each
# ---------------------------------------------------------------------------


def sharded_cg_solve(
    op: ShardedOperator,
    b: jax.Array,
    x0: jax.Array,
    *,
    precond_diag: Optional[jax.Array] = None,
    cheb_lmax: Optional[float] = None,
    cheb_degree: int = 4,
    block_amg=None,
    coarse_inv: Optional[jax.Array] = None,
    row_valid: Optional[jax.Array] = None,
    tol: float = 1e-14,
    maxiter: int = 300,
) -> CGResult:
    """CG over the device mesh: the whole loop is one SPMD program.

    Preconditioning options (strongest last):
    - Jacobi via ``precond_diag`` (inverse diagonal, sharded);
    - distributed Chebyshev via ``cheb_lmax`` (each polynomial term is a
      halo-exchange SpMV, so it runs over ICI with no extra machinery);
    - block-Schwarz via ``block_amg`` — any stacked per-part callable
      preconditioner pytree with a leading part axis: AMG hierarchies from
      :func:`.schwarz.build_block_amg`, or per-part ILU(0)/ILUT factors
      from :func:`.schwarzilu.build_block_ilu` (the literal distributed
      analogue of the reference's per-rank Ifpack2 ILUT,
      ``BelosMueLuSolver.cpp:92-97``) — a communication-free local
      apply per device; adding ``coarse_inv`` + ``row_valid`` (from
      :func:`.schwarz.build_coarse_correction`) upgrades it to two-level
      Schwarz (global partition-constant coarse correction)."""
    have_M = precond_diag is not None
    have_amg = block_amg is not None
    have_coarse = coarse_inv is not None

    # make_block is invoked inside the traced SPMD body with `op` bound as
    # self — it must ONLY touch the `blk` leaves (touching op's device
    # arrays would embed them as jit constants, the platform pathology
    # documented in solvers/cg.py).
    make_block = type(op).make_block

    def body(leaves, b_blk, x_blk, *rest):
        op_local = make_block(
            op, jax.tree_util.tree_map(lambda a: a[0], leaves)
        )
        rest = list(rest)
        M = None
        if have_M:
            inv_d = rest.pop(0)[0]
            if cheb_lmax is not None:
                from ..solvers.precond.chebyshev import ChebyshevPreconditioner

                M = ChebyshevPreconditioner(
                    A=op_local,
                    inv_diag=inv_d,
                    lmax=jnp.asarray(cheb_lmax, b_blk.dtype),
                    degree=cheb_degree,
                )
            else:
                M = DiagonalPreconditioner(inv_d)
        if have_amg:
            M_stacked = rest.pop(0)
            M = jax.tree_util.tree_map(lambda leaf: leaf[0], M_stacked)
        if have_coarse:
            from .schwarz import TwoLevelPrecond

            Ac_inv = rest.pop(0)  # replicated (P, P)
            valid = rest.pop(0)[0]
            if M is None:
                M = DiagonalPreconditioner(jnp.ones_like(b_blk[0]))
            M = TwoLevelPrecond(local=M, Ac_inv=Ac_inv, valid=valid)
        res = cg_solve(
            op_local, b_blk[0], x_blk[0], precond=M, tol=tol, maxiter=maxiter,
            dot=_psum_dot,
        )
        return res.x[None], res.iterations, res.relres, res.converged

    vectors = (b, x0) + ((precond_diag,) if have_M else ())
    vectors += ((block_amg,) if have_amg else ())
    coarse_specs = ()
    if have_coarse:
        vectors += (coarse_inv, row_valid)
        coarse_specs = (P(), P(AXIS))
    n_sharded = 1 + len(vectors) - len(coarse_specs)
    fn = jax.shard_map(
        body,
        mesh=op.mesh,
        in_specs=(P(AXIS),) * n_sharded + coarse_specs,
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=True,
    )
    x, iters, relres, conv = fn(op.block_leaves(), *vectors)
    return CGResult(x=x, iterations=iters, relres=relres, converged=conv)


def sharded_cg_chunk(
    op: ShardedOperator,
    b: jax.Array,
    x: jax.Array,
    state,  # None or (r, p, rz) sharded arrays from the previous chunk
    *,
    precond_diag: Optional[jax.Array] = None,
    cheb_lmax: Optional[float] = None,
    cheb_degree: int = 4,
    tol: float = 1e-14,
    maxiter: int = 50,
):
    """One chunk of distributed CG, continuing exactly from ``state``.

    Returns ``(CGResult, new_state)``; drive it in a host loop to snapshot
    every chunk while keeping one continuous Krylov recurrence."""
    from ..solvers.cg import cg_solve_with_state

    have_M = precond_diag is not None
    have_state = state is not None

    make_block = type(op).make_block

    def body(leaves, b_blk, x_blk, *rest):
        blk = make_block(op, jax.tree_util.tree_map(lambda a: a[0], leaves))
        rest = list(rest)
        M = None
        if have_M:
            inv_d = rest.pop(0)[0]
            if cheb_lmax is not None:
                from ..solvers.precond.chebyshev import ChebyshevPreconditioner

                M = ChebyshevPreconditioner(
                    A=blk, inv_diag=inv_d,
                    lmax=jnp.asarray(cheb_lmax, b_blk.dtype), degree=cheb_degree,
                )
            else:
                M = DiagonalPreconditioner(inv_d)
        st = None
        if have_state:
            r_blk, p_blk, rz = rest
            st = (r_blk[0], p_blk[0], rz)
        res, (r, p, rz) = cg_solve_with_state(
            blk, b_blk[0], x_blk[0], state=st, precond=M, tol=tol,
            maxiter=maxiter, dot=_psum_dot,
        )
        return (
            res.x[None], res.iterations, res.relres, res.converged,
            r[None], p[None], rz,
        )

    vectors = [b, x]
    if have_M:
        vectors.append(precond_diag)
    if have_state:
        r_s, p_s, rz_s = state
        vectors += [r_s, p_s, rz_s]
    n_args = 1 + len(vectors)
    if have_state:
        # Last arg (rz) is a replicated scalar, not sharded.
        in_specs = (P(AXIS),) * (n_args - 1) + (P(),)
    else:
        in_specs = (P(AXIS),) * n_args
    fn = jax.shard_map(
        body,
        mesh=op.mesh,
        in_specs=in_specs,
        out_specs=(P(AXIS), P(), P(), P(), P(AXIS), P(AXIS), P()),
        check_vma=True,
    )
    x2, iters, relres, conv, r2, p2, rz2 = fn(op.block_leaves(), *vectors)
    return (
        CGResult(x=x2, iterations=iters, relres=relres, converged=conv),
        (r2, p2, rz2),
    )


def sharded_gmres_solve(
    op: ShardedOperator,
    b: jax.Array,
    x0: jax.Array,
    *,
    precond_diag: Optional[jax.Array] = None,
    block_precond=None,
    restart: int = 30,
    tol: float = 1e-14,
    maxiter: int = 300,
) -> GMRESResult:
    """GMRES(m) over the device mesh — the reference's actual solver
    (Belos "GMRES", ``BelosMueLuSolver.cpp:105-106``) distributed.

    ``block_precond``: a stacked per-part callable preconditioner pytree
    (leading part axis), e.g. :func:`.schwarzilu.build_block_ilu` — which
    makes this the literal mpirun configuration: GMRES + per-rank ILUT."""
    have_M = precond_diag is not None
    have_blk = block_precond is not None
    make_block = type(op).make_block

    def body(leaves, b_blk, x_blk, *rest):
        blk = make_block(op, jax.tree_util.tree_map(lambda a: a[0], leaves))
        rest = list(rest)
        M = DiagonalPreconditioner(rest.pop(0)[0]) if have_M else None
        if have_blk:
            M = jax.tree_util.tree_map(lambda leaf: leaf[0], rest.pop(0))
        res = gmres_solve(
            blk, b_blk[0], x_blk[0], precond=M, restart=restart, tol=tol,
            maxiter=maxiter, dot=_psum_dot,
        )
        return res.x[None], res.iterations, res.relres, res.converged

    vectors = (b, x0) + ((precond_diag,) if have_M else ())
    vectors += (block_precond,) if have_blk else ()
    fn = jax.shard_map(
        body,
        mesh=op.mesh,
        in_specs=(P(AXIS),) * (1 + len(vectors)),
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=True,
    )
    x, iters, relres, conv = fn(op.block_leaves(), *vectors)
    return GMRESResult(x=x, iterations=iters, relres=relres, converged=conv)


def sharded_power_method(
    op: ShardedOperator,
    z0: jax.Array,
    *,
    maxiter: int = 500,
    tol: float = 1e-2,
    check_every: int = 50,
) -> PowerResult:
    """Distributed power method — parity with ``ExodusMatrixTest`` run under
    ``mpirun`` (``ExodusMatrixTest.cpp:131-171``)."""

    make_block = type(op).make_block

    def body(leaves, z_blk):
        blk = make_block(op, jax.tree_util.tree_map(lambda a: a[0], leaves))
        res = power_method(
            blk, z_blk[0], maxiter=maxiter, tol=tol, check_every=check_every,
            dot=_psum_dot,
        )
        return (
            res.eigenvalue,
            res.eigenvector[None],
            res.iterations,
            res.residual,
            res.converged,
        )

    fn = jax.shard_map(
        body,
        mesh=op.mesh,
        in_specs=(P(AXIS),) * 2,
        out_specs=(P(), P(AXIS), P(), P(), P()),
        check_vma=True,
    )
    lam, vec, iters, res, conv = fn(op.block_leaves(), z0)
    return PowerResult(
        eigenvalue=lam, eigenvector=vec, iterations=iters, residual=res,
        converged=conv,
    )

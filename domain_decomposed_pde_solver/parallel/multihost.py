"""Multi-host (multi-process) execution: init, sharded IO, checkpointing.

The reference runs on any MPI cluster (``mpirun -n K``, every rank entering
SPMD at ``Tpetra::ScopeGuard`` — ``BelosMueLuSolver.cpp:142``).  The
JAX equivalent is JAX's distributed runtime: one process per host,
``jax.distributed.initialize`` against a coordinator, and the same
``shard_map`` SPMD programs now spanning all hosts' devices (collectives
ride ICI within a slice and DCN/gloo across hosts — no program changes).

What this module adds over the single-process paths:

- :func:`initialize_multihost` — coordinator bootstrap (env-var or args).
- :func:`put_global` — build a globally-sharded array where each process
  contributes only ITS shard (`jax.make_array_from_process_local_data`) —
  per-host upload sharding, the analogue of the reference's block
  element distribution (``ExodusIO.hpp:781-828``): no host ever
  materializes device data it doesn't own.
- :func:`multihost_slab_cg_solve` — the slab CG driver with per-process
  data placement + full-solution allgather.
- per-process sharded checkpointing (:func:`save_sharded_checkpoint` /
  :func:`load_sharded_checkpoint`): each host writes only its shards, so
  checkpoint IO scales with hosts.

Tested with 2 CPU processes x 4 virtual devices in
``tests/test_multihost.py`` (the ``mpirun``-replacement strategy, SURVEY
§4 "Multi-node without a cluster").
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "initialize_multihost",
    "put_global",
    "multihost_slab_cg_solve",
    "save_sharded_checkpoint",
    "load_sharded_checkpoint",
]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> int:
    """Initialize the JAX distributed runtime; returns this process' id.

    Arguments default to the ``DDPS_COORDINATOR`` / ``DDPS_NUM_PROCESSES``
    / ``DDPS_PROCESS_ID`` environment variables (set them per process like
    MPI ranks); JAX needs all three given explicitly.

    ``local_device_ids``: the cards this process opens.  On a GPU host
    running one process per card it defaults to ``[process_id]``, so two
    processes never open the same card (each would otherwise reserve most
    of every card's memory).  CPU processes keep all their devices.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("DDPS_COORDINATOR")
    if num_processes is None and "DDPS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DDPS_NUM_PROCESSES"])
    if process_id is None and "DDPS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DDPS_PROCESS_ID"])
    platforms = str(jax.config.jax_platforms or "")
    if (
        local_device_ids is None
        and process_id is not None
        and platforms.split(",")[0] != "cpu"
    ):
        local_device_ids = [process_id]
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return jax.process_index()


def put_global(local: np.ndarray, sharding):
    """Globally-sharded device array from this process' local block.

    ``local``: the rows of the leading (sharded) axis owned by this
    process' devices, in device order.  Single-process shardings fall back
    to a plain ``device_put``.
    """
    import jax

    if jax.process_count() == 1:
        return jax.device_put(local, sharding)
    return jax.make_array_from_process_local_data(sharding, local)


def _local_rows(arr: np.ndarray, nparts: int) -> np.ndarray:
    """This process' contiguous block of a (nparts, ...) part-major array.

    ``jax.devices()`` is process-major, so process p owns parts
    [p*k, (p+1)*k) with k = nparts / process_count."""
    import jax

    pc = jax.process_count()
    if pc == 1:
        return arr
    if nparts % pc:
        raise ValueError(f"nparts={nparts} not divisible by {pc} processes")
    k = nparts // pc
    p = jax.process_index()
    return arr[p * k : (p + 1) * k]


def multihost_slab_cg_solve(
    plan,
    b: np.ndarray,
    x0: np.ndarray,
    *,
    tol: float = 1e-12,
    maxiter: int = 1000,
    jacobi: bool = True,
):
    """Distributed slab CG across all processes' devices.

    Same math as :func:`.slab.slab_cg_solve`; data placement goes through
    :func:`put_global` so each host uploads only its slabs, and the
    solution is returned in full on every host via ``process_allgather``.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..solvers.cg import CGResult, cg_solve
    from ..solvers.precond.jacobi import DiagonalPreconditioner
    from .sharded import AXIS, _psum_dot
    from .slab import SlabDIAOperator

    nparts = plan.nparts
    devs = np.array(jax.devices()[:nparts])
    if devs.size < nparts:
        raise ValueError(f"need {nparts} devices, have {devs.size}")
    dev_mesh = Mesh(devs, (AXIS,))
    sh = NamedSharding(dev_mesh, P(AXIS))

    data = put_global(_local_rows(plan.data, nparts), sh)
    b_parts = plan.scatter_vector(b, dtype=plan.data.dtype)
    x0_parts = plan.scatter_vector(x0, dtype=plan.data.dtype)
    b_s = put_global(_local_rows(b_parts, nparts), sh)
    x0_s = put_global(_local_rows(x0_parts, nparts), sh)
    offsets, halo, slab = plan.offsets, plan.halo, plan.slab

    def body(data_blk, b_blk, x_blk):
        op = SlabDIAOperator(
            data=data_blk[0], offsets=offsets, halo=halo, slab=slab
        )
        if jacobi:
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

    fn = jax.shard_map(
        body,
        mesh=dev_mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=True,
    )
    x_s, iters, relres, conv = fn(data, b_s, x0_s)
    from jax.experimental import multihost_utils

    x_full = np.asarray(multihost_utils.process_allgather(x_s, tiled=True))
    return plan.gather_vector(x_full), CGResult(
        x=x_s, iterations=iters, relres=relres, converged=conv
    )


def save_sharded_checkpoint(path_prefix: str, arrays: dict) -> str:
    """Write this process' addressable shards of each array to
    ``{path_prefix}.proc{pid}.npz`` — checkpoint IO scales with hosts
    (no rank-0 gather, unlike the reference's solution writer,
    ``ExodusIO.hpp:1999-2026``)."""
    import jax

    pid = jax.process_index()
    out = {}
    for name, arr in arrays.items():
        if hasattr(arr, "addressable_shards"):
            for s in arr.addressable_shards:
                out[f"{name}__{s.index[0].start or 0}"] = np.asarray(s.data)
        else:
            if pid == 0:
                out[name] = np.asarray(arr)
    path = f"{path_prefix}.proc{pid}.npz"
    np.savez(path, **out)
    return path


def load_sharded_checkpoint(path_prefix: str) -> dict:
    """Load this process' shard file; returns {name: {row_start: block}}."""
    import jax

    pid = jax.process_index()
    path = f"{path_prefix}.proc{pid}.npz"
    with np.load(path) as z:
        out: dict = {}
        for key in z.files:
            if "__" in key:
                name, start = key.rsplit("__", 1)
                out.setdefault(name, {})[int(start)] = z[key]
            else:
                out[key] = z[key]
    return out

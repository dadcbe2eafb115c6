"""Benchmark harness — prints ONE JSON line of results on the last line.

Sections, all on meshes generated in the repository:

- SpMV time and bandwidth on the tet-cube-heat mesh refined twice
  (~1.3M DOF, unstructured; ``choose_operator`` picks the format) and on
  ~1M and ~10M-DOF structured boxes (the lattice-stencil form);
- CG+Jacobi and CG+AMG to 1e-6 on the refined tet-cube, CG+AMG to 1e-6 on
  the 1M box, and CG+AMG to 1e-8 (f32 inner sweeps, f64 refinement) on the
  1M box.

Bandwidths are bytes computed from shapes (``ops.dia.operator_bytes``) over
time, reported beside the card's copy bandwidth measured in the same run and
its published HBM peak (``ROOFLINES``).  Times are host-clock around work
that ends in ``block_until_ready``.  The benchmark needs a GPU listed in
``ROOFLINES``; any other device is an error.

Run: ``python bench.py`` (one H100; a few minutes).
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

# Published HBM peak (GB/s) by ``jax.Device.device_kind``.
ROOFLINES = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5: 3.35 TB/s",
    },
}


def roofline_for(device) -> dict:
    kind = getattr(device, "device_kind", "")
    if kind not in ROOFLINES:
        raise RuntimeError(
            f"no roofline for device kind {kind!r} (platform "
            f"{device.platform}); add it to bench.ROOFLINES with its source"
        )
    return ROOFLINES[kind]


def card_info() -> str:
    """``name, power.limit`` of the card, read by nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_chain(step, A, x, steps=50, reps=5) -> float:
    """Seconds per ``step(A, x)``: back-to-back dispatches of one jitted
    step feeding the next (host dispatch stays ahead of the card), fenced
    once with ``block_until_ready``; best of ``reps``."""
    import jax

    jax.block_until_ready(step(A, x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        v = x
        for _ in range(steps):
            v = step(A, v)
        jax.block_until_ready(v)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def copy_gbps() -> float:
    """Measured copy bandwidth: ``y = 0.5 x + 1`` over 1 GiB of f32."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((1 << 30) // 4, jnp.float32)
    t = time_chain(jax.jit(lambda a, v: v * a + 1.0), jnp.float32(0.5), x)
    return 2 * x.size * 4 / t / 1e9


def timed(fn):
    """(result, seconds) of ``fn()`` after one warm-up call."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def main():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    roof = roofline_for(dev)
    from domain_decomposed_pde_solver.utils import enable_persistent_cache

    enable_persistent_cache()

    from domain_decomposed_pde_solver.io import refine_uniform
    from domain_decomposed_pde_solver.io.tetmesh import tet_cube_heat_mesh
    from domain_decomposed_pde_solver.models import assemble_heat_system
    from domain_decomposed_pde_solver.models.structured import (
        structured_box_parts,
        structured_box_system,
    )
    from domain_decomposed_pde_solver.ops import choose_operator, operator_bytes
    from domain_decomposed_pde_solver.ops.stencil import stencil_from_parts
    from domain_decomposed_pde_solver.solvers import (
        cg_solve,
        jacobi_preconditioner,
        smoothed_aggregation_setup,
    )
    from domain_decomposed_pde_solver.solvers.mixed import (
        iterative_refinement_solve,
    )

    out = {
        "card": card_info(),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "hbm_peak_gbps": roof["hbm_gbps"],
        "hbm_peak_source": roof["source"],
        "copy_gbps": copy_gbps(),
    }
    matvec = jax.jit(lambda A, v: A.matvec(v))

    def spmv(tag, A, n_free):
        x = A.put_vector(
            np.random.default_rng(0).standard_normal(n_free).astype(np.float32)
        )
        dt = time_chain(matvec, A, x)
        out[f"spmv_format_{tag}"] = type(A).__name__
        out[f"spmv_us_{tag}"] = dt * 1e6
        out[f"spmv_gbps_{tag}"] = operator_bytes(A) / dt / 1e9

    # --- unstructured: tet-cube-heat refined twice ------------------------
    t0 = time.perf_counter()
    tet = assemble_heat_system(refine_uniform(tet_cube_heat_mesh(), 2))
    out["tet_setup_s"] = time.perf_counter() - t0
    out["tet_dof"] = tet.n_free
    A = choose_operator(tet.A, dtype=jnp.float32)
    spmv("tet", A, tet.n_free)
    bs = A.put_vector((tet.b / np.abs(tet.b).max()).astype(np.float32))
    x0 = jnp.zeros_like(bs)
    M = jacobi_preconditioner(A)
    res, dt = timed(lambda: cg_solve(A, bs, x0, precond=M, tol=1e-6,
                                     maxiter=5000))
    out["cg_jacobi_ms_tet"] = dt * 1e3
    out["cg_jacobi_iters_tet"] = int(res.iterations)
    t0 = time.perf_counter()
    Mt = smoothed_aggregation_setup(tet.A, dtype=jnp.float32)
    out["amg_setup_s_tet"] = time.perf_counter() - t0
    res, dt = timed(lambda: cg_solve(A, bs, x0, precond=Mt, tol=1e-6,
                                     maxiter=300))
    out["cg_amg_ms_tet"] = dt * 1e3
    out["cg_amg_iters_tet"] = int(res.iterations)
    del A, M, Mt, bs, x0, tet

    # --- structured boxes --------------------------------------------------
    for tag, cells in (("box10m", 217), ("box1m", 100)):
        parts = structured_box_parts(cells, cells, cells)["parts"]
        spmv(tag, stencil_from_parts(parts), parts["n_rows"])
        out[f"{tag}_dof"] = parts["n_rows"]

    t0 = time.perf_counter()
    sys1m = structured_box_system(100, 100, 100)
    dims = (99, 101, 101)  # free-node grid: the x faces are Dirichlet
    A1 = choose_operator(sys1m.A, dtype=jnp.float32, grid_dims=dims)
    M1 = smoothed_aggregation_setup(sys1m.A, dtype=jnp.float32, grid_dims=dims)
    out["amg_setup_s_box1m"] = time.perf_counter() - t0
    b1 = A1.put_vector((sys1m.b / np.abs(sys1m.b).max()).astype(np.float32))
    res, dt = timed(lambda: cg_solve(A1, b1, jnp.zeros_like(b1), precond=M1,
                                     tol=1e-6, maxiter=200))
    out["cg_amg_ms_box1m"] = dt * 1e3
    out["cg_amg_iters_box1m"] = int(res.iterations)
    kw = dict(tol=1e-8, inner_tol=1e-6, inner_maxiter=200, precond=M1,
              operator=A1)
    iterative_refinement_solve(sys1m.A, sys1m.b, **kw)  # warm
    t0 = time.perf_counter()
    mr = iterative_refinement_solve(sys1m.A, sys1m.b, **kw)
    out["cg_amg_1e8_ms_box1m"] = (time.perf_counter() - t0) * 1e3
    out["cg_amg_1e8_relres_box1m"] = float(mr.relres)
    out["cg_amg_1e8_inner_iters_box1m"] = int(mr.inner_iterations)
    out["peak_bytes_in_use"] = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    print(json.dumps(out))


if __name__ == "__main__":
    main()

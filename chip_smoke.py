"""Start-up proof on one NVIDIA GPU: the heat-equation solve end to end.

Runs the user-facing ``ddps-solve`` path (``cli.solve.main``) on two meshes
generated from seeds and written as Exodus files:

1. unstructured: the tet-cube-heat mesh (20,539 nodes), refined twice in the
   CLI (~1.3M DOF);
2. structured: ``box_mesh(100, 100, 100, "TETRA4")`` (~1.0M DOF; the CLI
   picks the lattice-stencil operator and brick-transfer AMG).

Both solve in f64 (the CLI default) with CG + smoothed-aggregation AMG to a
relative residual of 1e-8 (f32 inner sweeps, f64 refinement).  Each
solution is read back from its Exodus file and checked against a plain
reference independent of the device code: the f64 residual
``||b - A x|| / ||b||`` computed on the host with SciPy from the assembled
CSR, the maximum principle (every free value in [100, 1000]), and timestep
0 being the boundary snapshot.

Usage::

    python chip_smoke.py           # one GPU; last line is the JSON verdict
    python chip_smoke.py --four    # four GPUs: --partitions 4 vs one card
    python chip_smoke.py --tiny    # CPU rehearsal at tiny sizes; no verdict

``--four`` runs only the domain-decomposed phase: both meshes with
``--partitions 4`` (halo-partitioned global AMG for the unstructured mesh,
slab global AMG for the box), the same hierarchy on one card for
comparison, the residual and bounds checks, and iteration counts within
one of the one-card counts.  Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

RELRES_MAX = 1e-8
BOUNDS = (100.0, 1000.0)


def card_info() -> str:
    """``name, power.limit`` from nvidia-smi (a child that never imports
    JAX, so the card stays this process's alone)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def run_cli(argv):
    """Run ``cli.solve.main(argv)``; returns (rc, stdout), echoing stdout."""
    from domain_decomposed_pde_solver.cli.solve import main as solve_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = solve_main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    return rc, out


def parse_cli(out: str) -> dict:
    m = re.search(r"Converged in (\d+) iterations", out)
    phases = {
        k: float(v)
        for k, v in re.findall(r"^(\S+)\s+([0-9.]+)s\s+x\d+$", out, re.M)
    }
    return {"iterations": int(m.group(1)) if m else None, "phases": phases}


def check_solution(path, mesh, system):
    """Host checks of a solution file; returns the f64 relative residual."""
    import numpy as np
    import scipy.sparse as sp

    from domain_decomposed_pde_solver.io import read_nodal_vars

    _, _, vals = read_nodal_vars(path)
    if not np.array_equal(vals[0, 0], mesh.boundary_write_values()):
        fail(f"{path}: timestep 0 is not the boundary snapshot")
    x = vals[-1, 0, system.free_to_node]
    if not np.isfinite(x).all():
        fail(f"{path}: non-finite solution values")
    A = sp.csr_matrix(
        (system.A.data, system.A.indices, system.A.indptr), shape=system.A.shape
    )
    relres = float(np.linalg.norm(system.b - A @ x) / np.linalg.norm(system.b))
    lo, hi = float(x.min()), float(x.max())
    if not relres <= RELRES_MAX:
        fail(f"{path}: host f64 relative residual {relres:.3e} > {RELRES_MAX}")
    if lo < BOUNDS[0] - 1e-6 or hi > BOUNDS[1] + 1e-6:
        fail(f"{path}: free values [{lo}, {hi}] outside {BOUNDS}")
    return relres, lo, hi


def solve_case(tag, mesh_path, refine, partitions, workdir, card):
    """CLI solve of one mesh + host checks; returns the parsed record."""
    import jax

    from domain_decomposed_pde_solver.io import read_exodus, refine_uniform
    from domain_decomposed_pde_solver.models import assemble_heat_system

    sol = os.path.join(workdir, f"{tag}-p{partitions}.exo")
    argv = [
        "--input", mesh_path, "--solution", sol, "--refine", str(refine),
        "--precond", "amg", "--tolerance", str(RELRES_MAX),
        "--no-snapshots", "--partitions", str(partitions), "--verbose",
    ]
    t0 = time.perf_counter()
    rc, out = run_cli(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{tag}: ddps-solve exited {rc}")
    rec = parse_cli(out)
    mesh = refine_uniform(read_exodus(mesh_path), refine)
    system = assemble_heat_system(mesh)
    relres, lo, hi = check_solution(sol, mesh, system)
    peak = jax.devices()[0].memory_stats() or {}
    rec.update(
        tag=tag, partitions=partitions, dof=int(system.n_free), wall_s=wall,
        relres=relres, min=lo, max=hi,
        peak_bytes_in_use=peak.get("peak_bytes_in_use"),
    )
    phases = " ".join(f"{k}={v:.3f}s" for k, v in rec["phases"].items())
    print(
        f"[{card}] {tag} partitions={partitions}: dof={rec['dof']} "
        f"iterations={rec['iterations']} host_relres={relres:.3e} "
        f"range=[{lo:.6f}, {hi:.6f}] wall={wall:.3f}s "
        f"peak_bytes_in_use={rec['peak_bytes_in_use']}",
        flush=True,
    )
    print(
        f"[{card}] {tag} phases (solve includes jit compilation): {phases}",
        flush=True,
    )
    return rec, system, mesh


def one_card_reference(tag, system, mesh, card):
    """The distributed hierarchy's one-card twin: f64 CG + f64 SA-AMG on
    one device, same x0 and tolerance as the CLI; returns iterations."""
    import jax.numpy as jnp
    import numpy as np

    from domain_decomposed_pde_solver.ops import choose_operator
    from domain_decomposed_pde_solver.solvers import (
        cg_solve,
        smoothed_aggregation_setup,
    )
    from domain_decomposed_pde_solver.solvers.precond.amg import infer_free_grid

    dims = infer_free_grid(mesh, system.free_to_node)
    A = choose_operator(system.A, dtype=jnp.float64, grid_dims=dims)
    M = smoothed_aggregation_setup(system.A, dtype=jnp.float64, grid_dims=dims)
    x0 = np.random.default_rng(0).uniform(-1.0, 1.0, size=system.n_free)
    res = cg_solve(
        A, A.put_vector(system.b), A.put_vector(x0), precond=M,
        tol=RELRES_MAX, maxiter=300,
    )
    iters = int(res.iterations)
    print(f"[{card}] {tag} one-card f64 CG+AMG: iterations={iters}", flush=True)
    return iters


def make_meshes(workdir, tiny):
    from domain_decomposed_pde_solver.io import box_mesh, write_exodus
    from domain_decomposed_pde_solver.io.tetmesh import (
        delaunay_box_mesh,
        tet_cube_heat_mesh,
    )

    t0 = time.perf_counter()
    if tiny:
        tet = delaunay_box_mesh(1500, face_nodes=100, seed=0)
        box = box_mesh(12, 12, 12, "TETRA4")
    else:
        tet = tet_cube_heat_mesh(seed=0)
        box = box_mesh(100, 100, 100, "TETRA4")
    paths = {}
    for tag, mesh in (("unstructured", tet), ("structured", box)):
        paths[tag] = os.path.join(workdir, f"{tag}.exo")
        write_exodus(paths[tag], mesh)
    print(f"meshes generated and written in {time.perf_counter() - t0:.3f}s",
          flush=True)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card domain-decomposed phase")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU rehearsal at tiny sizes (never reports ok)")
    args = ap.parse_args(argv)
    if args.tiny:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            )

    import jax

    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    dev = devs[0]
    if not args.tiny and dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform} devices", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"need {need} devices, JAX found {len(devs)}", file=sys.stderr)
        return 2

    from domain_decomposed_pde_solver.utils.compilecache import (
        enable_persistent_cache,
    )
    from domain_decomposed_pde_solver.utils.native import load_native

    card = "cpu rehearsal" if args.tiny else card_info()
    print(card, flush=True)
    print(
        f"device_kind={dev.device_kind} count={len(devs)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={enable_persistent_cache()} "
        f"native_loaded={load_native() is not None}",
        flush=True,
    )

    refine = 1 if args.tiny else 2
    with tempfile.TemporaryDirectory(prefix="ddps-smoke-") as workdir:
        paths = make_meshes(workdir, args.tiny)
        for tag in ("unstructured", "structured"):
            r = refine if tag == "unstructured" else 0
            if not args.four:
                solve_case(tag, paths[tag], r, 1, workdir, card)
                continue
            rec, system, mesh = solve_case(tag, paths[tag], r, 4, workdir, card)
            it1 = one_card_reference(tag, system, mesh, card)
            if rec["iterations"] is None or abs(rec["iterations"] - it1) > 1:
                fail(
                    f"{tag}: 4-card iterations {rec['iterations']} vs "
                    f"one-card {it1} (allowed +-1)"
                )
            print(f"[{card}] {tag}: 4-card iterations {rec['iterations']}, "
                  f"one-card {it1}", flush=True)

    if args.tiny:
        print("tiny rehearsal passed (no verdict off the GPU)", flush=True)
        return 0
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devs),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

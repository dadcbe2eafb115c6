"""Multi-host SPMD: 2 real processes x 4 virtual devices, one solve.

The reference's multi-node story is ``mpirun -n K`` on any MPI cluster;
ours is ``jax.distributed`` + the same shard_map programs.  This test
actually SPAWNS two processes (the claim "the plans are
process-count-agnostic" is tested, not asserted): distributed init over a
localhost coordinator, per-host device placement, cross-process
collectives (gloo), full-solution allgather, and per-process sharded
checkpointing.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_solve(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    port = _free_port()
    env = dict(os.environ)
    # The worker sets its own XLA flags; scrub the single-process conftest
    # device-count forcing so each process builds a fresh backend.
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i} failed:\n{outs[i][-3000:]}"
    for i in range(2):
        marker = tmp_path / f"ok.{i}"
        assert marker.exists(), outs[i][-3000:]
    # Both processes saw the same converged solve.
    assert (tmp_path / "ok.0").read_text() == (tmp_path / "ok.1").read_text()


@pytest.mark.slow
def test_two_process_distributed_assembly(tmp_path):
    """True distributed assembly at >=1M DOF: 2 processes, each reading
    only its element slice, all_to_all edge exchange, per-rank row
    assembly, bit-parity vs the single-host plan + sharded SpMV check."""
    from domain_decomposed_pde_solver.io.boxmesh import box_mesh
    from domain_decomposed_pde_solver.io.exodus import write_exodus

    mesh_path = str(tmp_path / "box1m.exo")
    write_exodus(mesh_path, box_mesh(100, 100, 100, elem_type="HEX8"))

    worker = os.path.join(os.path.dirname(__file__), "distassembly_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(tmp_path),
             mesh_path],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i} failed:\n{outs[i][-3000:]}"
    a = (tmp_path / "dok.0").read_text()
    b = (tmp_path / "dok.1").read_text()
    assert a == b, (a, b)
    # 101^3 = 1,030,301 nodes minus the 2 x 101^2 boundary-nodeset nodes
    # box_mesh always carries -> 99*101*101 free rows.
    assert "n_free=1009899" in a, a

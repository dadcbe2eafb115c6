"""chip_smoke.py: the CPU rehearsal passes its checks, the script refuses
to report off the GPU, and (on a card) its checks pass at tiny sizes."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(args, env_extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT),
    )


def test_chip_smoke_tiny_rehearsal():
    proc = _run(["--tiny"], {})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert '"ok"' not in proc.stdout
    for tag in ("unstructured", "structured"):
        assert f"{tag} partitions=1" in proc.stdout
    assert "host_relres" in proc.stdout


def test_chip_smoke_refuses_without_gpu():
    proc = _run([], {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_chip_smoke_checks_on_gpu(gpu, tmp_path, capsys):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    paths = chip_smoke.make_meshes(str(tmp_path), tiny=True)
    for tag, refine in (("unstructured", 1), ("structured", 0)):
        rec, _, _ = chip_smoke.solve_case(
            tag, paths[tag], refine, 1, str(tmp_path), gpu.device_kind
        )
        assert rec["relres"] <= chip_smoke.RELRES_MAX
        assert rec["iterations"] is not None

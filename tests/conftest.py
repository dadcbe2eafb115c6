"""Test configuration: a deterministic 8-device CPU platform and the meshes.

Multi-"rank" behavior is validated on a virtual device mesh via
``--xla_force_host_platform_device_count`` — replacing the reference's
``mpirun -n K`` testing strategy (SURVEY §4).  f64 is enabled so golden
comparisons against scipy are exact-precision.

The reference's Exodus inputs are generated from seeds
(``io.tetmesh.REFERENCE_MESHES``) and written once per test worker.

Tests that need a GPU take the ``gpu`` fixture: it skips them, with a
reason, when JAX finds no GPU.  It decides inside the fixture, never at
import, so every xdist worker collects the same tests.
"""

import os
import pathlib

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

if os.environ.get("DDPS_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest


@pytest.fixture(scope="session")
def data_dir(tmp_path_factory) -> pathlib.Path:
    from domain_decomposed_pde_solver.io.tetmesh import write_reference_meshes

    d = tmp_path_factory.mktemp("meshes")
    write_reference_meshes(str(d))
    return d


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with DDPS_TEST_GPU=1 on the card)")
    return devs[0]

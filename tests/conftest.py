"""Test harness configuration (SURVEY §4).

Tests run on the host CPU with an 8-device virtual mesh
(``--xla_force_host_platform_device_count=8``) so every ``shard_map`` code
path exercised here is the same one that runs across the cards of a GPU
host.  f64 is enabled so analytic-vs-numeric Jacobian checks and
oracle-parity assertions can use tight (1e-9-ish) tolerances.

This file must set the environment BEFORE jax is imported anywhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    The full suite compiles hundreds of XLA CPU executables in one
    process; with all of them held live, the LAST test's compile
    (test_tracks.py::test_images_to_reconstruction, a full-pipeline BA
    graph) segfaults inside XLA's backend_compile_and_load — reproduced
    in suite order, never standalone.  Bounding the live executable count
    keeps the native compiler healthy; per-module recompiles cost little
    because shapes rarely repeat across modules.
    """
    yield
    jax.clear_caches()

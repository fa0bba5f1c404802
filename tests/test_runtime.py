"""Runtime plumbing: the compile cache location, the native I/O build, and
chip_smoke.py's refusal to run without a GPU plus its comparison helpers."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _cache_dir_after_enable(env_value):
    """Run enable_compilation_cache() in a fresh interpreter; return
    (returned dir, jax's configured dir)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = (
        "import jax; from pysfm_tpu.utils import enable_compilation_cache;"
        "d = enable_compilation_cache();"
        "print(d); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
        capture_output=True, text=True, timeout=120,
    ).stdout.split("\n")
    return out[0], out[1]


def test_compile_cache_honours_env_var(tmp_path):
    d = str(tmp_path / "xla")
    got, configured = _cache_dir_after_enable(d)
    assert got == d and configured == d


def test_compile_cache_defaults_to_fixed_repo_dir():
    from pysfm_tpu.utils import compcache

    got, configured = _cache_dir_after_enable(None)
    assert got == configured == compcache.DEFAULT_DIR
    assert compcache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")


def test_native_io_builds_from_source_into_ignored_dir():
    from pysfm_tpu.io import native

    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.have_native() and os.path.exists(path)
    out = native.parse_doubles(b"1 -2.5e3\n+0.25")
    np.testing.assert_array_equal(out, [1.0, -2500.0, 0.25])
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    rel = os.path.relpath(native.BUILD_DIR, ROOT)
    assert rel + "/" in ignored


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_rel_err_and_curves():
    assert chip_smoke.rel_err(1.0001, 1.0) == pytest.approx(1e-4)
    assert chip_smoke.rel_err(0.0, 0.0) == 0.0
    # Curves: relative per point, floored at 1; shorter curve compared
    # against the reference prefix.
    assert chip_smoke.curve_rel([10.0, 5.0], [10.0, 5.001, 4.0]) == (
        pytest.approx(0.001 / 5.001)
    )
    assert chip_smoke.curve_rel([0.5], [0.25]) == pytest.approx(0.25)


def test_chip_smoke_vec_rel_and_memory_balance():
    a = np.array([3.0, 4.0])
    assert chip_smoke.vec_rel(a, a) == 0.0
    assert chip_smoke.vec_rel(a + [0.0, 5e-4], a) == pytest.approx(1e-4)
    assert chip_smoke.memory_balanced([100, 90, 30, 25])
    assert not chip_smoke.memory_balanced([100, 90, 30, 24])
    assert not chip_smoke.memory_balanced([400, 0, 0, 0])


def test_chip_smoke_check_raises():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="broken"):
        chip_smoke.check(False, "broken")

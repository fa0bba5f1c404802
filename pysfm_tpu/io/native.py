"""ctypes bindings for the native I/O tier (see _native/fast_parse.cpp).

The shared library is built from source on first use with the system's
g++ into ``_native/build/`` (ignored by git), under a name that carries a
hash of ``fast_parse.cpp``: a missing library, or one built from a
different source, is rebuilt.  Every entry point has a NumPy fallback so
the framework works without a toolchain.  pybind11 is not a dependency,
hence ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "_native")
_SRC = os.path.join(_DIR, "fast_parse.cpp")
BUILD_DIR = os.path.join(_DIR, "build")

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> str:
    """Where the library built from the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libpysfm_io-{digest}.so")


def _build(out: str) -> bool:
    """Compile to a temporary name, then rename: concurrent processes
    never load a half-written library."""
    tmp = None
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception:
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.pysfm_parse_doubles.restype = ctypes.c_int64
            lib.pysfm_parse_doubles.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ]
            lib.pysfm_count_tokens.restype = ctypes.c_int64
            lib.pysfm_count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.pysfm_format_bal.restype = ctypes.c_int64
            lib.pysfm_format_bal.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int64,
            ]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def have_native() -> bool:
    return _load() is not None


def parse_doubles(data: bytes, expected: int | None = None) -> np.ndarray:
    """Parse whitespace-separated numbers from ``data`` into a f64 array.

    Uses the C++ tokenizer when available (single pass, no Python string
    objects); falls back to ``np.array(data.split())``.  ``expected`` caps
    the output size when the caller knows the token count (skips the
    counting pass).
    """
    lib = _load()
    if lib is None:
        out = np.array(data.split(), dtype=np.float64)
        return out[:expected] if expected is not None else out
    # ctypes c_char_p NUL-terminates; strtod never reads past it.
    if expected is None:
        expected = int(lib.pysfm_count_tokens(data, len(data)))
    out = np.empty(expected, dtype=np.float64)
    n = lib.pysfm_parse_doubles(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), expected,
    )
    return out[:n]


def format_bal(
    obs_cam: np.ndarray,
    obs_pt: np.ndarray,
    uv: np.ndarray,
    vals: np.ndarray,
) -> bytes | None:
    """Format the BAL body (obs lines + one value per line at %.17g) with
    the native writer; returns None when the library is unavailable (the
    caller falls back to a vectorized NumPy path)."""
    lib = _load()
    if lib is None:
        return None
    obs_cam = np.ascontiguousarray(obs_cam, np.int32)
    obs_pt = np.ascontiguousarray(obs_pt, np.int32)
    uv = np.ascontiguousarray(uv, np.float64)
    vals = np.ascontiguousarray(vals, np.float64)
    n_obs, n_vals = obs_cam.shape[0], vals.shape[0]
    cap = 80 * n_obs + 32 * n_vals + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.pysfm_format_bal(
        obs_cam.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        obs_pt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_obs,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_vals,
        buf, cap,
    )
    if n < 0:
        return None  # capacity overflow (cannot happen with the bound above)
    return buf.raw[:n]

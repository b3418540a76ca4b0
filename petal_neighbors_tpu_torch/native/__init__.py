"""ctypes bindings for the port's native host builders
(``src/petal_native.cpp``, a copy of the JAX package's).

The library is compiled with ``g++`` at first use:

    g++ -O3 -fPIC -shared -std=c++17 -Wall \\
        -o <cache root>/<hash>/libpetal_native.so src/petal_native.cpp

into ``build/native/`` of the checkout the package runs from (else the
user's cache directory), keyed by a hash of the source, the flags and
``g++ --version``.  A failed compile raises: nothing falls back quietly to
the Python builders.  ``ball_build`` and ``vp_build`` raise ``ValueError``
for a metric with no native kind (only Euclidean, Cosine and Minkowski
have one); the trees check ``native_kind`` and take the Python builder
then.

The JAX package builds its copy with ``-march=native``, which lets g++
contract the distance loops into fused multiply-adds; this one is built
without it, so on real-valued data a VP-tree radius may differ from the
JAX package's native build in its last bit (equal where the arithmetic is
exact, as on small integers).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["ball_build", "vp_build", "native_kind", "lib_path"]

SRC = Path(__file__).resolve().parent / "src" / "petal_native.cpp"
#: no ``-march=native``: a cache directory may be shared by machines whose
#: CPUs differ, and the hash does not know the CPU
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_METRIC_KIND = {"euclidean": 0, "cosine": 1, "minkowski": 2}
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_lock = threading.Lock()
_lib = None


def _cache_root() -> Path:
    root = SRC.parents[3]
    if (root / "pyproject.toml").is_file() and (
            root / "petal_neighbors_tpu_torch").is_dir():
        return root / "build" / "native"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "petal_neighbors_tpu_torch" / "native"


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native builder cannot be "
                           "compiled")
    return cxx


@functools.lru_cache(maxsize=None)
def lib_path() -> Path:
    """``<cache root>/<hash>/libpetal_native.so``."""
    cxx = _cxx()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(subprocess.run([cxx, "--version"], capture_output=True,
                            text=True, check=True, timeout=60).stdout.encode())
    h.update(SRC.read_bytes())
    return _cache_root() / h.hexdigest()[:16] / "libpetal_native.so"


def _sig(lib, name, scalar, sp):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [sp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, scalar]
        + ([ctypes.c_int64, _I64P, sp, sp] if "ball" in name
           else [_I64P, sp, _I64P, _I64P,
                 ctypes.POINTER(ctypes.c_int64),
                 ctypes.POINTER(ctypes.c_int64)]))
    return fn


def _load():
    """The library, compiled at first use; raises if the compile fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".so.{os.getpid()}.tmp")
            out = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                                  str(SRC)], capture_output=True, text=True,
                                 timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for {SRC.name} (exit "
                                   f"{out.returncode}):\n{out.stderr}")
            # atomic: a concurrent process never loads a half-written file
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.ball_f32 = _sig(lib, "pn_ball_build_f32", ctypes.c_float, f32p)
        lib.ball_f64 = _sig(lib, "pn_ball_build_f64", ctypes.c_double, f64p)
        lib.vp_f32 = _sig(lib, "pn_vp_build_f32", ctypes.c_float, f32p)
        lib.vp_f64 = _sig(lib, "pn_vp_build_f64", ctypes.c_double, f64p)
        _lib = lib
        return _lib


def native_kind(metric) -> int | None:
    """The native builder's metric kind, or None where it has none."""
    return _METRIC_KIND.get(getattr(metric, "name", None))


def _metric_args(metric) -> tuple[int, float]:
    kind = native_kind(metric)
    if kind is None:
        raise ValueError(f"native builder does not support metric {metric!r}")
    return kind, float(getattr(metric, "p", 2.0))


def ball_build(points: np.ndarray, n_nodes: int, metric):
    """Reference-exact ball-tree build (the idx permutation with the
    quickselect tie order).  Returns (centroids, radii, idx)."""
    kind, p = _metric_args(metric)
    lib = _load()
    points = np.ascontiguousarray(points)
    n, d = points.shape
    idx = np.empty(n, dtype=np.int64)
    centroids = np.zeros((n_nodes, d), dtype=points.dtype)
    radii = np.zeros(n_nodes, dtype=points.dtype)
    fn = lib.ball_f64 if points.dtype == np.float64 else lib.ball_f32
    rc = fn(points, n, d, kind, p, n_nodes, idx, centroids.reshape(-1), radii)
    if rc != 0:
        raise RuntimeError(f"native ball build failed (rc={rc})")
    return centroids, radii, idx


def vp_build(points: np.ndarray, metric):
    """Reference-exact VP-tree build.  Returns (vp, radius, near, far,
    root, depth)."""
    kind, p = _metric_args(metric)
    lib = _load()
    points = np.ascontiguousarray(points)
    n, d = points.shape
    vp = np.zeros(n, dtype=np.int64)
    radius = np.zeros(n, dtype=points.dtype)
    near = np.full(n, -1, dtype=np.int64)
    far = np.full(n, -1, dtype=np.int64)
    root = ctypes.c_int64(-1)
    depth = ctypes.c_int64(0)
    fn = lib.vp_f64 if points.dtype == np.float64 else lib.vp_f32
    rc = fn(points, n, d, kind, p, vp, radius, near, far,
            ctypes.byref(root), ctypes.byref(depth))
    if rc != 0:
        raise RuntimeError(f"native vp build failed (rc={rc})")
    return vp, radius, near, far, int(root.value), int(depth.value)

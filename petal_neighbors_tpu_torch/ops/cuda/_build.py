"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <cache root>/<hash>/lib<name>.so csrc/<name>.cu

The output directory is keyed by a hash of every source in ``csrc/``, the
flags and ``nvcc --version``, so an edited source or another toolchain
rebuilds and an unchanged one is reused.  It lies under the checkout
(``build/kernels/``) when the package runs from one, and otherwise under
the user's cache (``$XDG_CACHE_HOME`` or ``~/.cache``).  ``build_all``
starts one ``nvcc`` per source, all together.  Libraries are loaded with
ctypes; pointers and the stream are passed as ``ctypes.c_void_p``.
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

__all__ = ["build_all", "load", "build_dir", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _cache_root() -> Path:
    """``build/kernels`` of the checkout the package runs from, else the
    user's cache directory."""
    root = CSRC.parents[3]
    if (root / "pyproject.toml").is_file() and (
            root / "petal_neighbors_tpu_torch").is_dir():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "petal_neighbors_tpu_torch" / "kernels"


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


@functools.lru_cache(maxsize=None)
def _nvcc_version(nvcc: str) -> str:
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout


def build_dir() -> Path:
    """``<cache root>/<hash of sources, flags and nvcc --version>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version(_nvcc()).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _cache_root() / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` not built yet, one ``nvcc`` per source,
    all started together.  Returns ``{name: compiler output}`` for the
    sources compiled by this call; raises if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [p for p in _sources() if p.suffix == ".cu"
            and not (out_dir / f"lib{p.stem}.so").exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            # atomic: a concurrent process never loads a half-written file
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib

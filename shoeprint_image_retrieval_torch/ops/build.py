"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries go to ``shoeprint_image_retrieval_torch/_build/``
(gitignored) at first use and are rebuilt when the source is newer. Nothing
here runs at import time: the CPU tests import every module of the port on
a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")


def compile_source(name: str) -> tuple[float, str]:
    """Compile ``csrc/{name}.cu`` to ``_build/lib{name}.so``; returns (seconds,
    compiler report). Writes under a per-process name and renames into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    report = proc.stdout.strip()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu ({proc.returncode}):\n{report}")
    os.replace(tmp, BUILD_DIR / f"lib{name}.so")
    return seconds, report


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/{name}.cu``, built if missing or stale."""
    with _lock:
        if name not in _loaded:
            src = CSRC / f"{name}.cu"
            so = BUILD_DIR / f"lib{name}.so"
            if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
                compile_source(name)
            _loaded[name] = ctypes.CDLL(str(so))
        return _loaded[name]

"""ctypes binding to the native host CLAHE in ``native/ingest.cc``.

The port reads the same C++ source as the JAX package but builds its own
copy of the library, at first use, into ``shoeprint_image_retrieval_torch/
_build/`` (never into ``native/``). Only the CLAHE entry points are bound:
they are bit-exact against ``cv2.createCLAHE(...).apply`` (the JAX package's
``tests/test_native.py``), and the main path runs CLAHE on the host
(``tpu.clahe_host = true``). There is no device CLAHE in the port yet, so a
library that cannot be built is an error, not a fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "ingest.cc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_SO = _BUILD / "libingest.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> None:
    """Compile ``ingest.cc`` (without the optional codec tier) to ``_SO``.

    ``-ffp-contract=off``: the CLAHE interpolation must round as separate
    float32 multiply and add, as cv2 does. The library is written under a
    per-process name and renamed into place, so concurrent builds (test
    workers) never load a half-written file.
    """
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"libingest.{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
           "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError("building the native CLAHE library needs g++") from exc
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f"g++ failed on {_SRC}:\n{exc.stderr}") from exc
    os.replace(tmp, _SO)


def load_library() -> ctypes.CDLL:
    """The native library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(_SO))
            sig = [
                ctypes.POINTER(ctypes.c_void_p),  # srcs
                ctypes.POINTER(ctypes.c_int),     # (h, w) per image
                ctypes.c_float,                   # clip limit
                ctypes.c_int,                     # tiles_y
                ctypes.c_int,                     # tiles_x
                ctypes.POINTER(ctypes.c_void_p),  # dsts
                ctypes.c_int,                     # n images
                ctypes.c_int,                     # n threads
            ]
            for fn in (lib.clahe_batch, lib.clahe_rgb_batch):
                fn.argtypes = sig
                fn.restype = None
            _lib = lib
        return _lib


def clahe_batch(
    images: Sequence[np.ndarray],
    clip_limit: float,
    tile_grid_size: tuple[int, int],
    n_threads: int = 8,
) -> list[np.ndarray]:
    """CLAHE a batch of uint8 images: (H, W) gray directly, (H, W, 3) RGB on
    the LAB L channel (reference network.py:197-208). A batch is all gray or
    all RGB. ``tile_grid_size`` is cv2's (width, height) order.

    Every image must have at least one pixel per tile on each axis: below
    that cv2 multi-reflects where the native code clamps, so such inputs are
    refused.
    """
    lib = load_library()
    tiles_x, tiles_y = tile_grid_size
    for im in images:
        if im.shape[0] < tiles_y or im.shape[1] < tiles_x:
            raise ValueError(
                f"clahe_batch: image {im.shape} smaller than the tile grid "
                f"({tiles_y}x{tiles_x} tiles)"
            )
    n = len(images)
    srcs = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    rgb = srcs[0].ndim == 3
    if any((s.ndim == 3) != rgb for s in srcs):
        raise ValueError("clahe_batch: mixed gray/RGB batch")
    dsts = [np.empty(s.shape, np.uint8) for s in srcs]
    src_ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
    dst_ptrs = (ctypes.c_void_p * n)(*[d.ctypes.data for d in dsts])
    hw = (ctypes.c_int * (2 * n))(*[v for s in srcs for v in s.shape[:2]])
    fn = lib.clahe_rgb_batch if rgb else lib.clahe_batch
    fn(src_ptrs, hw, ctypes.c_float(clip_limit), tiles_y, tiles_x, dst_ptrs, n, n_threads)
    return dsts

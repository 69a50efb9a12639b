"""ctypes binding to the native host-ingest library built from ``native/ingest.cc``.

The port reads the same C++ source as the JAX package but builds its own
copy of the library, at first use, into ``shoeprint_image_retrieval_torch/
_build/`` (never into ``native/``). Three groups of entry points:

* :func:`clahe_batch` — host CLAHE, bit-exact against
  ``cv2.createCLAHE(...).apply`` (gray) and cv2's LAB round trip (RGB);
* :func:`crop_resize_batch` — crop + PIL-exact Lanczos3 resize of 2-D uint8
  images (the JAX package's ``ingest_batch`` tier);
* :func:`ingest_files` — decode (8-bit gray JPEG/PNG) + crop + resize in one
  native call, present only when the build found the libjpeg/libpng
  headers (:func:`decode_available`).

The base library (CLAHE + crop/resize) is required: the loader's tiers and
the host CLAHE need it, so a library that cannot be built is an error. The
codec tier is optional, because every tier gives the same bytes: the build
tries it first and falls back to a build without it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "ingest.cc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_SO = _BUILD / "libingest.so"
_lock = threading.RLock()  # the decode self-check loads the library under it
_lib: ctypes.CDLL | None = None
_decode_ok: bool | None = None


def _build() -> None:
    """Compile ``ingest.cc`` to ``_SO``: with the codec tier
    (``-DSIR_HAVE_CODECS -ljpeg -lpng``) when the system has the libraries
    and the result loads (a machine may link against a ``libjpeg.so`` whose
    runtime library the loader cannot find), else without it, as the JAX
    package's ``_load`` does.

    ``-ffp-contract=off``: the CLAHE interpolation must round as separate
    float32 multiply and add, as cv2 does. The library is written under a
    per-process name and renamed into place, so concurrent builds (test
    workers) never load a half-written file.
    """
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"libingest.{os.getpid()}.tmp.so")
    base = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
            "-o", str(tmp), str(_SRC), "-lpthread"]
    codecs = base[:1] + ["-DSIR_HAVE_CODECS"] + base[1:] + ["-ljpeg", "-lpng"]
    try:
        built = subprocess.run(codecs, capture_output=True, text=True).returncode == 0
        if built:
            try:
                ctypes.CDLL(str(tmp))
            except OSError:
                built = False
        if not built:
            subprocess.run(base, check=True, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError("building the native ingest library needs g++") from exc
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f"g++ failed on {_SRC}:\n{exc.stderr}") from exc
    os.replace(tmp, _SO)


def _stale() -> bool:
    """The library is missing, or older than its source or than this
    module (which holds its build recipe)."""
    if not _SO.exists():
        return True
    built = _SO.stat().st_mtime
    return built < _SRC.stat().st_mtime or built < Path(__file__).stat().st_mtime


def load_library() -> ctypes.CDLL:
    """The native library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                _build()
            try:
                lib = ctypes.CDLL(str(_SO))
            except OSError:  # built on another machine, against libraries not here
                _build()
                lib = ctypes.CDLL(str(_SO))
            ptr, cint = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
            clahe_sig = [ptr, cint, ctypes.c_float, ctypes.c_int, ctypes.c_int, ptr,
                         ctypes.c_int, ctypes.c_int]
            for fn in (lib.clahe_batch, lib.clahe_rgb_batch):
                fn.argtypes = clahe_sig
                fn.restype = None
            # srcs, (h, w), (crop_h, crop_w), (out_h, out_w), dsts, n, n threads
            lib.ingest_batch.argtypes = [ptr, cint, cint, cint, ptr, ctypes.c_int, ctypes.c_int]
            lib.ingest_batch.restype = None
            lib.sir_has_codecs.argtypes = []
            lib.sir_has_codecs.restype = ctypes.c_int
            if lib.sir_has_codecs():
                # paths, (h, w), crops, out sizes, dsts, per-file status, n, n threads
                lib.ingest_files.argtypes = [ctypes.POINTER(ctypes.c_char_p), cint, cint, cint,
                                             ptr, cint, ctypes.c_int, ctypes.c_int]
                lib.ingest_files.restype = ctypes.c_int
            _lib = lib
        return _lib


def has_codecs() -> bool:
    """True when the library was built with native JPEG/PNG decode."""
    return bool(load_library().sir_has_codecs())


def _decode_self_check() -> bool:
    """One decode of a small Pillow-encoded JPEG through both decoders.

    The native JPEG tier is bit-exact against PIL only where the system
    libjpeg's IDCT agrees with the one Pillow bundles. Both outputs go
    through the same native crop/resize, so a difference is the decoder's;
    on one, the native decode tier is off for the process and the loader
    decodes with PIL (the JAX package's ``_decode_self_check``).
    """
    from PIL import Image

    src = np.random.default_rng(0).integers(0, 256, size=(48, 64), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="sir_decode_check_") as tmp:
        path = Path(tmp) / "check.jpg"
        Image.fromarray(src, mode="L").save(path, quality=90)
        with Image.open(path) as im:
            pil_px = np.asarray(im.convert("L"))
        h, w = pil_px.shape
        native = _ingest_files([path], [(h, w)], [(0, 0)], [(h, w)], 1)
    if native is None:
        return False
    return bool(np.array_equal(native[0], crop_resize_batch([pil_px], [(0, 0)], [(h, w)], 1)[0]))


def decode_available() -> bool:
    """True when the library decodes JPEG/PNG natively and its decode agreed
    with Pillow's on the one-time self-check."""
    global _decode_ok
    if not has_codecs():
        return False
    with _lock:
        if _decode_ok is None:
            _decode_ok = _decode_self_check()
        return _decode_ok


def _ingest_files(paths, src_hw, crops, out_sizes, n_threads) -> list[np.ndarray] | None:
    lib = load_library()
    n = len(paths)
    dsts = [np.empty(hw, np.uint8) for hw in out_sizes]
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_src = (ctypes.c_int * (2 * n))(*[int(v) for hw in src_hw for v in hw])
    c_crop = (ctypes.c_int * (2 * n))(*[int(v) for c in crops for v in c])
    c_dst = (ctypes.c_int * (2 * n))(*[int(v) for hw in out_sizes for v in hw])
    dst_ptrs = (ctypes.c_void_p * n)(*[d.ctypes.data for d in dsts])
    status = (ctypes.c_int * n)()
    bad = lib.ingest_files(c_paths, c_src, c_crop, c_dst, dst_ptrs, status, n, n_threads)
    return None if bad else dsts


def ingest_files(
    paths: Sequence[str | Path],
    src_hw: Sequence[tuple[int, int]],
    crops: Sequence[tuple[int, int]],
    out_sizes: Sequence[tuple[int, int]],
    n_threads: int = 8,
) -> list[np.ndarray] | None:
    """Decode (8-bit gray JPEG/PNG) + crop + PIL-exact Lanczos resize, one
    native call across ``n_threads`` threads.

    ``src_hw`` is each file's (h, w) from its header (the decode checks it),
    ``crops`` the (crop_h, crop_w) pixels removed from each edge,
    ``out_sizes`` the (out_h, out_w). Returns ``None`` when the native
    decode is not available or any file needs PIL (another format, bit
    depth or colour mode, a decode error): the caller then decodes the
    whole batch with PIL.
    """
    if not decode_available():
        return None
    return _ingest_files(paths, src_hw, crops, out_sizes, n_threads)


def crop_resize_batch(
    images: Sequence[np.ndarray],
    crops: Sequence[tuple[int, int]],
    out_sizes: Sequence[tuple[int, int]],
    n_threads: int = 8,
) -> list[np.ndarray]:
    """Crop + Lanczos3-resize 2-D uint8 images natively, bit-exact against
    PIL's ``crop(...).resize(..., LANCZOS)``.

    ``crops`` are per-image (crop_h, crop_w) pixel counts removed from each
    edge (the caller applies the reference's ``floor(ratio * dim)`` rule),
    ``out_sizes`` the per-image (out_h, out_w).
    """
    lib = load_library()
    srcs = [np.ascontiguousarray(im) for im in images]
    for s in srcs:
        if s.ndim != 2 or s.dtype != np.uint8:
            raise ValueError(f"crop_resize_batch takes 2-D uint8 images, got {s.dtype} {s.shape}")
    n = len(srcs)
    dsts = [np.empty(hw, np.uint8) for hw in out_sizes]
    src_ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
    dst_ptrs = (ctypes.c_void_p * n)(*[d.ctypes.data for d in dsts])
    src_hw = (ctypes.c_int * (2 * n))(*[v for s in srcs for v in s.shape])
    crop_hw = (ctypes.c_int * (2 * n))(*[int(v) for c in crops for v in c])
    dst_hw = (ctypes.c_int * (2 * n))(*[int(v) for hw in out_sizes for v in hw])
    lib.ingest_batch(src_ptrs, src_hw, crop_hw, dst_hw, dst_ptrs, n, n_threads)
    return dsts


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
    refused (the engine sends them to the device CLAHE, ``ops/clahe.py``).
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

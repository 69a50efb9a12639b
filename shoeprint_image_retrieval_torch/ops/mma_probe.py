"""The matrix-unit rate probe: wrapper around the CUDA kernel ``csrc/mma_probe.cu``.

Replaces ``benchmarks/mxu_probe.py::probe_pallas`` (the Pallas TPU kernel's
inner ``body``): for each of ``grid`` steps, ``y_iters`` products
``a (n, k) @ b (k, lanes)`` summed into an f32 accumulator, so
``out[s] = sum_y a @ b`` with ``out`` (grid, n, lanes) float32. The TPU body
carried one never-zeroed accumulator across grid steps; Hopper blocks run
in no order, so the kernel zeroes its accumulator and gives every grid step
its own output slice.

Precisions (:data:`PRECISIONS`): ``"f32"`` (FP32 FMA on the CUDA cores, the
JAX f32 leg at HIGHEST), ``"f32_3xtf32"`` (the same f32 product on the
tensor cores as 3xTF32 split precision) and ``"bf16"`` (bf16 inputs on the
tensor cores, f32 accumulation, the JAX bf16 leg).

:func:`mma_probe` takes the plain version :func:`probe_plain` only for
tensors on the CPU. For CUDA tensors it launches the kernel or raises; it
never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..device import set_float32_precision
from . import build

SOURCE = "shoeprint_image_retrieval_torch/csrc/mma_probe.cu"
REPLACES = "benchmarks/mxu_probe.py:34"

# precision -> (the kernel's template index, the input dtype it takes)
PRECISIONS: dict[str, tuple[int, torch.dtype]] = {
    "f32": (0, torch.float32),
    "f32_3xtf32": (1, torch.float32),
    "bf16": (2, torch.bfloat16),
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures bound."""
    lib = build.load("mma_probe")
    ptr = ctypes.c_void_p
    lib.mma_probe.argtypes = [ptr] * 3 + [ctypes.c_int] * 6 + [ptr]
    lib.mma_probe.restype = ctypes.c_int
    lib.mma_probe_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    lib.mma_probe_tile.restype = None
    lib.mma_probe_error_string.argtypes = [ctypes.c_int]
    lib.mma_probe_error_string.restype = ctypes.c_char_p
    return lib


def probe_flop(n: int, k: int, lanes: int, y_iters: int, grid: int) -> float:
    """Operations of one probe call, as FLOP (a multiply-add is two)."""
    return 2.0 * n * k * lanes * y_iters * grid


def tile_geometry() -> dict:
    """The kernel's block tile and threads (from the library itself), with
    the bytes it stages per FLOP in each input dtype: (BM + BN) * BK
    elements per 2 * BM * BN * BK FLOP."""
    lib = _library()
    bm, bn, bk, thr = (ctypes.c_int() for _ in range(4))
    lib.mma_probe_tile(ctypes.byref(bm), ctypes.byref(bn), ctypes.byref(bk), ctypes.byref(thr))
    per_flop = (bm.value + bn.value) / (2.0 * bm.value * bn.value)
    return {"tile": [bm.value, bn.value, bk.value], "threads": thr.value,
            "bytes_per_flop": {"f32": 4 * per_flop, "bf16": 2 * per_flop}}


def _check(a: torch.Tensor, b: torch.Tensor, y_iters: int, grid: int, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"mma_probe: unknown precision {precision!r} (one of {sorted(PRECISIONS)})")
    dtype = PRECISIONS[precision][1]
    for name, t in (("a", a), ("b", b)):
        if t.dtype != dtype:
            raise TypeError(f"mma_probe: {name} is {t.dtype}, {precision} takes {dtype}")
        if t.dim() != 2:
            raise ValueError(f"mma_probe: {name} must be 2-D, got shape {tuple(t.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"mma_probe: a {tuple(a.shape)} and b {tuple(b.shape)} do not chain")
    if a.device != b.device:
        raise ValueError(f"mma_probe: a is on {a.device}, b on {b.device}")
    if y_iters < 0 or grid < 1:
        raise ValueError(f"mma_probe: y_iters={y_iters} must be >= 0 and grid={grid} >= 1")


def probe_plain(a: torch.Tensor, b: torch.Tensor, y_iters: int, grid: int) -> torch.Tensor:
    """The plain version: ``y_iters`` f32 ``torch.matmul`` calls of the
    (grid, n, k) stack against ``b``, summed -> (grid, n, lanes) float32.

    TF32 is off, so the products are full f32. bf16 inputs are exact in
    f32, so the bf16 leg computes on the bf16-rounded values, as the
    tensor cores do.
    """
    set_float32_precision()
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    stack = a32.expand(grid, *a32.shape)
    acc = torch.zeros((grid, a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for _ in range(y_iters):
        acc = acc + torch.matmul(stack, b32)
    return acc


def launch_mma(a: torch.Tensor, b: torch.Tensor, y_iters: int, grid: int,
               precision: str) -> torch.Tensor:
    """Run the kernel -> (grid, n, lanes) float32. ``a``, ``b`` contiguous on
    one CUDA device in the precision's input dtype. Launches on the current
    stream without synchronising."""
    _check(a, b, y_iters, grid, precision)
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"mma_probe: {name} is on {t.device}, expected a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"mma_probe: {name} is not contiguous")
    (n, k), lanes = a.shape, b.shape[1]
    lib = _library()
    dev = a.device
    out = torch.empty((grid, n, lanes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mma_probe(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, k, lanes,
                           int(y_iters), int(grid), PRECISIONS[precision][0],
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mma_probe kernel launch failed: "
                           f"{lib.mma_probe_error_string(rc).decode()} ({rc})")
    launch_mma.launches += 1
    return out


launch_mma.launches = 0  # kernel launches since the caller last reset it


def mma_probe(a: torch.Tensor, b: torch.Tensor, y_iters: int, grid: int,
              precision: str) -> torch.Tensor:
    """``out[s] = sum_{y < y_iters} a @ b`` for ``s < grid``, float32.

    CPU tensors go through the plain version; CUDA tensors through the
    kernel.
    """
    if a.device.type == "cpu":
        _check(a, b, y_iters, grid, precision)
        return probe_plain(a, b, y_iters, grid)
    return launch_mma(a, b, y_iters, grid, precision)

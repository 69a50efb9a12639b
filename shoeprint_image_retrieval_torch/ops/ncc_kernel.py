"""The fused NCC scorer: wrapper around the CUDA kernel ``csrc/ncc_score.cu``.

Replaces ``shoeprint_image_retrieval_tpu/ops/pallas/ncc_kernel.py::
score_packed_operands`` (the Pallas TPU kernel). The TPU operand packing
(lane packing, edge-extended integrals, band-matrix epilogue, per-class tap
canvases) has no Hopper meaning and is not carried over; the kernel reads
the cache in its natural channel-major layout and the variant stack
transposed to (C_pad, N, hk, wk).

:func:`score_ncc` takes the plain version (``ops/ncc_direct.score_direct``)
only for tensors on the CPU. For CUDA tensors it launches the kernel or
raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .ncc_direct import (
    DirectGalleryCache,
    PackedVariants,
    VariantLayout,
    row_slots,
    score_direct,
)

SOURCE = "shoeprint_image_retrieval_torch/csrc/ncc_score.cu"
REPLACES = "shoeprint_image_retrieval_tpu/ops/pallas/ncc_kernel.py:963"


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures bound."""
    lib = build.load("ncc_score")
    ptr = ctypes.c_void_p
    lib.ncc_score.argtypes = [ptr] * 8 + [ctypes.c_int] * 8 + [ptr]
    lib.ncc_score.restype = ctypes.c_int
    lib.ncc_score_geometry.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.ncc_score_geometry.restype = ctypes.c_int
    lib.ncc_error_string.argtypes = [ctypes.c_int]
    lib.ncc_error_string.restype = ctypes.c_char_p
    return lib


def kernel_operands(
    cache: DirectGalleryCache,
    packed: PackedVariants,
    layout: VariantLayout,
    slot_hw: torch.Tensor | None = None,
    slot_map: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's own layout: taps (C_pad, N, hk, wk) and each row's
    post-crop window (N, 2) int32."""
    c_pad = cache.p0.shape[0]
    kernels = packed.kernels
    if kernels.shape[1] != c_pad:
        kernels = F.pad(kernels, (0, 0, 0, 0, 0, c_pad - kernels.shape[1]))
    slots, row_slot = row_slots(packed, layout, slot_hw, slot_map)
    row_hw = slots[row_slot].to(torch.int32).contiguous()
    return kernels.transpose(0, 1).contiguous(), row_hw


def launch_ncc(
    p0: torch.Tensor,
    int1: torch.Tensor,
    int2: torch.Tensor,
    kern: torch.Tensor,
    row_hw: torch.Tensor,
    gvalid: torch.Tensor,
    true_channels: int,
) -> torch.Tensor:
    """Run the kernel on operands already in its layout -> (N, G) f32.

    p0 (C, G, Hb, Wb), int1/int2 (C, G, Hb+1, Wb+1), kern (C, N, hk, wk):
    float32; row_hw (N, 2), gvalid (G, 2): int32; all contiguous on one CUDA
    device. Launches on the current stream without synchronising.
    """
    c, g, hb, wb = p0.shape
    n, hk, wk = kern.shape[1], kern.shape[2], kern.shape[3]
    expect = {
        "p0": (p0, torch.float32, (c, g, hb, wb)),
        "int1": (int1, torch.float32, (c, g, hb + 1, wb + 1)),
        "int2": (int2, torch.float32, (c, g, hb + 1, wb + 1)),
        "kern": (kern, torch.float32, (c, n, hk, wk)),
        "row_hw": (row_hw, torch.int32, (n, 2)),
        "gvalid": (gvalid, torch.int32, (g, 2)),
    }
    dev = p0.device
    for name, (t, dtype, shape) in expect.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"score_ncc: {name} is on {t.device}, expected {dev} (CUDA)")
        if t.dtype != dtype:
            raise TypeError(f"score_ncc: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"score_ncc: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"score_ncc: {name} is not contiguous")
    if not 0 < true_channels <= c:
        raise ValueError(f"score_ncc: true_channels={true_channels} outside (0, {c}]")
    lib = _library()
    out = torch.empty((n, g), dtype=torch.float32, device=dev)
    best = torch.empty((n, g), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.ncc_score(
            p0.data_ptr(), int1.data_ptr(), int2.data_ptr(), kern.data_ptr(),
            row_hw.data_ptr(), gvalid.data_ptr(), best.data_ptr(), out.data_ptr(),
            c, g, n, hb, wb, hk, wk, int(true_channels), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ncc_score kernel launch failed: {lib.ncc_error_string(rc).decode()} ({rc})")
    launch_ncc.launches += 1
    return out


launch_ncc.launches = 0  # kernel launches since the caller last reset it


def launch_geometry(hb: int, wb: int, hk: int, wk: int) -> dict:
    """The kernel's block shape and shared memory for these sizes (from the
    library itself, so the report matches what runs)."""
    lib = _library()
    nt, ty, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_longlong()
    rc = lib.ncc_score_geometry(hb, wb, hk, wk, ctypes.byref(nt), ctypes.byref(ty),
                                ctypes.byref(threads), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"no launch geometry for Hb={hb} Wb={wb} hk={hk} wk={wk}")
    return {"rows_per_block": nt.value, "y_per_block": ty.value,
            "threads": threads.value, "smem_bytes": smem.value}


def score_ncc(
    cache: DirectGalleryCache,
    packed: PackedVariants,
    layout: VariantLayout,
    true_channels: int,
    slot_hw: torch.Tensor | None = None,
    slot_map: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused NCC scores (N, G) f32, the same quantity as ``score_direct``.

    CPU tensors go through the plain version; CUDA tensors through the
    kernel.
    """
    if cache.p0.device.type == "cpu":
        return score_direct(cache, packed, layout, true_channels, slot_hw, slot_map)
    kern, row_hw = kernel_operands(cache, packed, layout, slot_hw, slot_map)
    return launch_ncc(
        cache.p0, cache.int1, cache.int2, kern, row_hw,
        cache.valid_hw.to(torch.int32).contiguous(), true_channels,
    )

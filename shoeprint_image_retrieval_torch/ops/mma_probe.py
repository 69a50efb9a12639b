"""The matrix-unit rate probe: wrapper around the CUDA kernel ``csrc/mma_probe.cu``.

Replaces ``benchmarks/mxu_probe.py::probe_pallas`` (the Pallas TPU kernel's
inner ``body``, ``benchmarks/mxu_probe.py:34``): for each of ``grid`` steps,
``y_iters`` products ``a (n, k) @ b (k, lanes)`` summed into an f32
accumulator, so ``out[s] = sum_y a @ b`` with ``out`` (grid, n, lanes)
float32. The TPU body carried one never-zeroed accumulator across grid steps;
Hopper blocks run in no order, so every tile of the kernel sums from zero and
every grid step has its own output slice.

Precisions (:data:`PRECISIONS`): ``"f32"`` (FP32 FMA on the CUDA cores, the
JAX f32 leg at HIGHEST), ``"f32_3xtf32"`` (the same f32 product on the
tensor cores as 3xTF32 split precision) and ``"bf16"`` (bf16 inputs on the
tensor cores, f32 accumulation, the JAX bf16 leg).

The design (the source note in ``csrc/mma_probe.cu`` has the detail): a
persistent, warp-specialised kernel. :func:`pack_operands` packs both
operands once a call, K-major and zero-padded in K to whole 128-byte chunks,
because TMA needs 16-byte row strides and TF32 ``wgmma`` reads only K-major
operands; the packing is inside the timed call and adds exact zeros. One
producer warp streams 128 x 128 tiles of both through TMA into an
``mbarrier``-guarded ring, and two consumer warpgroups multiply them with
``wgmma`` (FMA for f32). A cluster of two blocks takes the same tile of two
grid steps and shares every stage through TMA multicast; persistent clusters
walk the tiles, each tile's products cut into equal parts where that evens
the last round (:func:`launch_plan`). Each y-iteration's product takes a
fresh accumulator and joins its part's total with an FP32 add; the parts
meet in order. What bounds it: the tensor cores' rate or L2, which streams
every K chunk of both operands again for every product (:func:`l2_bytes`).

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
TILE = (128, 128)      # rows, lanes of one block tile (the library reports the same)
CLUSTER = 2            # blocks a cluster: the tiles of two grid steps share every stage
CHUNK_BYTES = 128      # one K chunk of one tile row: 64 bf16 or 32 f32 values
# operand planes a leg streams: 3xTF32 reads a hi and a lo plane of each
PLANES = {"f32": 1, "f32_3xtf32": 2, "bf16": 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures bound."""
    lib = build.load("mma_probe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mma_probe.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.mma_probe.restype = i32
    lib.mma_probe_geometry.argtypes = [i32, ctypes.POINTER(i32)]
    lib.mma_probe_geometry.restype = i32
    lib.mma_probe_plan.argtypes = [i32] * 6 + [ctypes.POINTER(i32)] * 2 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.mma_probe_plan.restype = i32
    lib.mma_probe_error_string.argtypes = [i32]
    lib.mma_probe_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"mma_probe {what} failed: {lib.mma_probe_error_string(rc).decode()} ({rc})")


def probe_flop(n: int, k: int, lanes: int, y_iters: int, grid: int) -> float:
    """Operations of one probe call, as FLOP (a multiply-add is two)."""
    return 2.0 * n * k * lanes * y_iters * grid


def k_chunk(precision: str) -> int:
    """K values in one 128-byte chunk of the precision's input dtype."""
    return CHUNK_BYTES // PRECISIONS[precision][1].itemsize


def padded_depth(k: int, precision: str) -> int:
    """K rounded up to whole chunks: the packed operands' row length."""
    kc = k_chunk(precision)
    return -(-k // kc) * kc


def l2_bytes(n: int, k: int, lanes: int, y_iters: int, grid: int, precision: str) -> int:
    """Bytes the kernel's TMA loads stream from L2 in one call: for every
    tile, y-iteration and K chunk, the tile's in-bounds rows of A and lanes
    of B (TMA does not read the zero-filled edges), 128 bytes a row and
    plane, once for each cluster's pair of grid steps (the multicast writes
    them into both blocks). The packing, the 3xTF32 split pass and the
    parts' sums are not counted."""
    bm, bn = TILE
    m_tiles, n_tiles = -(-n // bm), -(-lanes // bn)
    chunks = padded_depth(k, precision) // k_chunk(precision)
    # summed over tiles, the A rows are n per lane tile and the B rows lanes per row tile
    rows = n * n_tiles + lanes * m_tiles
    pairs = -(-grid // CLUSTER)
    return pairs * y_iters * chunks * CHUNK_BYTES * PLANES[precision] * rows


def tile_geometry() -> dict:
    """The launch geometry of every leg, read from the library: block tile
    (rows, lanes, K values a chunk), ring stages, consumer warpgroups,
    threads and shared memory a block, blocks a cluster, with the bytes a
    block's tile needs per FLOP (the cluster streams them once for two
    blocks)."""
    lib = _library()
    legs = {}
    for precision, (index, dtype) in PRECISIONS.items():
        geo = (ctypes.c_int * 8)()
        _raise(lib, lib.mma_probe_geometry(index, geo), "geometry")
        bm, bn, bk, stages, consumers, threads, smem, cluster = geo
        legs[precision] = {
            "tile": [bm, bn, bk], "stages": stages, "consumer_warpgroups": consumers,
            "threads": threads, "smem_bytes": smem, "cluster": cluster,
            "bytes_per_flop": PLANES[precision] * dtype.itemsize * (bm + bn) / (2.0 * bm * bn)}
    return legs


def launch_plan(n: int, k: int, lanes: int, y_iters: int, grid: int, precision: str) -> dict:
    """How the library runs one call on the current device: ``blocks``, a
    cluster of :data:`CLUSTER` for each of min(units, the clusters the card
    holds at once); ``parts``, the equal parts each tile's products are cut
    into when that evens the last round of units (a unit is one part of one
    tile of a pair of grid steps); and the ``scratch_bytes`` it needs (the
    3xTF32 planes, the parts' sums)."""
    lib = _library()
    blocks, parts, scratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    _raise(lib, lib.mma_probe_plan(PRECISIONS[precision][0], n, padded_depth(k, precision), lanes,
                                   y_iters, grid, ctypes.byref(blocks), ctypes.byref(parts),
                                   ctypes.byref(scratch)), "plan")
    return {"blocks": blocks.value, "parts": parts.value, "scratch_bytes": scratch.value}


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


def pack_operands(a: torch.Tensor, b: torch.Tensor, precision: str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``a_p`` (n, Kp) and ``bt_p`` (lanes, Kp): both operands K-major, zero
    past ``k``, ``Kp`` = :func:`padded_depth`. ``a_p @ bt_p.T`` is ``a @ b``
    plus exact zeros."""
    (n, k), lanes = a.shape, b.shape[1]
    kp = padded_depth(k, precision)
    a_p = a.new_zeros((n, kp))
    a_p[:, :k] = a
    bt_p = b.new_zeros((lanes, kp))
    bt_p[:, :k] = b.t()
    return a_p, bt_p


def check_packed(*operands: torch.Tensor) -> None:
    """Raise unless every operand is what TMA reads: rows contiguous, the
    base 16-byte aligned and the row stride a multiple of 16 bytes."""
    for t in operands:
        size = t.element_size()
        if t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"mma_probe: a packed operand must be 2-D with contiguous rows, "
                             f"got shape {tuple(t.shape)} strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"mma_probe: a packed operand's base {t.data_ptr():#x} "
                             f"is not 16-byte aligned")
        if t.stride(0) * size % 16:
            raise ValueError(f"mma_probe: a packed operand's row stride of "
                             f"{t.stride(0) * size} bytes is no multiple of 16")


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
    one CUDA device in the precision's input dtype. Packs them and launches
    on the current stream without synchronising."""
    _check(a, b, y_iters, grid, precision)
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"mma_probe: {name} is on {t.device}, expected a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"mma_probe: {name} is not contiguous")
    (n, _), lanes = a.shape, b.shape[1]
    lib = _library()
    dev = a.device
    with torch.cuda.device(dev):
        a_p, bt_p = pack_operands(a, b, precision)
        check_packed(a_p, bt_p)
        kp = a_p.shape[1]
        # the 3xTF32 hi and lo planes and the parts' sums, written by the library
        size = launch_plan(n, kp, lanes, y_iters, grid, precision)["scratch_bytes"]
        scratch = torch.empty(size, dtype=torch.uint8, device=dev) if size else None
        out = torch.empty((grid, n, lanes), dtype=torch.float32, device=dev)
        rc = lib.mma_probe(a_p.data_ptr(), bt_p.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), out.data_ptr(), n, kp,
                           lanes, int(y_iters), int(grid), PRECISIONS[precision][0],
                           torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, rc, "kernel launch")
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

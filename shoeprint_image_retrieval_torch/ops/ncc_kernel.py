"""The fused NCC scorer: wrapper around the CUDA kernel ``csrc/ncc_score.cu``.

Replaces ``shoeprint_image_retrieval_tpu/ops/pallas/ncc_kernel.py::
score_packed_operands`` (the Pallas TPU kernel). The TPU operand packing
(lane packing, edge-extended integrals, band-matrix epilogue) has no Hopper
meaning and is not carried over; the kernel reads the cache in its natural
channel-major layout and the variant stack in the engine's (N, C, hk, wk)
layout.

The kernel is a warp-specialised tensor-core implicit GEMM over tiles of
variant rows (a producer warpgroup keeps a ring of tap chunks and the next
channel's patch ready; two consumer warpgroups issue the products), in two
legs (:data:`PRECISIONS`): 3xTF32, the f32 product and the default, and
bf16 for ``tpu.precision = "bfloat16"`` (the JAX kernel's ``compute_dtype =
bfloat16``: both operands of the correlation rounded to bf16, f32
accumulation, f32 window energies). Both legs read the same f32 operands
and round or split them as they stage them, so the memory models of a
scoring call (:func:`probe_row_bytes`, :func:`gallery_block_bytes_per_print`)
hold for both. Its block tile lives in the CUDA source alone and is read
from the built library (:func:`kernel_tile`). The tile plan is made on the host in
two halves: :func:`row_plan` (once per variant batch) orders the rows by
post-crop window and gives each tile the centred tap rectangle that holds
every nonzero tap of its rows, as the JAX package's ``derive_class_taps``
does per class; :func:`print_plan` (once per gallery block) bounds the
prints' position blocks. The kernel scatters its results back to the
engine's row order, so callers see the same (N, G) matrix.
:func:`executed_flop` counts what the kernel then executes, by a host
model of its blocks.

:func:`score_ncc` takes the plain version (``ops/ncc_direct.score_direct``)
only for tensors on the CPU, in the same compute dtype. For CUDA tensors
it launches the kernel's leg for that dtype or raises; it never falls back,
neither to the plain version nor from one leg to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .boxsum import EDGE_CROP
from .ncc_direct import (
    CHANNEL_BLOCK,
    DirectGalleryCache,
    PackedVariants,
    VariantLayout,
    row_slots,
    score_direct,
)

SOURCE = "shoeprint_image_retrieval_torch/csrc/ncc_score.cu"
REPLACES = "shoeprint_image_retrieval_tpu/ops/pallas/ncc_kernel.py:963"
# the kernel's legs: their codes in the C interface and their routes
PRECISIONS = {"f32_3xtf32": 0, "bf16": 1}
ROUTE = {"f32_3xtf32": "wgmma m64n64k8 3xTF32 (A from registers), producer/consumer ring",
         "bf16": "wgmma m64n64k16 bf16, f32 accumulation (A from registers), "
                 "producer/consumer ring"}
# the compute dtype of a scoring call -> the leg that serves it, and back
LEG_OF_DTYPE = {torch.float32: "f32_3xtf32", torch.bfloat16: "bf16"}
DTYPE_OF_LEG = {leg: dtype for dtype, leg in LEG_OF_DTYPE.items()}
# the 3xTF32 leg's patch layouts a caller may ask for: the kernel's own
# choice (the split patch where it fits, else the float patch), or one of
# them only; the bf16 leg has one layout, "auto"
PATCHES = {"auto": -1, "float": 0, "split": 1}
# the layout codes ncc_score_geometry reports
LAYOUTS = ("float", "split", "bf16")


class Tile(NamedTuple):
    """The kernel's block tile, as ``ncc_score_tile`` reports it."""

    rows: int       # variant rows per tile
    positions: int  # output positions of one print per block
    taps: int       # taps per staged chunk


class Roles(NamedTuple):
    """One leg's warpgroups, as ``ncc_score_roles`` reports them: threads
    per block, producer and consumer warpgroups, and the registers
    ``setmaxnreg`` gives a thread of each."""

    threads: int
    producers: int
    consumers: int
    producer_regs: int
    consumer_regs: int


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures bound."""
    lib = build.load("ncc_score")
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.ncc_score.argtypes = [ptr] * 8 + [cint] * 13 + [ptr]
    lib.ncc_score.restype = cint
    lib.ncc_score_geometry.argtypes = [cint] * 7 + [ctypes.POINTER(cint)] * 3 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.ncc_score_geometry.restype = cint
    lib.ncc_score_tile.argtypes = [ctypes.POINTER(cint)] * 3
    lib.ncc_score_tile.restype = None
    lib.ncc_score_roles.argtypes = [cint] + [ctypes.POINTER(cint)] * 5
    lib.ncc_score_roles.restype = cint
    lib.ncc_error_string.argtypes = [cint]
    lib.ncc_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def kernel_tile() -> Tile:
    """The block tile of the kernel as built (``csrc/ncc_score.cu`` is its
    only source)."""
    vals = [ctypes.c_int() for _ in range(3)]
    _library().ncc_score_tile(*[ctypes.byref(v) for v in vals])
    return Tile(*(v.value for v in vals))


@functools.cache
def kernel_roles(precision: str = "f32_3xtf32") -> Roles:
    """The producer and consumer warpgroups of one leg of the kernel as
    built."""
    vals = [ctypes.c_int() for _ in range(5)]
    rc = _library().ncc_score_roles(PRECISIONS[precision], *[ctypes.byref(v) for v in vals])
    if rc != 0:
        raise ValueError(f"no roles for precision {precision!r}")
    return Roles(*(v.value for v in vals))


class RowPlan(NamedTuple):
    """The rows' half of the tile plan, made once per variant batch.

    order: (N,) int64 — kernel row r holds engine row ``order[r]``; rows
        sorted by post-crop window, largest first.
    taps: (T, 4) int32 — each tile's tap rectangle on the (hk, wk) canvas,
        ``(i0, h, j0, w)``: rows ``[i0, i0 + h)``, columns ``[j0, j0 + w)``.
    slots: (N,) int32 — kernel row r's window is ``windows[r // m_tile,
        slots[r]]``.
    windows: (T, U, 2) int32 — each tile's distinct windows, tallest first,
        padded with 1 x 1; U is the most any tile holds.
    m_tile: rows per tile.
    table: the plan as the kernel reads it, one int32 tensor on the
        launch's device (:meth:`host_table`).
    """

    order: np.ndarray
    taps: np.ndarray
    slots: np.ndarray
    windows: np.ndarray
    m_tile: int
    table: torch.Tensor

    def host_table(self) -> np.ndarray:
        """order, slots, (i0, h, j0, w, distinct windows) per tile and the
        windows, as one int32 array."""
        # a tile's slots rise along its rows: its last row's slot counts them
        last = np.minimum(np.arange(1, len(self.taps) + 1) * self.m_tile, len(self.order)) - 1
        counts = self.slots[last] + 1
        return np.concatenate([
            self.order.astype(np.int32), self.slots.astype(np.int32),
            np.concatenate([self.taps, counts[:, None]], axis=1).reshape(-1),
            self.windows.reshape(-1),
        ]).astype(np.int32)


class PrintPlan(NamedTuple):
    """The prints' half of the tile plan, made once per gallery block.

    n_chunks: blocks of the tile's positions per print (the most any print
        needs).
    span: print rows one block's positions cover, at most.
    """

    n_chunks: int
    span: int


def row_plan(row_hw: np.ndarray, kernel_hw: tuple[int, int], m_tile: int,
             device: torch.device | str = "cpu") -> RowPlan:
    """Order rows by window and give each tile of ``m_tile`` rows its tap
    rectangle.

    ``row_hw`` (N, 2): each row's post-crop window (``row_slots``). A folded
    template is zero outside its window centred on the canvas
    (``fold_template``), so a tile's nonzero taps lie in the centred
    ``(max h, max w)`` sub-rectangle, clipped to ``[1, hk] x [1, wk]``.
    """
    row_hw = np.asarray(row_hw, np.int64).reshape(-1, 2)
    hk, wk = (int(v) for v in kernel_hw)
    order = np.argsort(-(row_hw[:, 0] * (row_hw[:, 1].max(initial=0) + 1) + row_hw[:, 1]),
                       kind="stable")
    n = len(order)
    n_tiles = -(-n // m_tile)
    hw = np.ones((n_tiles * m_tile, 2), np.int64)
    hw[:n] = row_hw[order]
    hw = hw.reshape(n_tiles, m_tile, 2).max(axis=1)
    h = np.clip(hw[:, 0], 1, hk)
    w = np.clip(hw[:, 1], 1, wk)
    taps = np.stack([hk // 2 - h // 2, h, wk // 2 - w // 2, w], axis=1).astype(np.int32)

    # each tile's distinct windows: sorted rows hold equal windows together
    sorted_hw = row_hw[order]
    tile_of = np.arange(n) // m_tile
    new = np.ones(n, bool)
    new[1:] = (tile_of[1:] != tile_of[:-1]) | (sorted_hw[1:] != sorted_hw[:-1]).any(axis=1)
    rank = np.cumsum(new) - 1
    slots = (rank - rank[tile_of * m_tile]).astype(np.int32)
    windows = np.ones((n_tiles, int(slots.max(initial=0)) + 1, 2), np.int32)
    windows[tile_of[new], slots[new]] = sorted_hw[new]
    plan = RowPlan(order, taps, slots, windows, m_tile, torch.empty(0))
    table = torch.from_numpy(plan.host_table()).to(device, non_blocking=True)
    return plan._replace(table=table)


def print_plan(gvalid: np.ndarray, n_tile: int) -> PrintPlan:
    """Bound the position blocks of prints of post-crop valid sizes
    ``gvalid`` (G, 2), :data:`n_tile` positions a block."""
    first, last, live = _position_chunks(gvalid, n_tile)
    span = int(np.where(live, last[..., 0] - first[..., 0] + 1, 0).max(initial=0))
    return PrintPlan(max(1, first.shape[1]), span)


def patch_rows(prints: PrintPlan, hk: int) -> int:
    """Print rows one block holds at most: its positions' rows plus the
    taps' rows."""
    return max(1, prints.span + hk - 1)


def _position_chunks(gvalid: np.ndarray, n_tile: int):
    """(first (G, Q, 2), last (G, Q, 2), live (G, Q)): the (y, x) of the
    first and last position of each print's chunks of ``n_tile`` valid
    positions (row-major over the valid region) and which chunks exist."""
    gv = np.asarray(gvalid, np.int64).reshape(-1, 2)
    npos = gv[:, 0] * gv[:, 1]
    q = np.arange(int(-(-npos.max(initial=0) // n_tile)))[None, :]
    live = q * n_tile < npos[:, None]
    vw = np.maximum(gv[:, 1:2], 1)
    p_first = q * n_tile
    p_last = np.minimum(p_first + n_tile, npos[:, None]) - 1
    first = np.stack([p_first // vw, p_first % vw], axis=-1)
    last = np.stack([p_last // vw, p_last % vw], axis=-1)
    return first, last, live


def block_taps(rows: RowPlan, gvalid: np.ndarray, kernel_hw: tuple[int, int],
               tile: Tile) -> tuple[np.ndarray, np.ndarray]:
    """(K (T, G, Q), live (G, Q)): the taps K of every (tile, print, position
    chunk) block, as the kernel clips them (the tile's rectangle cut to the
    tap rows and columns that reach the print's valid region from one of the
    block's positions), and which blocks exist. The canvas centre tap lies
    in every tile's rectangle and reaches every position, so a live block
    keeps K >= 1."""
    hk, wk = (int(v) for v in kernel_hw)
    gv = np.asarray(gvalid, np.int64).reshape(-1, 2)
    first, last, live = _position_chunks(gv, tile.positions)
    i0, h, j0, w = (rows.taps[:, k].astype(np.int64)[:, None, None] for k in range(4))
    vh, vw = gv[None, :, 0, None], gv[None, :, 1, None]
    y_first, y_last = first[None, ..., 0], last[None, ..., 0]
    i_lo = np.maximum(i0, hk // 2 - y_last)
    i_hi = np.minimum(i0 + h - 1, vh - 1 + hk // 2 - y_first)
    j_lo = np.maximum(j0, wk // 2 - (vw - 1))
    j_hi = np.minimum(j0 + w - 1, vw - 1 + wk // 2)
    return np.maximum(i_hi - i_lo + 1, 0) * np.maximum(j_hi - j_lo + 1, 0), live


def executed_flop(rows: RowPlan, gvalid: np.ndarray, channels: int,
                  kernel_hw: tuple[int, int], tile: Tile) -> float:
    """FLOP the kernel executes for this plan, by a host model of its
    blocks: for every (tile, print, position chunk) block, 2 x rows x
    positions x its taps (:func:`block_taps`) rounded up to whole chunks,
    per channel. A 3xTF32 product counts once (its three tensor-core
    products are one f32 product). Both legs stage the same 32-tap chunks
    (the bf16 leg as two k16 steps, the 3xTF32 leg as four k8 steps; a
    block's taps run on across tap rows, so only its last chunk is padded),
    so the count holds for both."""
    k, live = block_taps(rows, gvalid, kernel_hw, tile)
    k_pad = -(-k // tile.taps) * tile.taps
    return (2.0 * tile.rows * tile.positions * channels
            * float(np.where(live[None], k_pad, 0).sum()))


def window_taps(extent: int, canvas: int):
    """(extent + 1, canvas + 1) table: for a window of size ``k`` centred as
    the box sums centre it (``[y - k//2, y + (k-1)//2]``) and a print of
    valid size ``v``, the taps that land inside the print, summed over the
    print's valid output positions ``y < v``."""
    k = np.arange(extent + 1)[:, None, None]
    v = np.arange(canvas + 1)[None, :, None]
    y = np.arange(canvas)[None, None, :]
    lo = np.maximum(y - k // 2, 0)
    hi = np.minimum(y + (k - 1) // 2, v - 1)
    return np.where(y < v, np.maximum(hi - lo + 1, 0), 0).sum(axis=-1).astype(np.float64)


def needed_flop(row_hw, gvalid, c: int, canvas_hw: tuple[int, int]) -> float:
    """Multiply-adds the correlation needs on these inputs, as FLOP: for each
    (row, print, channel), the row's window taps that overlap the print's
    valid region, over the print's valid output positions. Taps that fall on
    the zero padding around a print are not counted."""
    hmax, wmax = int(row_hw[:, 0].max()), int(row_hw[:, 1].max())
    th, tw = window_taps(hmax, canvas_hw[0]), window_taps(wmax, canvas_hw[1])
    fh = th[row_hw[:, 0][:, None], gvalid[:, 0][None, :]]  # (N, G)
    fw = tw[row_hw[:, 1][:, None], gvalid[:, 1][None, :]]
    return 2.0 * c * float((fh * fw).sum())


def launch_ncc(
    p0: torch.Tensor,
    int1: torch.Tensor,
    int2: torch.Tensor,
    kern: torch.Tensor,
    gvalid: torch.Tensor,
    rows: RowPlan,
    prints: PrintPlan,
    true_channels: int,
    patch: str = "auto",
    precision: str = "f32_3xtf32",
) -> torch.Tensor:
    """Run the kernel on operands already in its layout -> (N, G) f32.

    p0 (C_pad, G, Hb, Wb), int1/int2 (C_pad, G, Hb+1, Wb+1), kern
    (N, C, hk, wk) with C <= C_pad: float32; gvalid (G, 2) int32; all
    contiguous on one CUDA device. ``rows`` is :func:`row_plan` of the
    rows' windows with the kernel's tile, its table on that device;
    ``prints`` is :func:`print_plan` of these ``gvalid``. ``patch`` is a
    key of :data:`PATCHES` (a layout other than ``"auto"`` is for measuring
    one against the other; the 3xTF32 leg's only). ``precision`` is a key
    of :data:`PRECISIONS`: the leg. Launches on the current stream without
    synchronising.
    """
    _check_leg(precision, patch)
    c_pad, g, hb, wb = p0.shape
    n, c, hk, wk = kern.shape
    expect = {
        "p0": (p0, torch.float32, (c_pad, g, hb, wb)),
        "int1": (int1, torch.float32, (c_pad, g, hb + 1, wb + 1)),
        "int2": (int2, torch.float32, (c_pad, g, hb + 1, wb + 1)),
        "kern": (kern, torch.float32, (n, c, hk, wk)),
        "gvalid": (gvalid, torch.int32, (g, 2)),
        "rows.table": (rows.table, torch.int32, tuple(rows.table.shape)),
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
    if not 0 < c <= c_pad:
        raise ValueError(f"score_ncc: the stack has {c} channels, the cache {c_pad}")
    if not 0 < true_channels <= c_pad:
        raise ValueError(f"score_ncc: true_channels={true_channels} outside (0, {c_pad}]")
    if rows.m_tile != kernel_tile().rows or rows.order.shape != (n,):
        raise ValueError(f"score_ncc: the row plan is for {len(rows.order)} rows in tiles of "
                         f"{rows.m_tile}, not {n} in tiles of {kernel_tile().rows}")
    lib = _library()
    out = torch.empty((n, g), dtype=torch.float32, device=dev)
    best = torch.empty((n, g), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.ncc_score(
            p0.data_ptr(), int1.data_ptr(), int2.data_ptr(), kern.data_ptr(),
            gvalid.data_ptr(), rows.table.data_ptr(), best.data_ptr(), out.data_ptr(),
            c, g, n, hb, wb, hk, wk, prints.n_chunks, patch_rows(prints, hk),
            rows.windows.shape[1], int(true_channels), PRECISIONS[precision], PATCHES[patch],
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"ncc_score kernel launch failed: {lib.ncc_error_string(rc).decode()} "
                           f"({rc}) at Wb={wb} hk={hk} wk={wk}, {patch_rows(prints, hk)} patch "
                           f"rows, {rows.windows.shape[1]} windows a tile, {precision} leg, "
                           f"{patch} patch")
    launch_ncc.launches += 1
    launch_ncc.leg_launches[precision] += 1
    return out


# kernel launches since the caller last reset them: in all, and by leg
launch_ncc.launches = 0
launch_ncc.leg_launches = dict.fromkeys(PRECISIONS, 0)


def _check_leg(precision: str, patch: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"score_ncc: unknown precision {precision!r}, expected one of "
                         f"{sorted(PRECISIONS)}")
    if patch not in PATCHES or (precision == "bf16" and patch != "auto"):
        raise ValueError(f"score_ncc: patch {patch!r} is not a layout of the {precision} leg")


def launch_geometry(wb: int, hk: int, wk: int, rows: RowPlan, prints: PrintPlan,
                    patch: str = "auto", precision: str = "f32_3xtf32") -> dict:
    """The kernel's leg, block shape, roles, tap-ring stages, patch layout
    (the 3xTF32 leg's ``split`` (hi, lo) pairs, or ``float`` split where
    read, for canvases whose split patch does not fit; the bf16 leg's
    ``bf16``), patch buffers (2: the next channel's staged beside the
    current one's products; 1 where two do not fit) and shared memory for
    these sizes and this plan (from the library itself, so the report
    matches what runs)."""
    _check_leg(precision, patch)
    stages, buffers, layout = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_longlong()
    rc = _library().ncc_score_geometry(wb, hk, wk, patch_rows(prints, hk), rows.windows.shape[1],
                                       PRECISIONS[precision], PATCHES[patch],
                                       ctypes.byref(stages), ctypes.byref(buffers),
                                       ctypes.byref(layout), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"no launch geometry for Wb={wb} hk={hk} wk={wk} ({precision} leg, "
                           f"{patch} patch)")
    tile, roles = kernel_tile(), kernel_roles(precision)
    return {"leg": precision, "route": ROUTE[precision], "rows_per_block": tile.rows,
            "positions_per_block": tile.positions, "taps_per_stage": tile.taps,
            "threads": roles.threads, "producer_warpgroups": roles.producers,
            "consumer_warpgroups": roles.consumers,
            "producer_regs": roles.producer_regs, "consumer_regs": roles.consumer_regs,
            "stages": stages.value, "patch": LAYOUTS[layout.value],
            "patch_buffers": buffers.value, "smem_bytes": smem.value}


def gallery_block_bytes_per_print(channels: int, hraw: int, wraw: int, n_rows: int) -> int:
    """Device bytes one gallery print costs while its block is scored:
    its raw (C, Hraw, Wraw) f32 maps moved to the device, the direct cache
    (p0 (C_pad, Hb, Wb) and two (C_pad, Hb+1, Wb+1) integral images, f32),
    two p0-sized temporaries of the cache build, and the kernel's (N, G)
    ``best`` (int32) and ``out`` (f32) buffers."""
    c_pad = -(-channels // CHANNEL_BLOCK) * CHANNEL_BLOCK
    hb, wb = hraw - 2 * EDGE_CROP, wraw - 2 * EDGE_CROP
    floats = channels * hraw * wraw + 3 * c_pad * hb * wb + 2 * c_pad * (hb + 1) * (wb + 1)
    return 4 * floats + 8 * n_rows


# device bytes left free beyond the model: allocator rounding, cuDNN and
# cuBLAS workspaces, the CUDA context's own allocations, and the kernel's
# tile-plan table (a few KB a batch)
AUTO_BLOCK_MARGIN_BYTES = 4 * 1024**3


def auto_gallery_block(g_total: int, bytes_per_print: int, free_bytes: int,
                       stack_bytes: int = 0, kept_stacks: int = 0,
                       margin_bytes: int = AUTO_BLOCK_MARGIN_BYTES) -> int:
    """The largest gallery block (prints, at least 1, at most ``g_total``)
    whose bytes fit ``free_bytes`` (``device.free_bytes``) less a margin
    and what stays resident while it is scored: the ``kept_stacks`` variant
    stacks of ``stack_bytes`` each that are kept across blocks and one
    batch's build temporaries (a stack's bytes). The kernel reads the stack
    in place."""
    room = free_bytes - (kept_stacks + 1) * stack_bytes - margin_bytes
    return max(1, min(g_total, room // max(1, bytes_per_print)))


def equal_blocks(g_total: int, block: int) -> int:
    """Prints per block when a gallery of ``g_total`` prints is cut into
    blocks of at most ``block``: ``n = ceil(g_total / block)`` blocks of
    ``ceil(g_total / n)``, so no short tail block is scored on its own (the
    JAX engine's balanced auto blocks; it also rounds to its lane pack,
    which the card does not have)."""
    if block >= g_total:
        return g_total
    n = -(-g_total // block)
    return -(-g_total // n)


# Variant rows a scoring call takes at most when tpu.probe_batch is 0 on a
# card: the deepest point of the NCC kernel's sweep over probe batches
# (benchmarks/kernel_probe.py, PB = 320 x 25 variants; NVIDIA H100 80GB
# HBM3, 700 W; PERF.md §6). The sweep was still gaining there (2.8 % a
# probe from PB = 224), so this is not where gains stop: deeper batches are
# not measured. At the bench's G = 300 the memory model's fit (~9,700 rows)
# binds soon after; at 10,240 prints it binds first (4,275 rows).
H100_PROBE_ROWS = 8000


def probe_row_bytes(channels: int, feat_hw: tuple[int, int], template_hw: tuple[int, int],
                    kernel_hw: tuple[int, int], n_rot: int, n_scl: int, n_var: int,
                    prints: int, plain_hw: tuple[int, int] | None = None) -> int:
    """Device bytes one variant row of a scoring call against ``prints``
    prints costs: its folded row (N, C, hk, wk) twice (the classes and their
    concatenation), the fold's temporaries on the template canvas (four
    copies), its share of its probe's build temporaries (the rotation gather
    and its mask on the feature canvas, every scale's resampled stack and one
    vertical pass on the template canvas) and its row of the kernel's
    ``out`` and ``best`` (f32 and int32 per print). ``plain_hw`` (the
    cache's Hb x Wb) adds the plain scorer's five (N, G, Hb, Wb)
    temporaries."""
    c, r1 = channels, 1 + n_rot
    tc = template_hw[0] * template_hw[1]
    per_probe = 4 * c * r1 * (2 * feat_hw[0] * feat_hw[1] + (n_scl + 1) * tc)
    row = 4 * c * (2 * kernel_hw[0] * kernel_hw[1] + 4 * tc) + 8 * prints
    if plain_hw is not None:
        row += 5 * 4 * prints * plain_hw[0] * plain_hw[1]
    return row + -(-per_probe // max(1, n_var))


def auto_probe_rows(row_bytes: int, room_bytes: int, tile_rows: int,
                    max_rows: int = H100_PROBE_ROWS) -> int:
    """Variant rows per scoring call on a card: whole tiles of ``tile_rows``
    (the kernel's tile, 1 for the plain scorer), as many as ``room_bytes``
    holds at ``row_bytes`` a row (:func:`probe_row_bytes`), at most
    ``max_rows``, at least one tile."""
    fit = room_bytes // max(1, row_bytes * tile_rows)
    return max(1, min(fit, max_rows // tile_rows)) * tile_rows


def host_row_hw(window_hw: np.ndarray, layout: VariantLayout,
                slot_hw: np.ndarray | None = None, slot_map: np.ndarray | None = None) -> np.ndarray:
    """(N, 2) each row's post-crop window from host copies of the stack's
    window data, as :func:`~.ncc_direct.row_slots` resolves it."""
    groups = layout.row_groups()
    if slot_hw is None:
        return np.asarray(window_hw)[groups]
    return np.asarray(slot_hw)[np.asarray(slot_map)[groups]]


def score_ncc(
    cache: DirectGalleryCache,
    packed: PackedVariants,
    layout: VariantLayout,
    true_channels: int,
    slot_hw: torch.Tensor | None = None,
    slot_map: torch.Tensor | None = None,
    plan: tuple[RowPlan, PrintPlan] | None = None,
    patch: str = "auto",
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused NCC scores (N, G) f32, the same quantity as ``score_direct``.

    CPU tensors go through the plain version; CUDA tensors through the
    kernel's leg for ``compute_dtype`` (:data:`LEG_OF_DTYPE`: float32 the
    3xTF32 leg, bfloat16 the bf16 leg). ``plan`` is the tile plan the
    caller made on the host (:func:`row_plan` of the rows' windows,
    :func:`print_plan` of the cache's valid sizes); without it the plan is
    made here from copies of the windows and valid sizes brought to the
    host, which waits for the device. ``patch`` as in :func:`launch_ncc`.
    """
    if compute_dtype not in LEG_OF_DTYPE:
        raise ValueError(f"score_ncc: compute_dtype {compute_dtype} is neither float32 nor "
                         "bfloat16")
    if cache.p0.device.type == "cpu":
        return score_direct(cache, packed, layout, true_channels, slot_hw, slot_map,
                            compute_dtype=compute_dtype)
    gvalid = cache.valid_hw.to(torch.int32).contiguous()
    if plan is None:
        slots, row_slot = row_slots(packed, layout, slot_hw, slot_map)
        tile = kernel_tile()
        plan = (row_plan(slots[row_slot].cpu().numpy(), packed.kernels.shape[-2:], tile.rows,
                         cache.p0.device),
                print_plan(gvalid.cpu().numpy(), tile.positions))
    return launch_ncc(cache.p0, cache.int1, cache.int2, packed.kernels.contiguous(), gvalid,
                      *plan, true_channels, patch, LEG_OF_DTYPE[compute_dtype])

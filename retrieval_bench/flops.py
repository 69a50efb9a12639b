"""The yardstick's arithmetic: the chip's peaks, the FLOP and bytes a
window's correlation needs, and each image's feature size.

:func:`window_taps` and :func:`needed_flop` are frozen copies of the port's
``ops/ncc_kernel.window_taps`` / ``needed_flop``: for each (variant row,
print, channel), the row's window taps that overlap the print's valid
region, over the print's valid output positions. Taps on the zero padding
around a print are not counted, so the count is what these inputs need,
whatever implements the correlation.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

# Published NVIDIA H100 SXM dense peaks (NVIDIA's data sheet): float32-exact
# products on the tensor cores as 3xTF32 (three TF32 products of 495 TFLOP/s
# for one float32 product) and the HBM rate
PEAK_F32_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12
EDGE = 2  # pixels cropped off each edge of every map before correlating


def window_taps(extent: int, canvas: int) -> np.ndarray:
    """(extent + 1, canvas + 1) table: for a window of size ``k`` centred as
    ``[y - k//2, y + (k-1)//2]`` and a print of valid size ``v``, the taps
    that land inside the print, summed over the print's valid output
    positions ``y < v``."""
    k = np.arange(extent + 1)[:, None, None]
    v = np.arange(canvas + 1)[None, :, None]
    y = np.arange(canvas)[None, None, :]
    lo = np.maximum(y - k // 2, 0)
    hi = np.minimum(y + (k - 1) // 2, v - 1)
    return np.where(y < v, np.maximum(hi - lo + 1, 0), 0).sum(axis=-1).astype(np.float64)


def needed_flop(row_hw: np.ndarray, gvalid: np.ndarray, c: int) -> float:
    """Multiply-adds the correlation of every row window (N, 2) with every
    print's valid region (G, 2), both after the edge crop, as FLOP."""
    row_hw = np.asarray(row_hw, np.int64)
    gvalid = np.asarray(gvalid, np.int64)
    canvas = (int(gvalid[:, 0].max()), int(gvalid[:, 1].max()))
    th = window_taps(int(row_hw[:, 0].max()), canvas[0])
    tw = window_taps(int(row_hw[:, 1].max()), canvas[1])
    fh = th[row_hw[:, 0][:, None], gvalid[:, 0][None, :]]
    fw = tw[row_hw[:, 1][:, None], gvalid[:, 1][None, :]]
    return 2.0 * c * float((fh * fw).sum())


def variant_windows(mark_hw: Sequence[int], n_rot: int, scales: Sequence[float]) -> np.ndarray:
    """The cropped (h, w) of each of a mark's reference-mode variants: the
    original, then ``1 + n_rot`` maps (the original and its rotations,
    which keep its canvas) at each scale, PIL's ``int(side * s)``."""
    h, w = mark_hw
    out = [(h, w)] + [(int(h * s), int(w * s)) for _ in range(1 + n_rot) for s in scales]
    return np.asarray(out, np.int64) - 2 * EDGE


def correlation_bytes(row_hw: np.ndarray, gvalid: np.ndarray, c: int) -> float:
    """Inputs read once (every print's and every row's valid maps, float32)
    plus the (N, G) float32 scores written once."""
    row_hw = np.asarray(row_hw, np.int64)
    gvalid = np.asarray(gvalid, np.int64)
    return 4.0 * (c * float((gvalid[:, 0] * gvalid[:, 1]).sum())
                  + c * float((row_hw[:, 0] * row_hw[:, 1]).sum())
                  + len(row_hw) * len(gvalid))


def bound_seconds(flop: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def ingest_hw(header_wh: Sequence[int], crop: Sequence[float], scale: float) -> tuple[int, int]:
    """An image's (h, w) after the reference's crop and resize, from its
    header's (width, height)."""
    w, h = header_wh
    ch, cw = math.floor(h * crop[0]), math.floor(w * crop[1])
    return int((h - 2 * ch) * scale), int((w - 2 * cw) * scale)

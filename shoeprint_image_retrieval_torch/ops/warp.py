"""Feature-map transform sweep: PIL-exact rotation and resampling.

The reference sweeps each query's feature maps through rotations and scales
with per-channel PIL calls on the host (reference similarity.py:230-284):
``Image.rotate(deg)`` (NEAREST, same canvas, 0-fill) and
``Image.resize((int(w*s), int(h*s)))`` (BICUBIC).

* **Host planning (numpy, float64):** rotation index maps and separable
  resample weight matrices, replicating PIL's 16.16 fixed-point affine
  NEAREST and its ``precompute_coeffs``. The port's own copy of the planners
  in ``shoeprint_image_retrieval_tpu/ops/warp.py`` (that module imports JAX),
  held ``np.array_equal`` to them in the tests.
* The device side (``retrieval/engine.build_kernels``) applies them: rotation
  is one gather, resampling two matrix products ``Mv @ x @ Mh^T``. Zero-padded
  canvases compose exactly: weight rows and gather targets outside the valid
  region are zero.
"""

from __future__ import annotations

import math

import numpy as np


# ---------------------------------------------------------------------------
# Host-side planners (numpy float64 — PIL works in C doubles)
# ---------------------------------------------------------------------------

def _bicubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    in1 = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    in2 = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return np.where(ax < 1.0, in1, np.where(ax < 2.0, in2, 0.0))


def resample_weights(
    in_size: int,
    out_size: int,
    canvas_in: int | None = None,
    canvas_out: int | None = None,
) -> np.ndarray:
    """PIL-exact 1-D BICUBIC resampling weight matrix, optionally zero-padded.

    Returns ``(canvas_out, canvas_in)`` float32 where row ``j`` holds the
    normalized filter taps PIL's ``precompute_coeffs`` would produce for
    output pixel ``j`` (zero rows/cols beyond the true sizes).
    """
    canvas_in = canvas_in or in_size
    canvas_out = canvas_out or out_size
    w = np.zeros((canvas_out, canvas_in), np.float64)

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale  # bicubic support
    ss = 1.0 / filterscale
    for j in range(out_size):
        center = (j + 0.5) * scale
        xmin = int(center - support + 0.5)
        xmin = max(xmin, 0)
        xmax = int(center + support + 0.5)
        xmax = min(xmax, in_size)
        taps = _bicubic_kernel((np.arange(xmin, xmax) - center + 0.5) * ss)
        total = taps.sum()
        if total != 0:
            taps = taps / total
        w[j, xmin:xmax] = taps
    return w.astype(np.float32)


def pil_resize_size(in_hw: tuple[int, int], scale: float) -> tuple[int, int]:
    """Output size of the reference's feature-map scaling: ``(int(h*s), int(w*s))``
    (reference similarity.py:268-274 passes ``(int(w*s), int(h*s))`` to PIL)."""
    return int(in_hw[0] * scale), int(in_hw[1] * scale)


def rotate_index_map(
    in_hw: tuple[int, int],
    degrees: float,
    canvas_hw: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """PIL-exact NEAREST rotation as a flat gather map.

    Returns ``(flat_idx, valid)`` each of shape ``canvas_hw``: ``flat_idx`` is
    the flattened (row-major, canvas-strided) source index for each output
    pixel; ``valid`` is False where PIL would write the 0 fill (also for all
    canvas positions beyond the image's own extent).
    """
    h, w = in_hw
    ch, cw = canvas_hw or in_hw

    deg = degrees % 360.0
    ys, xs = np.mgrid[0:ch, 0:cw]

    if deg == 0.0:
        src_y, src_x = ys.astype(np.float64), xs.astype(np.float64)
        yin, xin = ys, xs
    elif deg == 180.0:
        # PIL fast path: exact ROTATE_180 transpose.
        yin, xin = h - 1 - ys, w - 1 - xs
    elif deg in (90.0, 270.0) and h == w:
        # PIL fast path for square images only.
        yin, xin = (xs, w - 1 - ys) if deg == 90.0 else (h - 1 - xs, ys)
    else:
        # General affine path. PIL's NEAREST affine transform runs in 16.16
        # fixed point (coefficients rounded once, then integer-accumulated
        # across the raster), so replicating it in int64 is *bit-exact*.
        cx, cy = w / 2.0, h / 2.0
        rad = -math.radians(deg)
        ca, sa = math.cos(rad), math.sin(rad)
        a, b, d, e = ca, sa, -sa, ca
        # translation per PIL Image.rotate: rotate about the center
        c = (a * -cx + b * -cy) + cx
        f = (d * -cx + e * -cy) + cy

        def fix(v: float) -> int:
            return int(math.floor(v * 65536.0 + 0.5))

        x0 = fix(c + a * 0.5 + b * 0.5)
        y0 = fix(f + d * 0.5 + e * 0.5)
        fxx = x0 + xs.astype(np.int64) * fix(a) + ys.astype(np.int64) * fix(b)
        fyy = y0 + xs.astype(np.int64) * fix(d) + ys.astype(np.int64) * fix(e)
        inb = (fxx >= 0) & (fxx < (w << 16)) & (fyy >= 0) & (fyy < (h << 16))
        xin = np.where(inb, fxx >> 16, -1)
        yin = np.where(inb, fyy >> 16, -1)

    valid = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h) & (ys < h) & (xs < w)
    flat = np.clip(yin, 0, ch - 1) * cw + np.clip(xin, 0, cw - 1)
    return flat.astype(np.int32), valid


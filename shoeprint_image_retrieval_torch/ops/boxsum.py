"""Integral images, "same"-mode box sums and the NCC masked demean.

The reference takes the local energy of normalised cross-correlation with
two convolutions against an all-ones kernel of the template's shape
(reference similarity.py:57-62). Integral images give the same sums for any
window size from one cumulative sum per print.

Geometry: for a ``"same"`` correlation of an ``(H, W)`` image with an
``(h, w)`` window, output position ``y`` sums rows
``[y - h//2, y + (h-1)//2]`` clipped to the canvas, and likewise columns.

Same semantics and the same summation order (cumsum over W, then H; row
difference, then column difference) as ``shoeprint_image_retrieval_tpu/
ops/boxsum.py``; ``EDGE_CROP`` and :func:`masked_demean` are the port's
copies of the JAX package's ``ops/ncc.py`` helpers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EDGE_CROP = 2  # pixels cropped per edge before NCC (reference similarity.py:92-93)


def integral_image(x: torch.Tensor) -> torch.Tensor:
    """``I[..., r, c] = sum(x[..., :r, :c])``, shape ``(..., H+1, W+1)``."""
    c = torch.cumsum(torch.cumsum(x, dim=-1), dim=-2)
    return F.pad(c, (1, 0, 1, 0))


def box_sum_same(integral: torch.Tensor, window_h: int, window_w: int) -> torch.Tensor:
    """``(..., H+1, W+1)`` integral -> ``(..., H, W)`` window sums.

    Entry ``[y, x]`` sums the source over rows ``[y - h//2, y + (h-1)//2]``
    and columns ``[x - w//2, x + (w-1)//2]``, clipped to the canvas.
    """
    H = integral.shape[-2] - 1
    W = integral.shape[-1] - 1
    dev = integral.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    lo_y = torch.clamp(ys - window_h // 2, 0, H)
    hi_y = torch.clamp(ys + (window_h - 1) // 2 + 1, 0, H)
    lo_x = torch.clamp(xs - window_w // 2, 0, W)
    hi_x = torch.clamp(xs + (window_w - 1) // 2 + 1, 0, W)
    row_diff = integral.index_select(-2, hi_y) - integral.index_select(-2, lo_y)
    return row_diff.index_select(-1, hi_x) - row_diff.index_select(-1, lo_x)


def valid_mask(canvas_h: int, canvas_w: int, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(B, canvas_h, canvas_w)`` float mask of ``[:h, :w]``; ``h``, ``w``: ``(B,)``."""
    dev = h.device
    rows = torch.arange(canvas_h, device=dev)[None, :, None] < h[:, None, None]
    cols = torch.arange(canvas_w, device=dev)[None, None, :] < w[:, None, None]
    return (rows & cols).to(torch.float32)


def masked_demean(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Subtract the per-channel mean over the valid ``[:h, :w]``; zero outside.

    ``x``: ``(B, C, Hc, Wc)``; ``h``, ``w``: ``(B,)`` valid sizes. Matches the
    reference's global ``np.mean`` demean of the native-shape array
    (similarity.py:48-49).
    """
    mask = valid_mask(x.shape[-2], x.shape[-1], h, w)[:, None]  # (B, 1, Hc, Wc)
    x = x * mask
    n = (h * w).to(torch.float32)[:, None, None, None]
    mean = x.sum(dim=(-2, -1), keepdim=True) / n
    return (x - mean) * mask

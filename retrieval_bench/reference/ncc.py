"""Plain variant sweep, normalised cross-correlation scores and ranks.

The reference's scoring (reference similarity.py:26-108, 230-386):

* the variant sweep of a mark's (C, h, w) maps in ``"reference"`` mode: the
  original, then every scale of the original and of each rotation
  (``[orig] + [resize(r, s) for r in [orig] + rotations for s in scales]``);
  rotations with PIL's NEAREST on the same canvas with a zero fill, scales
  with PIL's BICUBIC to ``(int(w * s), int(h * s))``. Both keep the maps'
  float64: a rotation is PIL's own NEAREST map of pixel indices, gathered
  from the maps; a scale is PIL's separable bicubic filter (its taps,
  bounds and normalisation) applied as two matrices, without the float32
  rounding PIL's mode ``F`` makes after each pass;
* one pair's score: 2 px cropped off every edge of both maps, per channel
  the "same"-mode normalised cross-correlation of the demeaned template
  over the demeaned print (non-finite values to 0), summed over channels,
  its maximum over positions divided by C. A window that holds one value
  (a ReLU-silent stretch of a print) has no energy: 0/0, so 0. Rounding
  leaves the FFT's numerator and the integral images' energy a residue
  there whose ratio is anything, so such windows are found exactly (the
  window's maximum equals its minimum) and scored 0;
* a mark's score against a print: the maximum over its variants, floored at
  0; its true match's rank: 1 + its position in the descending argsort of
  the row.

The correlation runs through FFTs in the given dtype, prints batched on
one zero-padded canvas (the padding is the "same" mode's own zero
padding), window sums from integral images.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

EDGE = 2  # pixels cropped off each edge of every map before correlating


def rotate_nearest(maps: np.ndarray, degrees: float) -> np.ndarray:
    """PIL's ``Image.rotate(degrees)`` of each (h, w) channel of ``maps``:
    NEAREST, the same canvas, 0 outside, in the maps' own dtype."""
    h, w = maps.shape[-2:]
    index = np.arange(1, h * w + 1, dtype=np.float32).reshape(h, w)   # exact in float32
    src = np.asarray(Image.fromarray(index).rotate(degrees)).astype(np.int64)
    flat = np.concatenate([np.zeros(maps.shape[:-2] + (1,), maps.dtype),
                           maps.reshape(maps.shape[:-2] + (h * w,))], axis=-1)
    return flat[..., src]


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) taps of PIL's BICUBIC resample along one axis
    (Pillow's ``precompute_coeffs``: support 2 x max(1, n_in / n_out),
    bounds rounded as C truncates, taps normalised to sum 1)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    out = np.zeros((n_out, n_in))
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        k = np.array([_bicubic((x - center + 0.5) / filterscale) for x in range(lo, hi)])
        if k.sum() != 0.0:
            k = k / k.sum()
        out[xx, lo:hi] = k
    return out


def resize_bicubic(maps: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.resize(size)`` (BICUBIC) of each channel, ``size`` =
    (w, h), in float64: the horizontal pass, then the vertical."""
    h, w = maps.shape[-2:]
    if (w, h) == tuple(size):
        return np.array(maps, dtype=np.float64)
    rows, cols = bicubic_matrix(h, size[1]), bicubic_matrix(w, size[0])
    return rows @ (np.asarray(maps, dtype=np.float64) @ cols.T)


def variants(maps: np.ndarray, rotations: Sequence[float],
             scales: Sequence[float]) -> list[np.ndarray]:
    """The reference-mode variant sweep of (C, h, w) maps, in float64."""
    def resize(m, s):
        h, w = m.shape[1:]
        return resize_bicubic(m, (int(w * s), int(h * s)))

    maps = np.ascontiguousarray(maps, dtype=np.float64)
    rotated = [maps] + [rotate_nearest(maps, r) for r in rotations]
    return [maps] + [resize(m, s) for m in rotated for s in scales]


def _box(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Sums of ``x`` (G, C, H, W) over each output's "same"-mode (th, tw)
    window ``[y - th // 2, y + (th - 1) // 2]``, from integral images."""
    p = F.pad(x, (tw // 2 + 1, (tw - 1) // 2, th // 2 + 1, (th - 1) // 2))
    s = p.cumsum(dim=-2).cumsum(dim=-1)
    return s[..., th:, tw:] - s[..., :-th, tw:] - s[..., th:, :-tw] + s[..., :-th, :-tw]


def constant_windows(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Where the "same"-mode (th, tw) window of ``x`` (G, C, H, W), zero
    beyond it, holds a single value: its maximum equals its minimum."""
    p = F.pad(x, (tw // 2, (tw - 1) // 2, th // 2, (th - 1) // 2))

    def window_max(t):
        return F.max_pool2d(F.max_pool2d(t, (th, 1), stride=1), (1, tw), stride=1)

    return window_max(p) == -window_max(-p)


def pair_scores(template: np.ndarray, prints: torch.Tensor, valid: torch.Tensor,
                constant: dict | None = None) -> torch.Tensor:
    """One variant (C, h, w) against G prints -> (G,) scores.

    ``prints`` (G, C, H, W): each print cropped by :data:`EDGE` and demeaned
    over its valid region, zero beyond it; ``valid`` (G, 2) the cropped
    valid sizes. Computed in ``prints``' dtype and on its device; the
    correlation as a linear convolution with the flipped template through
    FFTs of the full output's size. ``constant`` caches
    :func:`constant_windows` of ``prints`` by window size.
    """
    g, c, hh, ww = prints.shape
    t = torch.as_tensor(template[:, EDGE:-EDGE, EDGE:-EDGE], device=prints.device).to(prints.dtype)
    th, tw = t.shape[1:]
    t0 = t - t.mean(dim=(1, 2), keepdim=True)
    tsq = (t0 * t0).sum(dim=(1, 2))                                          # (C,)
    size = (hh + th - 1, ww + tw - 1)
    full = torch.fft.irfft2(torch.fft.rfft2(prints, s=size)
                            * torch.fft.rfft2(torch.flip(t0, dims=(1, 2)), s=size)[None], s=size)
    y0, x0 = (th - 1) // 2, (tw - 1) // 2                                    # "same" mode
    num = full[..., y0 : y0 + hh, x0 : x0 + ww]                              # (G, C, H, W)
    local_sum = _box(prints, th, tw)
    local_sq = _box(prints * prints, th, tw)
    energy = torch.clamp(local_sq - local_sum * local_sum / (th * tw), min=0)
    out = num / torch.sqrt(energy * tsq[None, :, None, None])
    constant = {} if constant is None else constant
    if (th, tw) not in constant:
        constant[th, tw] = constant_windows(prints, th, tw)
    out = torch.where(torch.isfinite(out) & ~constant[th, tw], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    summed = out.sum(dim=1)                                                  # (G, H, W)
    rows = torch.arange(hh, device=prints.device)[None, :, None] < valid[:, 0, None, None]
    cols = torch.arange(ww, device=prints.device)[None, None, :] < valid[:, 1, None, None]
    summed = torch.where(rows & cols, summed, torch.full((), -torch.inf, dtype=summed.dtype,
                                                         device=summed.device))
    return summed.amax(dim=(1, 2)) / c


def prepare_prints(maps: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, h_i, w_i) print maps -> (G, C, H, W) cropped, demeaned and
    zero-padded prints and their (G, 2) cropped sizes."""
    crops = [m[:, EDGE:-EDGE, EDGE:-EDGE] for m in maps]
    hh = max(m.shape[1] for m in crops)
    ww = max(m.shape[2] for m in crops)
    out = torch.zeros((len(crops), crops[0].shape[0], hh, ww), dtype=crops[0].dtype,
                      device=crops[0].device)
    for i, m in enumerate(crops):
        out[i, :, : m.shape[1], : m.shape[2]] = m - m.mean(dim=(1, 2), keepdim=True)
    valid = torch.tensor([m.shape[1:] for m in crops], device=out.device)
    return out, valid


def mark_scores(mark: np.ndarray, prints: torch.Tensor, valid: torch.Tensor,
                rotations: Sequence[float], scales: Sequence[float]) -> np.ndarray:
    """A mark's (C, h, w) maps against prepared prints -> (G,) max-over-
    variant scores floored at 0, as float64."""
    best = torch.zeros(len(prints), dtype=torch.float64, device=prints.device)
    constant: dict = {}
    for v in variants(mark, rotations, scales):
        best = torch.maximum(best, pair_scores(v, prints, valid, constant).to(torch.float64))
    return best.cpu().numpy()


def rank_of(row: np.ndarray, true_index: int) -> int:
    """1-based rank of ``true_index`` in the descending argsort of ``row``."""
    order = np.flip(np.argsort(row))
    return int(np.where(order == true_index)[0][0]) + 1

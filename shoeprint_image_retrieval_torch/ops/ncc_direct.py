"""Direct (FFT-free) NCC scoring: cache, template folding, plain scorer.

The port of ``shoeprint_image_retrieval_tpu/ops/ncc_direct.py``:

* **Gallery cache** (:func:`build_direct_cache`): demeaned, masked,
  edge-cropped prints ``p0`` (channel-major) plus integral images of ``p0``
  and ``p0^2``.
* **Template folding** (:func:`fold_template`): each variant's demeaned
  template scaled by ``1/sqrt(sum(t0^2))`` (reference similarity.py:67) and
  written *centred* on a shared kernel canvas, so every variant's "same"
  window lands on the same correlation coordinates.
* **Plain scorer** (:func:`score_direct`): the plain PyTorch version of the
  fused CUDA kernel in ``csrc/ncc_score.cu`` — per channel one correlation
  of every variant row with every print, scaled by the channel's inverse
  window energy (computed once per distinct window size), summed over
  channels, masked max per print, divided by C. The CPU path and the
  yardstick the kernel is held against on the card.

Zero-energy / zero-template conventions (non-finite -> 0, reference
similarity.py:65-71) come from ``where`` masks on the folded template and
the inverse energy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .boxsum import EDGE_CROP, integral_image, masked_demean


class DirectGalleryCache(NamedTuple):
    """Channel-major direct-scoring cache.

    p0:   (C_pad, G, Hb, Wb) f32 — demeaned, masked, edge-cropped prints.
    int1: (C_pad, G, Hb+1, Wb+1) f32 — integral images of p0.
    int2: (C_pad, G, Hb+1, Wb+1) f32 — integral images of p0^2.
    valid_hw: (G, 2) int32 — per-print valid size after the edge crop.
    """

    p0: torch.Tensor
    int1: torch.Tensor
    int2: torch.Tensor
    valid_hw: torch.Tensor


def build_direct_cache(
    prints: torch.Tensor, valid_hw: torch.Tensor, channel_block: int = 8
) -> DirectGalleryCache:
    """(G, C, Hraw, Wraw) zero-padded prints -> cache (crops 2 px per edge,
    pads channels to a multiple of ``channel_block``)."""
    g, c, hraw, wraw = prints.shape
    hb, wb = hraw - 2 * EDGE_CROP, wraw - 2 * EDGE_CROP
    p = prints[:, :, EDGE_CROP : EDGE_CROP + hb, EDGE_CROP : EDGE_CROP + wb]
    v = valid_hw.to(torch.int32) - 2 * EDGE_CROP
    p0 = masked_demean(p.to(torch.float32), v[:, 0], v[:, 1])  # (G, C, Hb, Wb)
    c_pad = -(-c // channel_block) * channel_block
    if c_pad != c:
        p0 = F.pad(p0, (0, 0, 0, 0, 0, c_pad - c))
    p0 = p0.transpose(0, 1).contiguous()
    return DirectGalleryCache(
        p0=p0,
        int1=integral_image(p0).contiguous(),
        int2=integral_image(p0 * p0).contiguous(),
        valid_hw=v.contiguous(),
    )


def fold_template(
    templates: torch.Tensor, valid_hw: torch.Tensor, kernel_hw: tuple[int, int]
) -> torch.Tensor:
    """Crop, demean, energy-fold and centre a batch of templates.

    Args:
        templates: (B, C, hraw, wraw) zero-padded variant maps.
        valid_hw: (B, 2) valid sizes (pre-crop).
        kernel_hw: kernel canvas (>= the cropped template canvas).

    Returns:
        (B, C, hk, wk) f32: ``t0 / sqrt(sum(t0^2))`` shifted by
        ``(hk//2 - h//2, wk//2 - w//2)`` with wrap-around, exactly as the JAX
        package's ``jnp.roll`` centering places it (the rolled-in tail is
        zero, because the template vanishes beyond its valid region).
    """
    hct, wct = templates.shape[-2] - 2 * EDGE_CROP, templates.shape[-1] - 2 * EDGE_CROP
    t = templates[..., EDGE_CROP : EDGE_CROP + hct, EDGE_CROP : EDGE_CROP + wct]
    h = valid_hw[:, 0].to(torch.int64) - 2 * EDGE_CROP
    w = valid_hw[:, 1].to(torch.int64) - 2 * EDGE_CROP
    t0 = masked_demean(t, h, w)
    tsq = (t0 * t0).sum(dim=(-2, -1), keepdim=True)
    u = torch.where(tsq > 0, t0 / torch.sqrt(tsq), torch.zeros((), device=t0.device))

    hk, wk = kernel_hw
    u_pad = F.pad(u, (0, wk - wct, 0, hk - hct))
    b, c = u_pad.shape[:2]
    dev = u_pad.device
    dy = hk // 2 - h // 2
    dx = wk // 2 - w // 2
    # out[i] = in[(i - dy) % hk], per template: two gathers
    ri = (torch.arange(hk, device=dev)[None, :] - dy[:, None]) % hk  # (B, hk)
    ci = (torch.arange(wk, device=dev)[None, :] - dx[:, None]) % wk  # (B, wk)
    rows = torch.gather(u_pad, 2, ri[:, None, :, None].expand(b, c, hk, wk))
    return torch.gather(rows, 3, ci[:, None, None, :].expand(b, c, hk, wk))


def inv_window_energy(
    int1: torch.Tensor, int2: torch.Tensor, windows: torch.Tensor
) -> torch.Tensor:
    """``1/sqrt(local window energy)`` for a set of windows.

    Args:
        int1, int2: (..., H+1, W+1) integral images of p0 and p0^2.
        windows: (U, 2) int window sizes (h, w), post-crop.

    Returns:
        (U, ..., H, W): energy = boxsum(p0^2) - boxsum(p0)^2 / (h*w), negatives
        clamped, zero -> 0 (reference similarity.py:57-68). Box sums follow
        ``ops/boxsum.box_sum_same`` (row difference, then column difference).
    """
    H, W = int1.shape[-2] - 1, int1.shape[-1] - 1
    dev = int1.device
    wh = windows[:, 0].to(device=dev, dtype=torch.int64)[:, None]
    ww = windows[:, 1].to(device=dev, dtype=torch.int64)[:, None]
    ys = torch.arange(H, device=dev)[None, :]
    xs = torch.arange(W, device=dev)[None, :]
    lo_y = torch.clamp(ys - wh // 2, 0, H)
    hi_y = torch.clamp(ys + (wh - 1) // 2 + 1, 0, H)
    lo_x = torch.clamp(xs - ww // 2, 0, W)
    hi_x = torch.clamp(xs + (ww - 1) // 2 + 1, 0, W)
    lead = int1.shape[:-2]
    u = len(windows)

    def box(integral):
        # (..., H+1, W+1) -> (U, ..., H, W)
        rows_hi = integral[..., hi_y, :]  # (..., U, H, W+1)
        rows_lo = integral[..., lo_y, :]
        row_diff = torch.movedim(rows_hi - rows_lo, -3, 0)  # (U, ..., H, W+1)
        shape = (u, *lead, H, W)
        idx_hi = hi_x.reshape(u, *([1] * len(lead)), 1, W).expand(shape)
        idx_lo = lo_x.reshape(u, *([1] * len(lead)), 1, W).expand(shape)
        return torch.gather(row_diff, -1, idx_hi) - torch.gather(row_diff, -1, idx_lo)

    b1 = box(int1)
    b2 = box(int2)
    n = (wh * ww).to(torch.float32).reshape(u, *([1] * (len(lead) + 2)))
    energy = torch.clamp(b2 - b1 * b1 / n, min=0.0)
    return torch.where(energy > 0, 1.0 / torch.sqrt(energy), torch.zeros((), device=dev))


class PackedVariants(NamedTuple):
    """Class-major packed variant stack for a whole probe batch.

    For each variant class (the unscaled originals, then one class per scale)
    all ``pb`` probes' variants are contiguous, probe-major within the class:
    row ``offset(ci) + p * count(ci) + k`` is probe ``p``'s ``k``-th variant
    of class ``ci``.

    Attributes:
        kernels: (N, C, hk, wk) folded, centred templates, N = pb * sum(counts).
        window_hw: (n_groups, 2) int32 post-crop window sizes; group
            ``ci * pb + p`` is (class ci, probe p).
    """

    kernels: torch.Tensor
    window_hw: torch.Tensor


@dataclass(frozen=True)
class VariantLayout:
    """Static shape info for a :class:`PackedVariants` stack."""

    class_counts: tuple[int, ...]  # variants per probe, per class
    pb: int                        # probes in the batch

    @property
    def n_groups(self) -> int:
        return len(self.class_counts) * self.pb

    @property
    def n_variants(self) -> int:
        return self.pb * sum(self.class_counts)

    def row_groups(self) -> np.ndarray:
        """(N,) int64: the window group of every variant row."""
        return np.concatenate([
            np.repeat(np.arange(self.pb) + ci * self.pb, cnt)
            for ci, cnt in enumerate(self.class_counts)
        ])


def row_slots(
    packed: PackedVariants,
    layout: VariantLayout,
    slot_hw: torch.Tensor | None = None,
    slot_map: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot_hw (U, 2) int32, row_slot (N,) int64) for a packed stack.

    ``slot_hw``/``slot_map`` are the engine's per-batch window dedup (the
    distinct window sizes and each group's index into them); without them
    every group is its own slot.
    """
    dev = packed.kernels.device
    if slot_hw is None:
        slot_hw = packed.window_hw
        slot_map = torch.arange(layout.n_groups, device=dev)
    groups = torch.as_tensor(layout.row_groups(), device=dev)
    return slot_hw.to(device=dev, dtype=torch.int32), slot_map.to(dev).long()[groups]


def score_direct(
    cache: DirectGalleryCache,
    packed: PackedVariants,
    layout: VariantLayout,
    true_channels: int,
    slot_hw: torch.Tensor | None = None,
    slot_map: torch.Tensor | None = None,
) -> torch.Tensor:
    """Score every variant row against every print -> (N, G) f32.

    Score = max over each print's valid "same" window of the channel-summed
    normalised correlation, divided by C (reference similarity.py:106-108).
    The plain version of ``ops/ncc_kernel.score_ncc``'s CUDA kernel.
    """
    c_pad, g, hb, wb = cache.p0.shape
    kernels = packed.kernels
    n, c = kernels.shape[:2]
    hk, wk = kernels.shape[-2:]
    if c != c_pad:
        kernels = F.pad(kernels, (0, 0, 0, 0, 0, c_pad - c))
    slots, row_slot = row_slots(packed, layout, slot_hw, slot_map)
    pad = (wk // 2, wk - 1 - wk // 2, hk // 2, hk - 1 - hk // 2)
    acc = torch.zeros((n, g, hb, wb), dtype=torch.float32, device=cache.p0.device)
    for ci in range(c_pad):
        p_pad = F.pad(cache.p0[ci][:, None], pad)  # (G, 1, Hb+hk-1, Wb+wk-1)
        corr = F.conv2d(p_pad, kernels[:, ci][:, None])  # (G, N, Hb, Wb)
        einv = inv_window_energy(cache.int1[ci], cache.int2[ci], slots)  # (U, G, Hb, Wb)
        acc += corr.transpose(0, 1) * einv[row_slot]
    v = cache.valid_hw.to(acc.device)
    rows = torch.arange(hb, device=acc.device)[None, :, None] < v[:, 0, None, None]
    cols = torch.arange(wb, device=acc.device)[None, None, :] < v[:, 1, None, None]
    masked = torch.where(rows & cols, acc, torch.full((), -torch.inf, device=acc.device))
    return masked.amax(dim=(-2, -1)) / true_channels

"""Batched, mask-aware normalised cross-correlation through FFTs.

The reference's own scoring method (``normxcorr``, reference
similarity.py:26-108), computed per (query variant, gallery print):

    per channel c:   ncc_c = conv(p0_c, flip(t0_c), "same")
                             / sqrt((conv(p0_c^2, 1) - conv(p0_c, 1)^2 / N) * sum(t0_c^2))
    score = max_y,x sum_c ncc_c[y, x] / C

with ``t0`` / ``p0`` the demeaned template / print channels, negative local
energies clamped to 0 and non-finite ratios set to 0 (similarity.py:48-71),
after cropping every map by 2 px per edge (similarity.py:92-93).

The port of ``shoeprint_image_retrieval_tpu/ops/ncc.py`` with
``torch.fft.rfft2`` / ``irfft2``:

* **Gallery cache** (:func:`build_gallery_cache`): the rfft2 of every
  demeaned print channel on the correlation canvas, and integral images of
  ``p0`` and ``p0^2`` for the exact window energy (``ops/boxsum.py``),
  channel-major, channels padded to a multiple of the block of 16.
* **Scoring** (:func:`score_templates`): the inverse FFTs run one channel
  block of 16 at a time, each block's ratios summed into an f32 score map in
  block order, as the JAX scan does; then the max over each print's valid
  "same" window, divided by the true C. Variants that share a valid size
  share their window energy and go through the FFTs together, in batches
  that bound the device memory one block's spectra take.

The valid sizes here are host integers: the port does not trace.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .boxsum import EDGE_CROP, box_sum_same, integral_image, masked_demean
from .fft import correlation_fft_shape

CHANNEL_BLOCK = 16  # channels per inverse-FFT block (the JAX scan's)
# device bytes one channel block's spectra and correlations may take for a
# batch of variants; the batch shrinks to fit (at least one variant)
VARIANT_BATCH_BYTES = 2 * 1024**3


class GalleryCache(NamedTuple):
    """Channel-major FFT scoring cache of one gallery block.

    phat: (C_pad, G, Fh, Fw//2+1) complex64 — rfft2 of each demeaned,
        masked, edge-cropped print channel on the correlation canvas.
    int1: (C_pad, G, Hc+1, Wc+1) f32 — integral images of p0.
    int2: (C_pad, G, Hc+1, Wc+1) f32 — integral images of p0^2.
    valid_hw: (G, 2) int32 — each print's valid size after the edge crop.
    """

    phat: torch.Tensor
    int1: torch.Tensor
    int2: torch.Tensor
    valid_hw: torch.Tensor

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def _flip_valid(t0: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Reverse a (..., hc, wc) stack within its (h, w) valid region, zero
    outside: correlation becomes the convolution the reference computes
    (similarity.py:50-55)."""
    hc, wc = t0.shape[-2:]
    dev = t0.device
    ridx = torch.clamp(h - 1 - torch.arange(hc, device=dev), 0, hc - 1)
    cidx = torch.clamp(w - 1 - torch.arange(wc, device=dev), 0, wc - 1)
    out = t0.index_select(-2, ridx).index_select(-1, cidx)
    rows = torch.arange(hc, device=dev)[:, None] < h
    cols = torch.arange(wc, device=dev)[None, :] < w
    return out * (rows & cols).to(out.dtype)


def build_gallery_cache(
    prints: torch.Tensor,
    valid_hw: torch.Tensor,
    template_canvas_hw: tuple[int, int],
) -> tuple[GalleryCache, tuple[int, int]]:
    """(G, C, Hraw, Wraw) zero-padded prints and (G, 2) pre-crop valid sizes
    -> (cache, FFT shape). ``template_canvas_hw`` is the post-crop template
    canvas, which bounds the correlation's FFT size."""
    g, c, hraw, wraw = prints.shape
    hc, wc = hraw - 2 * EDGE_CROP, wraw - 2 * EDGE_CROP
    fft_shape = correlation_fft_shape((hc, wc), template_canvas_hw)
    p = prints[:, :, EDGE_CROP : EDGE_CROP + hc, EDGE_CROP : EDGE_CROP + wc].to(torch.float32)
    v = valid_hw.to(prints.device, torch.int32) - 2 * EDGE_CROP
    p0 = masked_demean(p, v[:, 0], v[:, 1])  # (G, C, Hc, Wc)
    phat = torch.fft.rfft2(p0, s=fft_shape)
    c_pad = -(-c // CHANNEL_BLOCK) * CHANNEL_BLOCK
    if c_pad != c:
        p0 = F.pad(p0, (0, 0, 0, 0, 0, c_pad - c))
        phat = F.pad(phat, (0, 0, 0, 0, 0, c_pad - c))
    cache = GalleryCache(
        phat=phat.transpose(0, 1).contiguous(),
        int1=integral_image(p0).transpose(0, 1).contiguous(),
        int2=integral_image(p0 * p0).transpose(0, 1).contiguous(),
        valid_hw=v.contiguous(),
    )
    return cache, fft_shape


def _score_group(cache: GalleryCache, templates: torch.Tensor, h: int, w: int,
                 true_channels: int) -> torch.Tensor:
    """(B, C_pad, hraw, wraw) templates that share the post-crop valid size
    (h, w) -> (B, G) scores."""
    c_pad, g, fh, fwr = cache.phat.shape
    fw = 2 * (fwr - 1)
    hcg, wcg = cache.int1.shape[-2] - 1, cache.int1.shape[-1] - 1
    b = templates.shape[0]
    dev = templates.device
    hct, wct = templates.shape[-2] - 2 * EDGE_CROP, templates.shape[-1] - 2 * EDGE_CROP
    t = templates[..., EDGE_CROP : EDGE_CROP + hct, EDGE_CROP : EDGE_CROP + wct]
    t0 = masked_demean(t, torch.full((b,), h, device=dev), torch.full((b,), w, device=dev))
    tsq = (t0 * t0).sum(dim=(-2, -1))  # (B, C_pad)
    that = torch.fft.rfft2(_flip_valid(t0, h, w), s=(fh, fw))  # (B, C_pad, fh, fwr)
    n_win = float(h * w)
    sh, sw = (h - 1) // 2, (w - 1) // 2
    acc = torch.zeros((b, g, hcg, wcg), dtype=torch.float32, device=dev)
    for c0 in range(0, c_pad, CHANNEL_BLOCK):
        blk = slice(c0, c0 + CHANNEL_BLOCK)
        conv = torch.fft.irfft2(cache.phat[blk][None] * that[:, blk, None], s=(fh, fw))
        num = conv[..., sh : sh + hcg, sw : sw + wcg]  # (B, cb, G, hcg, wcg)
        b1 = box_sum_same(cache.int1[blk], h, w)  # (cb, G, hcg, wcg)
        b2 = box_sum_same(cache.int2[blk], h, w)
        energy = torch.clamp(b2 - b1 * b1 / n_win, min=0.0)
        den = torch.sqrt(energy[None] * tsq[:, blk, None, None, None])
        r = num / den
        r = torch.where(torch.isfinite(r), r, torch.zeros((), device=dev))
        acc += r.sum(dim=1)
    v = cache.valid_hw.to(dev)
    rows = torch.arange(hcg, device=dev)[None, :, None] < v[:, 0, None, None]
    cols = torch.arange(wcg, device=dev)[None, None, :] < v[:, 1, None, None]
    masked = torch.where(rows & cols, acc, torch.full((), -torch.inf, device=dev))
    return masked.amax(dim=(-2, -1)) / true_channels


def score_templates(
    cache: GalleryCache,
    templates: torch.Tensor,
    template_valid_hw,
    *,
    true_channels: int,
    batch_bytes: int = VARIANT_BATCH_BYTES,
) -> torch.Tensor:
    """Score a stack of variants against every cached print -> (V, G) f32.

    ``templates`` (V, C, hraw, wraw) zero-padded variant maps (channels may
    already be padded to the cache's); ``template_valid_hw`` (V, 2) their
    pre-crop valid sizes, on the host or the device (read on the host).
    Each score is the max over the print's valid "same" window of the
    channel-summed NCC map, divided by ``true_channels``. Variants go
    through the FFTs in batches of at most ``batch_bytes`` of spectra and
    correlations a channel block.
    """
    c_pad, g, fh, fwr = cache.phat.shape
    if templates.shape[1] != c_pad:
        templates = F.pad(templates, (0, 0, 0, 0, 0, c_pad - templates.shape[1]))
    hw = (template_valid_hw.cpu().numpy() if isinstance(template_valid_hw, torch.Tensor)
          else np.asarray(template_valid_hw)).reshape(-1, 2) - 2 * EDGE_CROP
    hcg, wcg = cache.int1.shape[-2] - 1, cache.int1.shape[-1] - 1
    fw = 2 * (fwr - 1)
    per_variant = CHANNEL_BLOCK * g * (fh * fwr * 8 + fh * fw * 4 + 4 * hcg * wcg * 4)
    step = max(1, batch_bytes // per_variant)
    out = torch.empty((len(hw), g), dtype=torch.float32, device=templates.device)
    uniq, inv = np.unique(hw, axis=0, return_inverse=True)
    for ui, (h, w) in enumerate(uniq):
        idx = np.flatnonzero(inv.reshape(-1) == ui)
        for lo in range(0, len(idx), step):
            sel = torch.as_tensor(idx[lo : lo + step], device=templates.device)
            out[sel] = _score_group(cache, templates.index_select(0, sel), int(h), int(w),
                                    true_channels)
    return out


def score_one_template(cache: GalleryCache, template: torch.Tensor, template_valid_hw, *,
                       true_channels: int) -> torch.Tensor:
    """:func:`score_templates` of one (C, hraw, wraw) variant -> (G,)."""
    hw = torch.as_tensor(template_valid_hw).reshape(1, 2)
    return score_templates(cache, template[None], hw, true_channels=true_channels)[0]


def normxcorr_same(template: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """The reference's ``normxcorr(template, image, "same")`` (similarity.py:
    26-72) for a (..., th, tw) template stack and a (..., ih, iw) image stack
    whose leading dimensions broadcast -> (..., ih, iw), built from the same
    pieces as the batched path. Each leading index is its own pair: its
    mean and energy are taken over its last two dimensions only, so a
    (C, h, w) pair of feature maps gives the C per-channel maps in one call."""
    th, tw = template.shape[-2:]
    ih, iw = image.shape[-2:]
    fshape = correlation_fft_shape((ih, iw), (th, tw))
    t0 = template - template.mean(dim=(-2, -1), keepdim=True)
    p0 = image - image.mean(dim=(-2, -1), keepdim=True)
    that = torch.fft.rfft2(torch.flip(t0, dims=(-2, -1)), s=fshape)
    phat = torch.fft.rfft2(p0, s=fshape)
    conv = torch.fft.irfft2(phat * that, s=fshape)
    num = conv[..., (th - 1) // 2 : (th - 1) // 2 + ih, (tw - 1) // 2 : (tw - 1) // 2 + iw]
    b1 = box_sum_same(integral_image(p0), th, tw)
    b2 = box_sum_same(integral_image(p0 * p0), th, tw)
    energy = torch.clamp(b2 - b1 * b1 / float(th * tw), min=0.0)
    r = num / torch.sqrt(energy * (t0 * t0).sum(dim=(-2, -1), keepdim=True))
    return torch.where(torch.isfinite(r), r, torch.zeros((), device=r.device))

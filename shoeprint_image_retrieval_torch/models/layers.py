"""Masked CNN primitives: batched padded extraction == native extraction.

All images of a size cluster are zero-padded onto one canvas and pushed
through the backbone as one NCHW batch, with each sample's valid size
``(Hv, Wv)`` threaded through every layer. The invariant after every op:

    ``out[:, :, :Hv', :Wv']`` equals the op applied to the native-shape
    input, and ``out`` is exactly zero outside the valid region.

* conv: a valid output position's window reads only valid or zero inputs,
  exactly the native conv's implicit zero padding; positions beyond the
  native output extent are re-zeroed so they cannot leak into deeper layers.
* batchnorm (inference): the affine shift breaks zeros, so re-zero after.
* silu / sigmoid-scale: zero-preserving.
* squeeze-excitation: the global mean is the masked sum over the per-sample
  valid pixel count, the native mean.

The port of ``shoeprint_image_retrieval_tpu/models/layers.py``: convs are
``F.conv2d`` with torch-style symmetric padding, in full float32 (TF32 is
off, ``device.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_out_size(size, kernel: int, stride: int, padding: int):
    """torch Conv2d/Pool2d size rule: floor((n + 2p - k) / s) + 1."""
    return (size + 2 * padding - kernel) // stride + 1


def valid_mask(x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) float mask from per-sample valid sizes (B, 2)."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(h, device=x.device)[None, :, None] < valid_hw[:, 0, None, None]
    cols = torch.arange(w, device=x.device)[None, None, :] < valid_hw[:, 1, None, None]
    return (rows & cols)[:, None].to(x.dtype)


def remask(x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    return x * valid_mask(x, valid_hw)


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    valid_hw: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """torch-semantics Conv2d on a masked batch. Returns (y, new_valid_hw)."""
    y = F.conv2d(x, weight, bias, stride=stride, padding=padding, groups=groups)
    new_valid = conv_out_size(valid_hw, weight.shape[-1], stride, padding)
    return remask(y, new_valid), new_valid


def batchnorm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    valid_hw: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """Inference-mode BatchNorm2d (running stats), re-zeroed outside valid."""
    scale = weight / torch.sqrt(running_var + eps)
    shift = bias - running_mean * scale
    y = x * scale[None, :, None, None] + shift[None, :, None, None]
    return remask(y, valid_hw)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)  # silu(0) == 0: mask-preserving


def masked_global_mean(x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """(B, C, 1, 1) mean over each sample's valid region (exact SE pooling)."""
    total = x.sum(dim=(-2, -1), keepdim=True)  # the padded region is zero
    count = (valid_hw[:, 0] * valid_hw[:, 1]).to(x.dtype)
    return total / count[:, None, None, None]


def squeeze_excitation(
    x: torch.Tensor,
    fc1_weight: torch.Tensor,
    fc1_bias: torch.Tensor,
    fc2_weight: torch.Tensor,
    fc2_bias: torch.Tensor,
    valid_hw: torch.Tensor,
) -> torch.Tensor:
    """torchvision SqueezeExcitation: pool -> 1x1 -> SiLU -> 1x1 -> sigmoid-scale."""
    s = masked_global_mean(x, valid_hw)
    s = silu(F.conv2d(s, fc1_weight, fc1_bias))
    s = F.conv2d(s, fc2_weight, fc2_bias)
    return x * torch.sigmoid(s)  # x is zero outside valid -> stays zero

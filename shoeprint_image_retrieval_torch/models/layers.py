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
* silu / relu / sigmoid-scale: zero-preserving.
* max / avg pool: a valid output window lies inside the valid region except
  at the boundary, where torch ignores padding (max pool) or counts it
  (avg pool, ``count_include_pad``). A boundary max window may also read the
  masked zeros; every max pool of these backbones follows a ReLU, so those
  zeros cannot exceed the window's max unless the max is 0, and then both
  give 0. Outputs beyond the native extent are re-zeroed.
* squeeze-excitation: the global mean is the masked sum over the per-sample
  valid pixel count, the native mean.

The port of ``shoeprint_image_retrieval_tpu/models/layers.py``: convs are
``F.conv2d`` with torch-style symmetric padding, in full float32 (TF32 is
off, ``device.py``).

``tpu.precision = "bfloat16"`` (the JAX package's ``Precision.DEFAULT`` for
its backbone convs) reaches :func:`conv2d` only, through the ``precision``
each conv-holding module carries (:func:`set_conv_precision`; the engine
binds it on the model objects it builds, so every thread that runs them,
the cluster lookahead's included, sees it). :func:`conv_route` says what
serves it:

* on a card (``"bf16"``): the operands go to bf16, cuDNN runs the conv with
  f32 accumulation into a bf16 output (its output type, one rounding more
  than the TPU's DEFAULT, which keeps f32 outputs), and the result comes
  back to f32 before bias, batch norm, activation and remask;
* on the CPU (``"f32"``): plain f32, which is what the JAX package computes
  there: XLA:CPU runs a conv at ``Precision.DEFAULT`` in f32, equal to
  ``HIGHEST``.

The squeeze-excitation 1 x 1 convs do not read it, as in the JAX package.
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


PRECISIONS = ("float32", "bfloat16")


def conv_route(precision: str, device: torch.device) -> str:
    """The arithmetic :func:`conv2d` runs for ``precision`` on ``device``:
    ``"bf16"`` (bf16 operands, f32 accumulation) for ``"bfloat16"`` on a
    card, else ``"f32"``."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown conv precision {precision!r}, expected one of {PRECISIONS}")
    return "bf16" if precision == "bfloat16" and device.type == "cuda" else "f32"


def set_conv_precision(model: torch.nn.Module, precision: str) -> None:
    """Bind ``precision`` on every module of ``model`` that declares a
    ``conv_precision``: those whose convs read it, and the backbone itself
    (``Features``), which reports it."""
    conv_route(precision, torch.device("cpu"))  # validates the name
    for module in model.modules():
        if hasattr(module, "conv_precision"):
            module.conv_precision = precision


def bf16_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, *,
              stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """The ``"bf16"`` route of :func:`conv2d` on any device: ``F.conv2d`` of
    the operands in bf16, back in ``x``'s type, then the bias."""
    y = F.conv2d(x.to(torch.bfloat16), weight.to(torch.bfloat16), None, stride=stride,
                 padding=padding, groups=groups).to(x.dtype)
    return y if bias is None else y + bias[None, :, None, None]


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    valid_hw: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
    precision: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """torch-semantics Conv2d on a masked batch. Returns (y, new_valid_hw).
    ``precision`` as in :func:`conv_route`."""
    if conv_route(precision, x.device) == "bf16":
        y = bf16_conv(x, weight, bias, stride=stride, padding=padding, groups=groups)
    else:
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


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)  # relu(0) == 0: mask-preserving


def max_pool(
    x: torch.Tensor, valid_hw: torch.Tensor, *, kernel: int, stride: int, padding: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """torch MaxPool2d on a masked batch (padding never wins a max; the
    masked zeros cannot either, see the module docstring)."""
    y = F.max_pool2d(x, kernel, stride, padding)
    new_valid = conv_out_size(valid_hw, kernel, stride, padding)
    return remask(y, new_valid), new_valid


def avg_pool(
    x: torch.Tensor, valid_hw: torch.Tensor, *, kernel: int, stride: int, padding: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """torch AvgPool2d with ``count_include_pad=True`` (the torchvision
    default) on a masked batch."""
    y = F.avg_pool2d(x, kernel, stride, padding, count_include_pad=True)
    new_valid = conv_out_size(valid_hw, kernel, stride, padding)
    return remask(y, new_valid), new_valid


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

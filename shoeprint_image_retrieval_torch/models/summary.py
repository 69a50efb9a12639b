"""Model inspection without a device or weights.

The reference's ``get_output_size`` probes the network with a dummy input
on CUDA (network.py:32-48) and ``printmodel`` dumps it with torchinfo
(network.py:16-29). Here the output size comes from the size rule the
masked layers apply (:func:`~.layers.conv_out_size`), walked over every
convolution and pool in forward order, so it equals the valid size the
forward returns for that input. The port of
``shoeprint_image_retrieval_tpu/models/summary.py``.
"""

from __future__ import annotations

from torch import nn

from .efficientnet import Features
from .layers import conv_out_size


def _out_hw(module: nn.Module, hw: tuple[int, int]) -> tuple[int, int]:
    """A module's output (H, W): its children in order, then its own conv or
    pool. Every module that changes a size is an ``nn.Conv2d`` or carries
    ``pool = (kernel, stride, padding)``, applied after its children (a
    transition's average pool follows its conv)."""
    for child in module.children():
        hw = _out_hw(child, hw)
    if isinstance(module, nn.Conv2d):
        rule = [(module.kernel_size[i], module.stride[i], module.padding[i]) for i in (0, 1)]
    elif getattr(module, "pool", None) is not None:
        rule = [module.pool, module.pool]
    else:
        return hw
    return tuple(conv_out_size(n, k, s, p) for n, (k, s, p) in zip(hw, rule))


def output_size(features: Features, input_hw: tuple[int, int]) -> tuple[int, int, int]:
    """(channels, H, W) of the truncated backbone's output for an input of
    ``input_hw``: the valid size ``features(x, valid_hw)`` returns for it."""
    h, w = _out_hw(features, (int(input_hw[0]), int(input_hw[1])))
    return features.out_channels[-1], h, w


def describe(features: Features) -> str:
    """Per-child summary: index, name, type, output channels."""
    lines = ["idx  name          child                 out_channels"]
    for i, ((name, child), ch) in enumerate(zip(features.features.named_children(),
                                                features.out_channels)):
        lines.append(f"{i:<4} {name:<13} {type(child).__name__:<21} {ch}")
    return "\n".join(lines)

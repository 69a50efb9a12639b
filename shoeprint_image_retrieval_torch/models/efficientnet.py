"""EfficientNet (B-series) and EfficientNetV2 (S/M/L) backbones as masked
``nn.Module``s, and the truncated ``features`` container every backbone uses.

Frozen, inference-only versions of the torchvision networks the reference
selects from (reference network.py:139-175), exposed, as in the reference,
as a ``features`` children list truncated at an integer block index
(reference network.py:185-186: ``Sequential(features.children()[:block])``).
Stochastic depth and dropout are inference no-ops and are omitted.

Submodules are named as torchvision names them, so a torchvision
``features.*`` state dict loads with ``load_state_dict``:

* ``features.{i}`` for i = 0 (stem), 1..n (stages), n+1 (head);
* a conv-BN-activation is ``{0: conv, 1: bn}``;
* ``MBConv.block`` = [expand CNA if expand != 1, depthwise CNA,
  ``SqueezeExcitation(fc1, fc2)``, project CNA];
* ``FusedMBConv.block`` = [fused k x k CNA, 1x1 project CNA], or a single
  k x k CNA when expand == 1.

The B-series scales the B0 stage rows by a width and a depth multiplier
(channels rounded by :func:`make_divisible`, layer counts by ``ceil``), uses
BN eps 1e-5 and a head of 4 x its last stage's channels; V2 uses BN eps 1e-3
and a 1280-channel head.

Every op runs through the masked primitives of :mod:`.layers`, so a
zero-padded batch of differently-sized images gives exactly the per-image
features. The port of ``shoeprint_image_retrieval_tpu/models/
efficientnet.py``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Sequence

import torch
from torch import nn

from . import layers as L

BN_EPS_V1 = 1e-5  # the B-series
BN_EPS_V2 = 1e-3


def make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding for the width multiplier."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (block_kind, expand, kernel, stride, in_ch, out_ch, layers) — torchvision
# efficientnet_b0 stage rows at width and depth 1.0
_V1_BASE = [
    ("mb", 1, 3, 1, 32, 16, 1),
    ("mb", 6, 3, 2, 16, 24, 2),
    ("mb", 6, 5, 2, 24, 40, 2),
    ("mb", 6, 3, 2, 40, 80, 3),
    ("mb", 6, 5, 1, 80, 112, 3),
    ("mb", 6, 5, 2, 112, 192, 4),
    ("mb", 6, 3, 1, 192, 320, 1),
]

_V1_MULTS = {  # width_mult, depth_mult
    "B0": (1.0, 1.0), "B1": (1.0, 1.1), "B2": (1.1, 1.2), "B3": (1.2, 1.4),
    "B4": (1.4, 1.8), "B5": (1.6, 2.2), "B6": (1.8, 2.6), "B7": (2.0, 3.1),
}

# torchvision efficientnet_v2 stage configs
_V2_CONFIGS = {
    "S": [
        ("fused", 1, 3, 1, 24, 24, 2),
        ("fused", 4, 3, 2, 24, 48, 4),
        ("fused", 4, 3, 2, 48, 64, 4),
        ("mb", 4, 3, 2, 64, 128, 6),
        ("mb", 6, 3, 1, 128, 160, 9),
        ("mb", 6, 3, 2, 160, 256, 15),
    ],
    "M": [
        ("fused", 1, 3, 1, 24, 24, 3),
        ("fused", 4, 3, 2, 24, 48, 5),
        ("fused", 4, 3, 2, 48, 80, 5),
        ("mb", 4, 3, 2, 80, 160, 7),
        ("mb", 6, 3, 1, 160, 176, 14),
        ("mb", 6, 3, 2, 176, 304, 18),
        ("mb", 6, 3, 1, 304, 512, 5),
    ],
    "L": [
        ("fused", 1, 3, 1, 32, 32, 4),
        ("fused", 4, 3, 2, 32, 64, 7),
        ("fused", 4, 3, 2, 64, 96, 7),
        ("mb", 4, 3, 2, 96, 192, 10),
        ("mb", 6, 3, 1, 192, 224, 19),
        ("mb", 6, 3, 2, 224, 384, 25),
        ("mb", 6, 3, 1, 384, 640, 7),
    ],
}


class ConvBNAct(nn.Module):
    """Conv2d + BatchNorm2d + optional SiLU (torchvision Conv2dNormActivation)."""

    conv_precision = "float32"  # layers.set_conv_precision binds it

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 groups: int, act: bool, bn_eps: float):
        super().__init__()
        self.stride = stride
        self.padding = (kernel - 1) // 2
        self.groups = groups
        self.act = act
        self.bn_eps = bn_eps
        self.add_module("0", nn.Conv2d(in_ch, out_ch, kernel, stride, self.padding,
                                       groups=groups, bias=False))
        self.add_module("1", nn.BatchNorm2d(out_ch, eps=bn_eps))

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        conv, bn = self._modules["0"], self._modules["1"]
        x, valid_hw = L.conv2d(x, conv.weight, None, valid_hw, stride=self.stride,
                               padding=self.padding, groups=self.groups,
                               precision=self.conv_precision)
        x = L.batchnorm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                        valid_hw, self.bn_eps)
        if self.act:
            x = L.silu(x)
        return x, valid_hw


class SqueezeExcitation(nn.Module):
    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        return L.squeeze_excitation(x, self.fc1.weight, self.fc1.bias,
                                    self.fc2.weight, self.fc2.bias, valid_hw)


class MBConv(nn.Module):
    """Inverted residual block with squeeze-excitation (torchvision MBConv)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand_ratio: int, bn_eps: float):
        super().__init__()
        exp_ch = in_ch * expand_ratio
        self.use_res = stride == 1 and in_ch == out_ch
        mods: list[nn.Module] = []
        if expand_ratio != 1:
            mods.append(ConvBNAct(in_ch, exp_ch, 1, 1, 1, True, bn_eps))
        mods.append(ConvBNAct(exp_ch, exp_ch, kernel, stride, exp_ch, True, bn_eps))
        mods.append(SqueezeExcitation(exp_ch, max(1, in_ch // 4)))
        mods.append(ConvBNAct(exp_ch, out_ch, 1, 1, 1, False, bn_eps))
        self.block = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        inp = x
        for mod in self.block:
            if isinstance(mod, SqueezeExcitation):
                x = mod(x, valid_hw)
            else:
                x, valid_hw = mod(x, valid_hw)
        if self.use_res:
            x = x + inp  # same valid region; zeros + zeros outside
        return x, valid_hw


class FusedMBConv(nn.Module):
    """Fused inverted residual (torchvision FusedMBConv, EfficientNetV2)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand_ratio: int, bn_eps: float):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        if expand_ratio != 1:
            exp_ch = in_ch * expand_ratio
            mods = [ConvBNAct(in_ch, exp_ch, kernel, stride, 1, True, bn_eps),
                    ConvBNAct(exp_ch, out_ch, 1, 1, 1, False, bn_eps)]
        else:
            mods = [ConvBNAct(in_ch, out_ch, kernel, stride, 1, True, bn_eps)]
        self.block = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        inp = x
        for mod in self.block:
            x, valid_hw = mod(x, valid_hw)
        if self.use_res:
            x = x + inp
        return x, valid_hw


class Stage(nn.ModuleList):
    """One stage: a sequence of blocks (a torchvision ``features`` child)."""

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        for blk in self:
            x, valid_hw = blk(x, valid_hw)
        return x, valid_hw


class Features(nn.Module):
    """The (truncated) ``features`` children list; ``forward(x, valid_hw)``
    returns ``(maps, valid_hw)``.

    Children register as ``features.{name}``: ``0``, ``1``, ... unless
    ``names`` gives torchvision's names (DenseNet's ``conv0``,
    ``denseblock1``, ...). Truncation is positional either way.
    """

    conv_precision = "float32"  # layers.set_conv_precision binds it

    def __init__(self, children: Sequence[nn.Module], out_channels: Sequence[int],
                 names: Sequence[str] | None = None):
        super().__init__()
        names = [str(i) for i in range(len(children))] if names is None else list(names)
        if len(names) != len(children):
            raise ValueError(f"{len(names)} names for {len(children)} children")
        self.features = nn.Sequential(OrderedDict(zip(names, children)))
        self.out_channels = list(out_channels)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        for child in self.features:
            x, valid_hw = child(x, valid_hw)
        return x, valid_hw


def build_kept(makers: Sequence[Callable[[], nn.Module]], out_channels: Sequence[int],
               block: int | None, label: str, names: Sequence[str] | None = None) -> Features:
    """``features[:block]`` (all when None) of a network given as one maker
    per child: only the kept children are built."""
    n = len(makers)
    block = n if block is None else block
    if not 0 < block <= n:
        raise ValueError(f"block {block} outside 1..{n} for {label}")
    return Features([mk() for mk in makers[:block]], out_channels[:block],
                    None if names is None else names[:block])


def _efficientnet(rows, head_out: int, bn_eps: float, block: int | None, label: str) -> Features:
    makers = [lambda: ConvBNAct(3, rows[0][4], 3, 2, 1, True, bn_eps)]
    out_chs = [rows[0][4]]
    for kind, expand, kernel, stride, in_ch, out_ch, n in rows:
        cls = MBConv if kind == "mb" else FusedMBConv

        def make(cls=cls, expand=expand, kernel=kernel, stride=stride,
                 in_ch=in_ch, out_ch=out_ch, n=n):
            return Stage([
                cls(in_ch if i == 0 else out_ch, out_ch, kernel,
                    stride if i == 0 else 1, expand, bn_eps)
                for i in range(n)
            ])

        makers.append(make)
        out_chs.append(out_ch)
    head_in = rows[-1][5]
    makers.append(lambda: ConvBNAct(head_in, head_out, 1, 1, 1, True, bn_eps))
    out_chs.append(head_out)
    return build_kept(makers, out_chs, block, label)


def efficientnet_v1(variant: str, block: int | None = None) -> Features:
    """``features[:block]`` of EfficientNet-``variant`` (B0-B7; all when
    None)."""
    width, depth = _V1_MULTS[variant]
    rows = [(kind, e, k, s, make_divisible(cin * width), make_divisible(cout * width),
             int(math.ceil(n * depth)))
            for kind, e, k, s, cin, cout, n in _V1_BASE]
    return _efficientnet(rows, 4 * rows[-1][5], BN_EPS_V1, block, f"EfficientNet_{variant}")


def efficientnet_v2(variant: str, block: int | None = None) -> Features:
    """``features[:block]`` of EfficientNetV2-``variant`` (S, M, L; all when
    None)."""
    return _efficientnet(_V2_CONFIGS[variant], 1280, BN_EPS_V2, block,
                         f"EfficientNetV2_{variant}")

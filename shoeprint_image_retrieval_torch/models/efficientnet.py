"""EfficientNetV2 backbone as masked ``nn.Module``s.

Frozen, inference-only EfficientNetV2 (the reference selects
``efficientnet_v2_m(IMAGENET1K_V1)``, reference network.py:167-170) exposed,
as in the reference, as a ``features`` children list truncated at an integer
block index (reference network.py:185-186:
``Sequential(features.children()[:block])``). Stochastic depth and dropout
are inference no-ops and are omitted.

Submodules are named as torchvision names them, so a torchvision
``features.*`` state dict loads with ``load_state_dict``:

* ``features.{i}`` for i = 0 (stem), 1..n (stages), n+1 (head);
* a conv-BN-activation is ``{0: conv, 1: bn}``;
* ``MBConv.block`` = [expand CNA if expand != 1, depthwise CNA,
  ``SqueezeExcitation(fc1, fc2)``, project CNA];
* ``FusedMBConv.block`` = [fused k x k CNA, 1x1 project CNA], or a single
  k x k CNA when expand == 1.

Every op runs through the masked primitives of :mod:`.layers`, so a
zero-padded batch of differently-sized images gives exactly the per-image
features. The port of ``shoeprint_image_retrieval_tpu/models/
efficientnet.py`` (V2 builder only; the V1 family is ROADMAP work).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from . import layers as L

BN_EPS_V2 = 1e-3

# (block_kind, expand, kernel, stride, in_ch, out_ch, layers) — torchvision
# efficientnet_v2 stage configs
_V2_CONFIGS = {
    "M": [
        ("fused", 1, 3, 1, 24, 24, 3),
        ("fused", 4, 3, 2, 24, 48, 5),
        ("fused", 4, 3, 2, 48, 80, 5),
        ("mb", 4, 3, 2, 80, 160, 7),
        ("mb", 6, 3, 1, 160, 176, 14),
        ("mb", 6, 3, 2, 176, 304, 18),
        ("mb", 6, 3, 1, 304, 512, 5),
    ],
}


class ConvBNAct(nn.Module):
    """Conv2d + BatchNorm2d + optional SiLU (torchvision Conv2dNormActivation)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True, bn_eps: float = BN_EPS_V2):
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
                               padding=self.padding, groups=self.groups)
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
    returns ``(maps, valid_hw)``."""

    def __init__(self, children: Sequence[nn.Module], out_channels: Sequence[int]):
        super().__init__()
        self.features = nn.ModuleList(children)
        self.out_channels = list(out_channels)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        for child in self.features:
            x, valid_hw = child(x, valid_hw)
        return x, valid_hw


def efficientnet_v2(variant: str, block: int | None = None) -> Features:
    """``features[:block]`` of EfficientNetV2-``variant`` (all when None).
    Only the kept children are built."""
    rows = _V2_CONFIGS[variant]
    n_children = len(rows) + 2
    block = n_children if block is None else block
    if not 0 < block <= n_children:
        raise ValueError(f"block {block} outside 1..{n_children} for EfficientNetV2_{variant}")
    makers = [lambda: ConvBNAct(3, rows[0][4], 3, 2, 1, True, BN_EPS_V2)]
    out_chs = [rows[0][4]]
    for kind, expand, kernel, stride, in_ch, out_ch, n in rows:
        cls = MBConv if kind == "mb" else FusedMBConv

        def make(cls=cls, expand=expand, kernel=kernel, stride=stride,
                 in_ch=in_ch, out_ch=out_ch, n=n):
            return Stage([
                cls(in_ch if i == 0 else out_ch, out_ch, kernel,
                    stride if i == 0 else 1, expand, BN_EPS_V2)
                for i in range(n)
            ])

        makers.append(make)
        out_chs.append(out_ch)
    head_in = rows[-1][5]
    makers.append(lambda: ConvBNAct(head_in, 1280, 1, 1, 1, True, BN_EPS_V2))
    out_chs.append(1280)
    return Features([mk() for mk in makers[:block]], out_chs[:block])

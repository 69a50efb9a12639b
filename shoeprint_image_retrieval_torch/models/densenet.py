"""DenseNet-201 backbone as masked ``nn.Module``s.

torchvision's DenseNet ``features`` has 12 *named* children (reference
network.py:176-179, 185-186): ``conv0, norm0, relu0, pool0, denseblock1,
transition1, denseblock2, transition2, denseblock3, transition3,
denseblock4, norm5``. They register here under the same names
(``Features(names=...)``), so a torchvision state dict's keys
(``features.conv0.weight``, ``features.denseblock1.denselayer1.norm1.weight``)
load as they are, while truncation stays positional (``features[:block]``).

A dense layer is BN-ReLU-1x1 conv (the bottleneck) then BN-ReLU-3x3 conv,
and concatenates its ``growth`` new channels onto its input; a transition
is BN-ReLU-1x1 conv (half the channels) then a 2 x 2 average pool.

The port of ``shoeprint_image_retrieval_tpu/models/densenet.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .efficientnet import Features, build_kept

BN_EPS = 1e-5  # torchvision's BatchNorm2d default
CHILD_NAMES = (
    "conv0", "norm0", "relu0", "pool0",
    "denseblock1", "transition1", "denseblock2", "transition2",
    "denseblock3", "transition3", "denseblock4", "norm5",
)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d, valid_hw: torch.Tensor) -> torch.Tensor:
    return L.batchnorm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, valid_hw, bn.eps)


class Conv0(nn.Conv2d):
    """7 x 7 stem conv, stride 2, padding 3, no bias."""

    conv_precision = "float32"  # layers.set_conv_precision binds it

    def __init__(self, out_ch: int):
        super().__init__(3, out_ch, 7, 2, 3, bias=False)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        return L.conv2d(x, self.weight, None, valid_hw, stride=2, padding=3,
                        precision=self.conv_precision)


class Norm(nn.BatchNorm2d):
    def __init__(self, ch: int):
        super().__init__(ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        return _bn(x, self, valid_hw), valid_hw


class ReLU0(nn.Module):
    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        return L.relu(x), valid_hw


class Pool0(nn.Module):
    """3 x 3 max pool, stride 2, padding 1; it follows a ReLU."""

    pool = (3, 2, 1)  # kernel, stride, padding

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        k, s, p = self.pool
        return L.max_pool(x, valid_hw, kernel=k, stride=s, padding=p)


class DenseLayer(nn.Module):
    conv_precision = "float32"  # layers.set_conv_precision binds it

    def __init__(self, in_ch: int, growth: int = 32, bn_size: int = 4):
        super().__init__()
        mid = bn_size * growth
        self.norm1 = nn.BatchNorm2d(in_ch, eps=BN_EPS)
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(mid, eps=BN_EPS)
        self.conv2 = nn.Conv2d(mid, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        y = L.relu(_bn(x, self.norm1, valid_hw))
        y, _ = L.conv2d(y, self.conv1.weight, None, valid_hw, stride=1, padding=0,
                        precision=self.conv_precision)
        y = L.relu(_bn(y, self.norm2, valid_hw))
        y, _ = L.conv2d(y, self.conv2.weight, None, valid_hw, stride=1, padding=1,
                        precision=self.conv_precision)
        return torch.cat([x, y], dim=1), valid_hw


class DenseBlock(nn.Module):
    """``n_layers`` dense layers, registered as ``denselayer1..n``."""

    def __init__(self, in_ch: int, n_layers: int, growth: int = 32):
        super().__init__()
        for j in range(n_layers):
            self.add_module(f"denselayer{j + 1}", DenseLayer(in_ch + j * growth, growth))
        self.out_ch = in_ch + n_layers * growth

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        for layer in self.children():
            x, valid_hw = layer(x, valid_hw)
        return x, valid_hw


class Transition(nn.Module):
    pool = (2, 2, 0)  # the average pool after the conv: kernel, stride, padding
    conv_precision = "float32"  # layers.set_conv_precision binds it

    def __init__(self, in_ch: int):
        super().__init__()
        self.out_ch = in_ch // 2
        self.norm = nn.BatchNorm2d(in_ch, eps=BN_EPS)
        self.conv = nn.Conv2d(in_ch, self.out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        x = L.relu(_bn(x, self.norm, valid_hw))
        x, valid_hw = L.conv2d(x, self.conv.weight, None, valid_hw, stride=1, padding=0,
                               precision=self.conv_precision)
        k, s, p = self.pool
        return L.avg_pool(x, valid_hw, kernel=k, stride=s, padding=p)


def densenet201(block: int | None = None) -> Features:
    """``features[:block]`` of DenseNet-201 (all 12 children when None)."""
    block_cfg, growth, init_ch = (6, 12, 48, 32), 32, 64
    makers = [lambda: Conv0(init_ch), lambda: Norm(init_ch), ReLU0, Pool0]
    out_chs = [init_ch] * 4
    ch = init_ch
    for i, n in enumerate(block_cfg):
        makers.append(lambda ch=ch, n=n: DenseBlock(ch, n, growth))
        ch += n * growth
        out_chs.append(ch)
        if i != len(block_cfg) - 1:
            makers.append(lambda ch=ch: Transition(ch))
            ch //= 2
            out_chs.append(ch)
    makers.append(lambda ch=ch: Norm(ch))
    out_chs.append(ch)
    return build_kept(makers, out_chs, block, "DenseNet_201", CHILD_NAMES)

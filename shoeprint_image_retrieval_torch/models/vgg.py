"""VGG16, VGG19 and VGG19-BN backbones as masked ``nn.Module``s.

The reference's block indices for VGG slice torchvision's ``features``
children list, in which every conv, BN, ReLU and max pool is its own child
(reference network.py:121-138, 185-186): VGG16 has 31 children, VGG19 37
and VGG19-BN 53. Each op here is its own child as well, so truncation and
the state-dict keys (``features.{i}.weight``, ``.bias``; BN's running
statistics) match torchvision's.

The port of ``shoeprint_image_retrieval_tpu/models/vgg.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .efficientnet import Features, build_kept

BN_EPS = 1e-5  # torchvision's BatchNorm2d default

# torchvision cfgs: "D" = VGG16, "E" = VGG19 (number = conv out_ch, M = pool)
_CFGS = {
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class Conv(nn.Conv2d):
    """3 x 3 conv with bias, stride 1, padding 1."""

    conv_precision = "float32"  # layers.set_conv_precision binds it

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, 1, 1)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        return L.conv2d(x, self.weight, self.bias, valid_hw, stride=1, padding=1,
                        precision=self.conv_precision)


class BatchNorm(nn.BatchNorm2d):
    def __init__(self, ch: int):
        super().__init__(ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        return L.batchnorm(x, self.weight, self.bias, self.running_mean, self.running_var,
                           valid_hw, self.eps), valid_hw


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        return L.relu(x), valid_hw


class MaxPool(nn.Module):
    """2 x 2 max pool, stride 2; it follows a ReLU."""

    pool = (2, 2, 0)  # kernel, stride, padding

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor):
        k, s, p = self.pool
        return L.max_pool(x, valid_hw, kernel=k, stride=s, padding=p)


def vgg(variant: str, block: int | None = None) -> Features:
    """``features[:block]`` of ``variant`` (VGG16, VGG19, VGG19_BN; all when
    None)."""
    batch_norm = variant == "VGG19_BN"
    cfg = _CFGS["VGG19" if batch_norm else variant]
    makers, out_chs = [], []
    in_ch = 3
    for v in cfg:
        if v == "M":
            makers.append(MaxPool)
            out_chs.append(in_ch)
            continue
        makers.append(lambda i=in_ch, o=v: Conv(i, o))
        out_chs.append(v)
        if batch_norm:
            makers.append(lambda o=v: BatchNorm(o))
            out_chs.append(v)
        makers.append(ReLU)
        out_chs.append(v)
        in_ch = v
    return build_kept(makers, out_chs, block, variant)

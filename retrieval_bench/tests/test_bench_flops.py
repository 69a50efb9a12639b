"""The frozen needed-FLOP count and the backbones' conv FLOP and output
sizes, each against a brute-force count at tiny sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from retrieval_bench import flops, weights
from retrieval_bench.reference import backbones


def brute_needed(rows, prints, c):
    total = 0
    for h, w in rows:
        for vh, vw in prints:
            for y in range(vh):
                ty = sum(1 for i in range(y - h // 2, y + (h - 1) // 2 + 1) if 0 <= i < vh)
                for x in range(vw):
                    tx = sum(1 for j in range(x - w // 2, x + (w - 1) // 2 + 1) if 0 <= j < vw)
                    total += ty * tx
    return 2.0 * c * total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_needed_flop_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 9, size=(5, 2))
    prints = rng.integers(1, 12, size=(4, 2))
    assert flops.needed_flop(rows, prints, 3) == brute_needed(rows, prints, 3)


def test_variant_windows_reference_mode():
    got = flops.variant_windows((20, 15), 7, [1.02, 1.04, 1.08])
    assert len(got) == 25
    assert tuple(got[0]) == (16, 11)
    assert sorted(map(tuple, got[1:])) == sorted([(int(20 * s) - 4, int(15 * s) - 4)
                                                 for _ in range(8) for s in (1.02, 1.04, 1.08)])


def test_bound_takes_the_larger_term():
    assert flops.bound_seconds(flops.PEAK_F32_FLOPS, 0.0) == 1.0
    assert flops.bound_seconds(0.0, flops.PEAK_BYTES_PER_S * 2) == 2.0


@pytest.mark.parametrize("model,block,hw", [("EfficientNetV2_M", 4, (37, 29)),
                                            ("EfficientNetV2_M", 6, (41, 35)),
                                            ("VGG16", 17, (30, 27)), ("VGG16", 24, (35, 33))])
def test_backbone_flop_and_size_against_counted_forward(model, block, hw, monkeypatch):
    ops = backbones.network(model, block)
    w = weights.make(model, block, 5, torch.device("cpu"))
    counted = []
    real = F.conv2d

    def conv(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        y = real(x, weight, bias, stride, padding, dilation, groups)
        counted.append(2.0 * y.numel() * weight.shape[1] * weight.shape[2] * weight.shape[3])
        return y

    monkeypatch.setattr(F, "conv2d", conv)
    y = backbones.forward(ops, w, torch.zeros((1, 3, *hw)))
    assert tuple(y.shape[2:]) == backbones.out_size(ops, hw)
    assert y.shape[1] == backbones.channels(ops)
    assert backbones.conv_flop(ops, hw) == sum(counted)


def test_ingest_size():
    assert flops.ingest_hw((570, 700), (0.05, 0.05), 1.0) == (700 - 2 * 35, 570 - 2 * 28)

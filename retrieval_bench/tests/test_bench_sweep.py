"""The reference's float64 variant sweep against PIL's own float32 one:
rotations equal, scales equal once PIL's float32 rounding after each pass
is made too."""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from retrieval_bench.reference import ncc

SHAPES = [(5, 7), (20, 17), (34, 34), (47, 39), (84, 68)]


def pil(maps, op):
    return np.stack([np.asarray(op(Image.fromarray(ch))) for ch in maps]).astype(np.float64)


@pytest.mark.parametrize("hw", SHAPES)
def test_rotations_are_pils(hw):
    maps = np.random.default_rng(hw).standard_normal((3, *hw)).astype(np.float32)
    for deg in (-15, -9, -3, 3, 9, 15, 180, 37.5):
        got = ncc.rotate_nearest(maps.astype(np.float64), deg)
        assert got.dtype == np.float64
        assert np.array_equal(got, pil(maps, lambda im: im.rotate(deg)))


@pytest.mark.parametrize("hw", SHAPES)
def test_scales_are_pils_taps(hw):
    h, w = hw
    maps = np.random.default_rng(hw).standard_normal((3, h, w)).astype(np.float32)
    for s in (0.5, 1.02, 1.04, 1.08, 2.3):
        size = (int(w * s), int(h * s))
        want = pil(maps, lambda im: im.resize(size))
        rows, cols = ncc.bicubic_matrix(h, size[1]), ncc.bicubic_matrix(w, size[0])
        tmp = maps if size[0] == w else (maps.astype(np.float64) @ cols.T).astype(np.float32)
        emulated = tmp if size[1] == h else (rows @ tmp.astype(np.float64)).astype(np.float32)
        assert np.abs(emulated - want).max() <= 1e-8
        got = ncc.resize_bicubic(maps, size)
        assert got.dtype == np.float64
        assert np.abs(got - want).max() <= 1e-6


def test_sweep_is_float64_throughout():
    maps = np.random.default_rng(0).standard_normal((2, 20, 17))
    out = ncc.variants(maps, [-3, 180], [1.02, 1.08])
    assert len(out) == 1 + 3 * 2
    assert all(v.dtype == np.float64 for v in out)
    assert np.array_equal(out[0], maps)

"""The port's device CLAHE (``ops/clahe.py``) against the JAX package's and cv2.

Seeded uint8 inputs go through both packages' functions of the same name
and through OpenCV; every comparison is bit-exact. Below the tile grid cv2
reflects its border again where ``clahe_batched_dynamic`` clamps (as the
native host CLAHE does), so those sizes are held against JAX only.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_tpu.ops import clahe as jclahe
from shoeprint_image_retrieval_torch.ops import clahe as tclahe


def _cv2_clahe(img, clip=2.0, grid=(8, 8)):
    return cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(img)


def _cv2_clahe_rgb(img, clip=2.0, grid=(8, 8)):
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    lab[..., 0] = _cv2_clahe(lab[..., 0], clip, grid)
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


@pytest.mark.parametrize("hw,clip,grid", [
    ((37, 53), 2.0, (8, 8)),
    ((64, 64), 2.0, (8, 8)),     # divisible: no padding
    ((64, 61), 2.0, (8, 8)),     # one axis divides: it still gets a tile of padding
    ((75, 65), 3.5, (8, 8)),     # LUT scale 255 / 90: one division, not a reciprocal
    ((100, 71), 1.0, (4, 6)),    # a non-square grid in cv2's (width, height) order
])
def test_gray_matches_jax_and_cv2(hw, clip, grid):
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw, dtype=np.uint8)
    got = tclahe.clahe_u8(torch.from_numpy(img), clip, grid).numpy()
    np.testing.assert_array_equal(got, np.asarray(jclahe.clahe_u8(jnp.asarray(img), clip, grid)))
    np.testing.assert_array_equal(got, _cv2_clahe(img, clip, grid))


def test_rgb_matches_jax_and_cv2():
    img = np.random.default_rng(1).integers(0, 256, (45, 61, 3), dtype=np.uint8)
    got = tclahe.clahe_image(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jclahe.clahe_image(jnp.asarray(img))))
    np.testing.assert_array_equal(got, _cv2_clahe_rgb(img))


def _padded(sizes, canvas, seed):
    rng = np.random.default_rng(seed)
    imgs = np.zeros((len(sizes), *canvas), np.uint8)
    for i, (h, w) in enumerate(sizes):
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w))
    # the padding is ignored: fill it with noise to prove it
    imgs[:, canvas[0] - 1] = rng.integers(0, 256, (len(sizes), canvas[1]))
    return imgs, np.asarray(sizes, np.int32)


def test_batched_dynamic_matches_jax_and_cv2():
    sizes = [(37, 53), (80, 90), (64, 64), (75, 65), (76, 66), (9, 8)]
    imgs, valid = _padded(sizes, (81, 90), 2)
    got = tclahe.clahe_batched_dynamic(torch.from_numpy(imgs), torch.from_numpy(valid)).numpy()
    want = np.asarray(jclahe.clahe_batched_dynamic(jnp.asarray(imgs), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    for i, (h, w) in enumerate(sizes):
        np.testing.assert_array_equal(got[i, :h, :w], _cv2_clahe(np.ascontiguousarray(imgs[i, :h, :w])))
        assert not got[i, h:].any() and not got[i, :, w:].any()


def test_below_tile_grid_matches_jax():
    sizes = [(5, 40), (3, 3), (1, 7), (7, 12), (12, 1), (2, 2)]
    imgs, valid = _padded(sizes, (13, 41), 3)
    got = tclahe.clahe_batched_dynamic(torch.from_numpy(imgs), torch.from_numpy(valid)).numpy()
    want = np.asarray(jclahe.clahe_batched_dynamic(jnp.asarray(imgs), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    for h, w in sizes[:3]:  # the single-image function reflects again, as jnp.pad does
        img = np.random.default_rng(h * 100 + w).integers(0, 256, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(tclahe.clahe_u8(torch.from_numpy(img)).numpy(),
                                      np.asarray(jclahe.clahe_u8(jnp.asarray(img))))


def test_lab_round_trip_matches_jax_and_cv2():
    """A random 2^18-pixel sample of RGB and of LAB, plus every gray level."""
    rng = np.random.default_rng(4)
    gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    rgb = np.concatenate([rng.integers(0, 256, (1 << 18, 3), dtype=np.uint8), gray])[None]
    lab = np.concatenate([rng.integers(0, 256, (1 << 18, 3), dtype=np.uint8), gray])[None]
    t_lab = tclahe.rgb_to_lab_u8(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(t_lab, cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB))
    np.testing.assert_array_equal(t_lab, np.asarray(jclahe.rgb_to_lab_u8(jnp.asarray(rgb))))
    t_rgb = tclahe.lab_u8_to_rgb(torch.from_numpy(lab)).numpy()
    np.testing.assert_array_equal(t_rgb, cv2.cvtColor(lab, cv2.COLOR_LAB2RGB))
    np.testing.assert_array_equal(t_rgb, np.asarray(jclahe.lab_u8_to_rgb(jnp.asarray(lab))))

"""The port's ingest tiers (``data/loader.py``, ``data/native_ingest.py``)
against PIL's ``load_one`` and the JAX package's native crop/resize.

Every tier must give PIL's bytes. The native decode tier exists only where
the library was built with libjpeg/libpng and its decode matched Pillow's on
the self-check: its case skips inside the test where that is not so.
"""

from collections import Counter
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from shoeprint_image_retrieval_tpu.data import native_ingest as jni
from shoeprint_image_retrieval_torch.data import loader
from shoeprint_image_retrieval_torch.data import native_ingest as tni

SCALE, CROP = 0.7, (0.05, 0.1)


def _gray(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.clip(127 + 60 * np.sin(x / 5.0) * np.cos(y / 7.0)
                   + rng.normal(0, 20, (h, w)), 0, 255).astype(np.uint8)


def _write(root: Path, kind: str, n: int = 5) -> list[str]:
    rng = np.random.default_rng(len(kind))
    files = []
    for i in range(n):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        img = _gray(rng, h, w)
        if kind == "jpeg":
            name = f"{i}.jpg"
            Image.fromarray(img).save(root / name, quality=92)  # the fixture's quality
        elif kind == "png":
            name = f"{i}.png"
            Image.fromarray(img).save(root / name)
        elif kind == "rgb":
            name = f"{i}.png"
            Image.fromarray(np.stack([img, img[::-1], 255 - img], axis=-1)).save(root / name)
        else:  # a palette image: PIL resizes it by its own rules
            name = f"{i}.png"
            Image.fromarray(img).convert("P").save(root / name)
        files.append(name)
    return files


def _want(root, files):
    return [loader.load_one(root / f, SCALE, CROP) for f in files]


def test_crop_resize_batch_matches_pil_and_jax():
    rng = np.random.default_rng(0)
    imgs = [_gray(rng, int(rng.integers(20, 120)), int(rng.integers(20, 120))) for _ in range(6)]
    crops = [(int(rng.integers(0, 5)), int(rng.integers(0, 5))) for _ in imgs]
    outs = [(int(rng.integers(5, 130)), int(rng.integers(5, 130))) for _ in imgs]
    got = tni.crop_resize_batch(imgs, crops, outs, n_threads=3)
    np.testing.assert_equal(got, jni.crop_resize_batch(imgs, crops, outs, n_threads=2))
    for im, (ch, cw), (oh, ow), g in zip(imgs, crops, outs, got):
        pil = Image.fromarray(im).crop((cw, ch, im.shape[1] - cw, im.shape[0] - ch))
        np.testing.assert_array_equal(g, np.asarray(pil.resize((ow, oh), Image.Resampling.LANCZOS)))
    with pytest.raises(ValueError):
        tni.crop_resize_batch([np.zeros((8, 8, 3), np.uint8)], [(0, 0)], [(4, 4)])


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_native_decode_tier_matches_pil(tmp_path, kind):
    if not tni.decode_available():
        pytest.skip(f"native decode unavailable here (codecs built: {tni.has_codecs()})")
    files = _write(tmp_path, kind)
    tiers = Counter()
    got = loader.load_images(tmp_path, files, SCALE, CROP, 2, tiers)
    assert tiers == {"native": 1}
    np.testing.assert_equal(got, _want(tmp_path, files))


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_pil_decode_native_resize_tier_matches_pil(tmp_path, kind, monkeypatch):
    monkeypatch.setattr(tni, "decode_available", lambda: False)
    files = _write(tmp_path, kind)
    tiers = Counter()
    got = loader.load_images(tmp_path, files, SCALE, CROP, 2, tiers)
    assert tiers == {"pil+native": 1}
    np.testing.assert_equal(got, _want(tmp_path, files))


@pytest.mark.parametrize("kind", ["rgb", "palette"])
def test_pil_tier_matches_pil(tmp_path, kind):
    """Sets the native tiers cannot take: colour, and palette images (their
    indices are uint8 and 2-D, but PIL does not resample them with Lanczos)."""
    files = _write(tmp_path, kind)
    tiers = Counter()
    got = loader.load_images(tmp_path, files, SCALE, CROP, 2, tiers)
    assert tiers == {"pil": 1}
    np.testing.assert_equal(got, _want(tmp_path, files))


def test_failed_decode_self_check_turns_the_native_tier_off(tmp_path, monkeypatch):
    monkeypatch.setattr(tni, "_decode_ok", None)
    monkeypatch.setattr(tni, "_decode_self_check", lambda: False)
    assert tni.decode_available() is False
    files = _write(tmp_path, "png", n=2)
    hw = [np.asarray(Image.open(tmp_path / f)).shape for f in files]
    assert tni.ingest_files([tmp_path / f for f in files], hw, [(0, 0)] * 2, hw) is None
    tiers = Counter()
    loader.load_images(tmp_path, files, SCALE, CROP, 1, tiers)
    assert tiers == {"pil+native": 1}

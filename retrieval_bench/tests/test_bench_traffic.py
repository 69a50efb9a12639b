"""The generator: the same seed gives the same images, other seeds the
same sizes; the cache keeps the two newest datasets."""

from __future__ import annotations

import hashlib

import numpy as np
from PIL import Image

from retrieval_bench import traffic

TINY = {"gallery": 5, "print_h": [64, 80], "print_w": [56, 70], "marks": 3,
        "mark_share": [0.75, 0.9], "layout_seed": 9}


def listing(root):
    out = {}
    for p in sorted(root.rglob("*.jpg")):
        with Image.open(p) as im:
            out[str(p.relative_to(root))] = (im.size, hashlib.sha256(im.tobytes()).hexdigest())
    return out


def test_same_seed_same_images_other_seed_same_sizes(tmp_path):
    a = listing(traffic.dataset(TINY, 2**32 + 3, workers=2, cache=tmp_path / "a"))
    b = listing(traffic.dataset(TINY, 2**32 + 3, workers=1, cache=tmp_path / "b"))
    c = listing(traffic.dataset(TINY, 7, workers=1, cache=tmp_path / "c"))
    assert a == b
    assert {k: v[0] for k, v in a.items()} == {k: v[0] for k, v in c.items()}
    assert any(a[k][1] != c[k][1] for k in a)
    assert len([k for k in a if k.startswith("Query")]) == 3


def test_cache_keeps_the_two_newest(tmp_path):
    for seed in (1, 2, 3):
        traffic.dataset(TINY, seed, workers=1, cache=tmp_path)
    kept = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert len(kept) == traffic.KEEP
    assert traffic.dataset_key(TINY, 1) not in {p.name for p in kept}


def test_generator_is_the_fixture_generator():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / "scripts" / "make_synthetic_impress.py"
    spec = importlib.util.spec_from_file_location("fixture_gen", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for seed in range(3):
        assert np.array_equal(traffic.tread_print(np.random.default_rng(seed), 70, 50),
                              mod.tread_print(np.random.default_rng(seed), 70, 50))

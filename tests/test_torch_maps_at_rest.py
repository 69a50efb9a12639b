"""Where gallery maps rest between extraction and scoring.

* ``engine._device_maps_budget``: a share of a card's free memory, 2 GB on
  the CPU, ``SIR_DEVICE_MAPS_MAX`` over both;
* ``retrieval/gallery.GalleryFeatureCache``: maps on the device kept as
  that tensor within the budget, the oldest moved to the host past it, the
  disk copy as before;
* ``Pipeline.maps_at_rest``: a standing pipeline's later calls score the
  first call's maps where they lie, with the scores of a fresh pipeline.

All on the CPU, where the pipeline's device is the CPU: maps it keeps there
are CPU tensors, maps at rest on the host NumPy arrays.
"""

import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_torch.config import load_config
from shoeprint_image_retrieval_torch.retrieval import engine
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline
from shoeprint_image_retrieval_torch.retrieval.gallery import GalleryFeatureCache

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import RUN_TOML, START_BLOCK, _make_dataset  # noqa: E402

FREE = 72 * 1024**3


@pytest.mark.parametrize("device,env,want", [
    ("cuda", None, int(FREE * engine.DEVICE_MAPS_SHARE)),
    ("cuda", "0", 0),
    ("cuda", "12345", 12345),
    ("cpu", None, int(2e9)),
    ("cpu", "0", 0),
    ("cpu", "12345", 12345),
])
def test_device_maps_budget(monkeypatch, device, env, want):
    """On a card a quarter of its free memory (read through a stand-in for
    ``device.free_bytes``), on the CPU 2 GB; ``SIR_DEVICE_MAPS_MAX`` wins
    on both."""
    seen = []
    monkeypatch.setattr(engine, "free_bytes", lambda d: seen.append(d) or FREE)
    if env is None:
        monkeypatch.delenv("SIR_DEVICE_MAPS_MAX", raising=False)
    else:
        monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", env)
    assert engine.DEVICE_MAPS_SHARE == 0.25
    assert engine._device_maps_budget(torch.device(device)) == want
    assert seen == ([torch.device(device)] if device == "cuda" and env is None else [])


def _maps(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 2, 4, 4))
                            .astype(np.float32))


def test_feature_cache_keeps_device_maps_within_the_budget():
    cache = GalleryFeatureCache()
    a, b = _maps(3, 0), _maps(2, 1)
    budget = a.nbytes + b.nbytes
    cache.put("a", a, np.ones((3, 2)), device_budget=budget)
    cache.put("b", b, np.ones((2, 2)), device_budget=budget)
    assert cache.get("a")[0] is a and cache.get("b")[0] is b
    assert cache.device_bytes() == budget
    host = np.zeros((1, 2, 4, 4), np.float32)
    cache.put("h", host, np.ones((1, 2)), device_budget=budget)  # host maps stay NumPy
    assert cache.get("h")[0] is host and cache.device_bytes() == a.nbytes + b.nbytes


def test_feature_cache_moves_the_oldest_device_entry_to_the_host():
    """Past the budget the oldest device entries go to the host as NumPy
    copies of the same values; the device total never passes the budget;
    an entry over the budget on its own goes to the host too."""
    cache = GalleryFeatureCache()
    maps = {k: _maps(2, i) for i, k in enumerate("abcd")}
    budget = 2 * maps["a"].nbytes
    for k, m in maps.items():
        cache.put(k, m, np.ones((2, 2)), device_budget=budget)
        assert cache.device_bytes() <= budget
        assert cache.get(k)[0] is m
    for k, m in maps.items():
        got = cache.get(k)[0]
        assert isinstance(got, np.ndarray if k in "ab" else torch.Tensor)
        np.testing.assert_array_equal(np.asarray(got), m.numpy())
    big = _maps(5, 9)
    cache.put("big", big, np.ones((5, 2)), device_budget=budget)
    assert cache.device_bytes() <= budget
    assert isinstance(cache.get("big")[0], np.ndarray)
    np.testing.assert_array_equal(cache.get("big")[0], big.numpy())


def test_feature_cache_puts_from_many_threads_keep_the_budget():
    """More threads than cores putting and getting at once, the interpreter
    switching often: every entry is kept, with its values, and the device
    entries stay within the budget."""
    n = 4 * (os.cpu_count() or 1)
    cache = GalleryFeatureCache()
    maps = [_maps(2, i) for i in range(n)]
    budget = 3 * maps[0].nbytes
    barrier = threading.Barrier(n, timeout=30)

    def work(i):
        barrier.wait()
        for r in range(20):
            cache.put(f"{i}.{r % 3}", maps[i], np.ones((2, 2)), device_budget=budget)
            assert cache.get(f"{i}.{r % 3}") is not None

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(cache._ram) == 3 * n and cache.device_bytes() <= budget
    for i in range(n):
        for r in range(3):
            np.testing.assert_array_equal(np.asarray(cache.get(f"{i}.{r}")[0]), maps[i].numpy())


def test_feature_cache_disk_copy_is_unchanged(tmp_path):
    """With ``cache_dir`` a device entry is still written as ``.npz`` from a
    host copy, and a disk hit comes back on the host."""
    m, v = _maps(3), np.arange(6, dtype=np.int32).reshape(3, 2)
    cache = GalleryFeatureCache(tmp_path / "c")
    cache.put("k", m, v, device_budget=m.nbytes)
    assert cache.get("k")[0] is m
    with np.load(tmp_path / "c" / "k.npz") as z:
        np.testing.assert_array_equal(z["maps"], m.numpy())
        np.testing.assert_array_equal(z["valid"], v)
    warm = GalleryFeatureCache(tmp_path / "c").get("k")
    assert isinstance(warm[0], np.ndarray)
    np.testing.assert_array_equal(warm[0], m.numpy())
    np.testing.assert_array_equal(warm[1], v)


def _config(tmp_path, extra=""):
    if not (tmp_path / "data").exists():
        _make_dataset(tmp_path / "data", np.random.default_rng(11))
    cfg = tmp_path / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=tmp_path / "data", start=START_BLOCK)
                   + "pipeline_clusters = false\n" + extra)
    return load_config(cfg)


@pytest.mark.parametrize("budget,cache_dtype,where", [
    (None, "float32", "device"),
    (None, "bfloat16", "device"),
    ("0", "float32", "host"),
])
def test_standing_pipeline_scores_its_maps_where_they_rest(tmp_path, monkeypatch, budget,
                                                           cache_dtype, where):
    """Two calls on one cluster of one pipeline: the second takes the
    gallery from the feature cache, where the first left it, and its scores
    and ranks are bit-identical to a fresh pipeline's. Under
    ``cache_dtype = "bfloat16"`` maps on the device stay float32 in both
    calls."""
    if budget is None:
        monkeypatch.delenv("SIR_DEVICE_MAPS_MAX", raising=False)
    else:
        monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", budget)
    cfg = _config(tmp_path, f'cache_dtype = "{cache_dtype}"\n')
    pipe = Pipeline(cfg, weights_dir=None, verbose=False, device="cpu")
    plan = pipe.plans[0]
    outs = [pipe.run_cluster(plan) for _ in range(2)]
    assert pipe.maps_at_rest == {where: 2}
    (entry,) = pipe.gallery_cache._ram.values()
    assert isinstance(entry[0], torch.Tensor if where == "device" else np.ndarray)
    fresh = Pipeline(cfg, weights_dir=None, verbose=False, device="cpu").run_cluster(plan)
    for out in outs:
        np.testing.assert_array_equal(out.scores, fresh.scores)
        np.testing.assert_array_equal(out.ranks, fresh.ranks)


def test_multi_cluster_run_keeps_the_cache_within_the_budget(tmp_path, monkeypatch):
    """Two clusters (blocks 2 and 3), each set's maps under the budget but
    not both: after ``run()`` the feature cache holds one of them on the
    device and the other on the host; the scores are those of a run that
    kept both."""
    monkeypatch.delenv("SIR_DEVICE_MAPS_MAX", raising=False)
    cfg = _config(tmp_path)
    roomy = Pipeline(cfg, weights_dir=None, verbose=False, device="cpu")
    want = list(roomy.run())
    sizes = [m.nbytes for m, _ in roomy.gallery_cache._ram.values()]
    assert len(sizes) == 2 and roomy.gallery_cache.device_bytes() == sum(sizes)
    monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", str(max(sizes)))
    tight = Pipeline(cfg, weights_dir=None, verbose=False, device="cpu")
    got = list(tight.run())
    assert tight.maps_at_rest == {"device": 2}
    assert tight.gallery_cache.device_bytes() <= max(sizes)
    kinds = sorted(type(m).__name__ for m, _ in tight.gallery_cache._ram.values())
    assert kinds == ["Tensor", "ndarray"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.scores, w.scores)
        np.testing.assert_array_equal(g.ranks, w.ranks)

"""The port's host-side modules against the JAX package's: exactly equal.

PIL-exact warp planners, the engine's per-cluster variant plan, config
loading, the cluster planner, dataset discovery, metrics, normalisation and
the host CLAHE binding.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from shoeprint_image_retrieval_tpu.ops import warp as jwarp
from shoeprint_image_retrieval_torch.ops import warp as twarp

ANGLES = [-15, -9, -3, 0, 3, 9, 15, 45.5, 90, 180, 270, 359]
SIZES = [(13, 17), (16, 16), (9, 24), (30, 28), (1, 5)]


@pytest.mark.parametrize("hw", SIZES)
def test_rotate_index_map_equal(hw):
    for deg in ANGLES:
        for canvas in (None, (hw[0] + 3, hw[1] + 5)):
            want = jwarp.rotate_index_map(hw, deg, canvas_hw=canvas)
            got = twarp.rotate_index_map(hw, deg, canvas_hw=canvas)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("in_size", [1, 7, 17, 36])
def test_resample_weights_equal(in_size):
    for scale in (0.5, 1.0, 1.02, 1.04, 1.08, 2.3):
        out = max(1, int(in_size * scale))
        want = jwarp.resample_weights(in_size, out, "bicubic", canvas_in=in_size + 2,
                                      canvas_out=out + 3)
        got = twarp.resample_weights(in_size, out, canvas_in=in_size + 2, canvas_out=out + 3)
        np.testing.assert_array_equal(got, want)


def test_pil_resize_size_equal():
    for hw in SIZES:
        for s in (1.02, 1.04, 1.08, 0.37):
            assert twarp.pil_resize_size(hw, s) == jwarp.pil_resize_size(hw, s)


def test_rotation_applier_matches_pil():
    """The engine's rotation gather, driven by the planner's maps, is PIL's
    ``Image.rotate`` exactly."""
    from shoeprint_image_retrieval_torch.retrieval.engine import rotate_maps

    rng = np.random.default_rng(7)
    img = rng.normal(size=(13, 17)).astype(np.float32)
    degs = (9, 180, -15)
    maps = [twarp.rotate_index_map(img.shape, deg) for deg in degs]
    idx = torch.from_numpy(np.stack([m[0].reshape(-1) for m in maps]))[None]
    ok = torch.from_numpy(np.stack([m[1] for m in maps]))[None]
    got = rotate_maps(torch.from_numpy(img)[None, None], idx, ok)[0, :, 0].numpy()
    for k, deg in enumerate(degs):
        np.testing.assert_array_equal(got[k], np.asarray(Image.fromarray(img).rotate(deg)))


def test_config_loads_like_jax(tmp_path):
    from shoeprint_image_retrieval_tpu.config import _TPU_DEFAULTS as JDEF
    from shoeprint_image_retrieval_tpu.config import load_config as jload
    from shoeprint_image_retrieval_torch.config import _TPU_DEFAULTS as TDEF
    from shoeprint_image_retrieval_torch.config import check_supported, load_config as tload

    # the JAX test conftest turns prewarm off; every other default is the same
    assert {k: v for k, v in TDEF.items() if k != "prewarm"} == {
        k: v for k, v in JDEF.items() if k != "prewarm"}
    for path in ("run.toml", "benchmarks/synthetic_impress.toml"):
        want, got = jload(path), tload(path)
        want["tpu"].pop("prewarm")
        got["tpu"].pop("prewarm")
        assert got == want
    cfg = tload("run.toml")
    check_supported(cfg)
    for key, value in [("mesh_shape", 2), ("fusion_blocks", [6, 4]), ("pruned_scoring", True),
                       ("rank_on_device", True), ("precision", "bfloat16"),
                       ("cache_dtype", "bfloat16"), ("ncc_backend", "fft"),
                       ("clahe_host", False)]:
        bad = tload("run.toml")
        bad["tpu"][key] = value
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            check_supported(bad)
    bad = tload("run.toml")
    bad["tpu"]["ncc_backend"] = "nope"
    with pytest.raises(LookupError):
        check_supported(bad)


def test_metrics_equal():
    from shoeprint_image_retrieval_tpu import metrics as jm
    from shoeprint_image_retrieval_torch import metrics as tm

    rng = np.random.default_rng(3)
    scores = rng.normal(size=(7, 11)).astype(np.float32)
    scores[2, 4] = scores[2, 5]  # a tie
    pairs = rng.integers(0, 11, size=7)
    np.testing.assert_array_equal(tm.ranks_from_scores(scores, pairs),
                                  jm.ranks_from_scores(scores, pairs))
    ranks = tm.ranks_from_scores(scores, pairs).tolist()
    out_j, out_t = io.StringIO(), io.StringIO()
    with redirect_stdout(out_j):
        want = jm.cmp_all(ranks, 11, 9)
    with redirect_stdout(out_t):
        got = tm.cmp_all(ranks, 11, 9)
    assert got == want
    assert out_t.getvalue() == out_j.getvalue()


def _write_dataset(root, rng):
    (root / "Gallery").mkdir(parents=True)
    (root / "Query").mkdir()
    for gi in range(6):
        h, w = int(rng.integers(50, 90)), int(rng.integers(40, 80))
        Image.fromarray(rng.integers(0, 255, (h, w), dtype=np.uint8)).save(
            root / "Gallery" / f"{gi + 1}_1.png")
    for qi in range(5):
        h, w = int(rng.integers(20, 60)), int(rng.integers(20, 60))
        Image.fromarray(rng.integers(0, 255, (h, w), dtype=np.uint8)).save(
            root / "Query" / f"{qi % 6 + 1}_q{qi}.png")


def test_discovery_planner_loader_equal(tmp_path):
    from shoeprint_image_retrieval_tpu.data import discovery as jd, loader as jl, planner as jp
    from shoeprint_image_retrieval_torch.data import discovery as td, loader as tl, planner as tp

    _write_dataset(tmp_path, np.random.default_rng(4))
    jds, tds = jd.Dataset(tmp_path, "Impress"), td.Dataset(tmp_path, "Impress")
    assert tds.gallery_files == jds.gallery_files and tds.query_files == jds.query_files
    assert tds.matching_pairs(tds.query_files) == jds.matching_pairs(jds.query_files)
    q = tp.read_header_sizes(tds.query_dir, tds.query_files)
    g = tp.read_header_sizes(tds.gallery_dir, tds.gallery_files)
    assert q == jp.read_header_sizes(jds.query_dir, jds.query_files)
    kw = dict(minimum_dim=30, maximum_dim=70, start_block=6, end_block=3,
              skip_blocks=(5,), cluster_tolerance=0.05)
    want = jp.plan_clusters(q, jds.query_files, g, [0.05, 0.1], 3, jp.PlannerConfig(**kw))
    got = tp.plan_clusters(q, tds.query_files, g, [0.05, 0.1], 3, tp.PlannerConfig(**kw))
    assert [(p.files, p.scale, p.block) for p in got] == [
        (p.files, p.scale, p.block) for p in want]
    imgs_t = tl.load_images(tds.gallery_dir, tds.gallery_files, 0.7, [0.05, 0.1], 2)
    imgs_j = jl.load_images(jds.gallery_dir, jds.gallery_files, 0.7, [0.05, 0.1], 2)
    for a, b in zip(imgs_t, imgs_j):
        np.testing.assert_array_equal(a, b)
    bt, vt = tl.pack_canvas(imgs_t)
    bj, vj = jl.pack_canvas(imgs_j)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(vt, vj)


def test_host_clahe_and_normalize_equal():
    """The port's build of ``native/ingest.cc`` is bit-exact against cv2 (as
    the JAX package's host CLAHE is), and normalisation matches JAX."""
    import cv2
    import jax.numpy as jnp

    from shoeprint_image_retrieval_tpu.ops.preprocess import normalize_batch as jnorm
    from shoeprint_image_retrieval_torch.data import native_ingest as tni
    from shoeprint_image_retrieval_torch.ops.preprocess import normalize_batch as tnorm

    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 255, (int(rng.integers(16, 40)), int(rng.integers(16, 40))),
                         dtype=np.uint8) for _ in range(3)]
    got = tni.clahe_batch(imgs, 2.0, (8, 8), n_threads=2)
    for im, eq in zip(imgs, got):
        want = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(im)
        np.testing.assert_array_equal(eq, want)
    rgb = rng.integers(0, 256, size=(30, 26, 3), dtype=np.uint8)
    lab = cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)
    lab[..., 0] = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(4, 3)).apply(lab[..., 0])
    np.testing.assert_array_equal(tni.clahe_batch([rgb], 2.0, (4, 3), n_threads=1)[0],
                                  cv2.cvtColor(lab, cv2.COLOR_LAB2RGB))
    with pytest.raises(ValueError):
        tni.clahe_batch([np.zeros((5, 40), np.uint8)], 2.0, (8, 8))
    batch = np.zeros((3, 40, 40), np.uint8)
    valid = np.zeros((3, 2), np.int32)
    for i, im in enumerate(got):
        batch[i, : im.shape[0], : im.shape[1]] = im
        valid[i] = im.shape
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_allclose(
        tnorm(torch.from_numpy(batch), torch.from_numpy(valid), mean, std).numpy(),
        np.asarray(jnorm(jnp.asarray(batch), jnp.asarray(valid), mean, std)), atol=1e-6)


def test_gallery_cache_keys_differ_from_jax(tmp_path):
    """Both packages may share ``tpu.cache_dir``; seeded init differs between
    them, so their spill keys must never collide."""
    from shoeprint_image_retrieval_tpu.retrieval.gallery import GalleryFeatureCache as JCache
    from shoeprint_image_retrieval_torch.retrieval.gallery import GalleryFeatureCache as TCache

    files = ["1_1.png", "2_1.png"]
    params = ((0.05, 0.05), 2.0, (8, 8), "float32")
    tkey = TCache.key("EfficientNetV2_M", 6, 1.0, files, params=params)
    jkey = JCache.key("EfficientNetV2_M", 6, 1.0, files, params=params)
    assert tkey != jkey
    assert TCache.key("EfficientNetV2_M", 6, 1.0, files, params=params) == tkey
    cache = TCache(tmp_path)
    maps = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    cache.put(tkey, maps, np.asarray([[2, 2], [1, 2]], np.int32))
    again = TCache(tmp_path).get(tkey)
    np.testing.assert_array_equal(again[0], maps)
    assert JCache(tmp_path).get(jkey) is None


def test_seeded_init_is_deterministic():
    from shoeprint_image_retrieval_torch.models.weights import build_model

    a = build_model("EfficientNetV2_M", 2, None, "cpu").state_dict()
    b = build_model("EfficientNetV2_M", 2, None, "cpu").state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["features.0.0.weight"].abs().max()) <= 1 / np.sqrt(27)

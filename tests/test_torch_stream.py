"""The port's front end against itself and against the JAX Pipeline.

* the streamed extraction (ingest of chunk i+1 overlapping extraction of
  chunk i) gives the batched extraction's maps bit for bit;
* the port's Pipeline gives the JAX Pipeline's plans, ranks and S-lines,
  scores within 1e-5, with CLAHE on the host (streamed) or on the device,
  with and without the cluster lookahead, and on a dataset mixing gray and
  RGB images (JAX ``tests/test_pipeline.py``'s mixed set). With CLAHE on
  the device the scores are held against the JAX run with host CLAHE: the
  JAX package's jitted extraction step does not reproduce cv2's CLAHE on
  XLA:CPU (its CLAHE function run op by op does, as does the port's), so
  its own device-CLAHE scores move by ~1e-4; ranks and S-lines are held
  against its device-CLAHE run as well;
* ``close()`` (run by ``run()`` when its caller stops early) leaves no
  lookahead thread behind.

The tiny Impress fixture and seeded weights of ``tests/test_torch_pipeline.py``.
"""

import io
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from shoeprint_image_retrieval_tpu.config import load_config as jload
from shoeprint_image_retrieval_tpu.metrics import cmp_all as jcmp
from shoeprint_image_retrieval_tpu.retrieval.engine import Pipeline as JPipeline
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.data.loader import load_images
from shoeprint_image_retrieval_torch.metrics import cmp_all as tcmp
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline as TPipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import RUN_TOML, START_BLOCK, _make_dataset  # noqa: E402
from torch_effnet_replica import replica_v2m  # noqa: E402


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    model = replica_v2m(seed=0)
    model.features = model.features[:START_BLOCK]
    wdir = tmp_path_factory.mktemp("stream_weights")
    np.savez(wdir / "EfficientNetV2_M.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
    return wdir


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_data")
    _make_dataset(root, np.random.default_rng(11))
    return root


def _config(root, data, **tpu):
    cfg = root / ("run" + "".join(f"_{k}_{v}" for k, v in tpu.items()) + ".toml")
    cfg.write_text(RUN_TOML.format(dir=data, start=START_BLOCK)
                   + "".join(f"{k} = {str(v).lower()}\n" for k, v in tpu.items()))
    return cfg


def _s_lines(outs, n_g, n_q, cmp_all):
    buf = io.StringIO()
    with redirect_stdout(buf):
        for o in outs:
            cmp_all(o.ranks.tolist(), n_g, n_q)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX Pipeline's (pipeline, outputs, scores) per config file, run once."""
    runs = {}

    def get(cfg):
        if cfg not in runs:
            runs[cfg] = _jax_run(cfg, weights)
        return runs[cfg]

    return get


def _jax_run(cfg, wdir):
    jp = JPipeline(jload(cfg), weights_dir=str(wdir), verbose=False)
    scores = []
    orig = jp._cluster_scores

    def record(plan, next_plan=None):
        s, q_files = orig(plan, next_plan)
        scores.append(np.asarray(s))
        return s, q_files

    jp._cluster_scores = record
    return jp, list(jp.run()), scores


def test_streamed_maps_equal_batched(tmp_path, dataset, weights):
    """Three chunks of three prints, the last padded: streamed and batched
    extraction give the same maps bit for bit."""
    cfg = tload(_config(tmp_path, dataset))
    cfg["tpu"]["extraction_batch"] = 3
    pipe = TPipeline(cfg, weights_dir=str(weights), verbose=False, device="cpu")
    ds, crop = pipe.dataset, cfg["dataset"]["crop"]
    for plan in pipe.plans:
        model = pipe._model_for_block(plan.block)
        ms, vs = pipe._extract_streamed(model, ds.gallery_dir, ds.gallery_files, plan.scale,
                                        pipe._g_hdr)
        imgs = load_images(ds.gallery_dir, ds.gallery_files, plan.scale, crop, 2)
        mb, vb = pipe._extract(model, pipe._host_clahe(imgs))
        assert torch.equal(ms, mb)
        np.testing.assert_array_equal(vs, vb)
    assert set(pipe.ingest_tiers) <= {"native", "pil+native"}
    assert sum(pipe.ingest_tiers.values()) == 3 * len(pipe.plans)  # one call a chunk


@pytest.mark.parametrize("pipeline_clusters", [True, False])
@pytest.mark.parametrize("clahe_host", [True, False])
def test_port_matches_jax_front_end(dataset, weights, jax_runs, clahe_host, pipeline_clusters):
    cfg = _config(dataset, dataset, clahe_host=clahe_host,
                  pipeline_clusters=pipeline_clusters)
    jp, j_out, _ = jax_runs(cfg)
    # scores: the run whose CLAHE is cv2's (see the module docstring)
    _, _, j_scores = jax_runs(_config(dataset, dataset, clahe_host=True,
                                      pipeline_clusters=pipeline_clusters))
    tp = TPipeline(tload(cfg), weights_dir=str(weights), verbose=False, device="cpu")
    t_out = list(tp.run())

    assert [(p.files, p.scale, p.block) for p in tp.plans] == [
        (p.files, p.scale, p.block) for p in jp.plans]
    assert len(t_out) == len(j_out) == 2
    for t, j, js in zip(t_out, j_out, j_scores):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        np.testing.assert_allclose(t.scores, js, atol=1e-5, rtol=0)
    n_g, n_q = len(tp.dataset.gallery_files), len(tp.dataset.query_files)
    assert _s_lines(t_out, n_g, n_q, tcmp) == _s_lines(j_out, n_g, n_q, jcmp)

    # what ran: the CLAHE route, streaming (no ingest stage), the lookahead
    assert tp.clahe_routes == {("host" if clahe_host else "device"): 2}
    stages = set(tp.stage_seconds) | set(tp.lookahead_seconds)
    assert ("ingest" in stages) != clahe_host
    assert bool(tp.lookahead_seconds) == pipeline_clusters
    assert set(tp.ingest_tiers) <= {"native", "pil+native"} and tp.ingest_tiers


def _mixed_dataset(root):
    """JAX ``tests/test_pipeline.py``'s mixed set: odd gallery ids RGB, even
    gray, queries of both modes."""
    (root / "Gallery").mkdir(parents=True)
    (root / "Query").mkdir()
    rng = np.random.default_rng(23)
    gallery = {}
    for gi in range(6):
        h, w = int(rng.integers(70, 90)), int(rng.integers(60, 80))
        shape = (h, w, 3) if gi % 2 else (h, w)
        img = rng.integers(30, 220, size=shape, dtype=np.uint8)
        Image.fromarray(img).save(root / "Gallery" / f"{gi + 1}_1.png")
        gallery[gi + 1] = img
    for qi, gid in enumerate([1, 2, 3, 4]):
        crop = gallery[gid][5:55, 5:50].copy()
        noise = rng.integers(-10, 11, size=crop.shape)
        crop = np.clip(crop.astype(int) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(crop).save(root / "Query" / f"{gid}_q{qi}.png")


def test_mixed_gray_rgb_dataset(tmp_path, weights):
    _mixed_dataset(tmp_path / "mixed")
    ranks = {}
    for clahe_host in (True, False):  # host first: its JAX scores hold both
        cfg = _config(tmp_path, tmp_path / "mixed", clahe_host=clahe_host)
        _, j_out, scores = _jax_run(cfg, weights)
        j_scores = scores if clahe_host else j_scores
        tp = TPipeline(tload(cfg), weights_dir=str(weights), verbose=False, device="cpu")
        t_out = list(tp.run())
        assert len(t_out) == len(j_out) and sum(o.n_queries for o in t_out) == 4
        for t, j, js in zip(t_out, j_out, j_scores):
            np.testing.assert_array_equal(t.ranks, j.ranks)
            np.testing.assert_allclose(t.scores, js, atol=1e-5, rtol=0)
        assert set(tp.clahe_routes) == {"host" if clahe_host else "device"}
        ranks[clahe_host] = [o.ranks.tolist() for o in t_out]
    assert ranks[True] == ranks[False]


def test_close_leaves_no_lookahead(tmp_path, dataset, weights):
    """A caller that stops after the first cluster: the lookahead already
    preparing the second is waited for and its pool shut down."""
    pipe = TPipeline(tload(_config(tmp_path, dataset)), weights_dir=str(weights), verbose=False,
                     device="cpu")
    run = pipe.run()
    first = next(run)
    assert first.n_queries > 0 and pipe._lookahead is not None
    run.close()
    assert pipe._lookahead is None and pipe._la_pool is None
    assert not [t for t in threading.enumerate() if t.name.startswith("shoeprint-lookahead")]

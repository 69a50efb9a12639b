"""The whole slice: the port's Pipeline against the JAX Pipeline end to end.

A tiny Impress-layout dataset (shaped like ``tests/test_pipeline.py``'s) and
one seeded torchvision-layout EfficientNetV2_M checkpoint
(``tests/torch_effnet_replica.py``) in a tmp ``weights/``; both pipelines
read it. Per-query ranks and S-lines must be identical, scores within 1e-5.
The port runs on the CPU, where its scorer is the kernel's plain version.
"""

import io
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from shoeprint_image_retrieval_tpu.config import load_config as jload
from shoeprint_image_retrieval_tpu.metrics import cmp_all as jcmp, ranks_from_scores
from shoeprint_image_retrieval_tpu.retrieval.engine import Pipeline as JPipeline
from shoeprint_image_retrieval_torch.__main__ import main as torch_main
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline as TPipeline

sys.path.insert(0, str(Path(__file__).parent))
from torch_effnet_replica import replica_v2m  # noqa: E402

START_BLOCK = 3

RUN_TOML = """
[dataset]
dir = "{dir}"
type = "Impress"
crop = [0.05, 0.05]
n_processes = 2
n_clusters = 2
cluster_minimise_tolerance = 0.05

[model]
type = "EfficientNetV2_M"
clahe_clip_limit = 2.0
clahe_tile_grid_size = [8, 8]
start_block = {start}
end_block = 2
skip_blocks = []
minimum_dim = 40
maximum_dim = 200

[comparison]
n_processes = 2
rotations = [9, 180]
scales = [1.04]

[tpu]
extraction_batch = 4
probe_batch = 2
"""


def _make_dataset(root, rng, n_gallery=8, n_query=5):
    """Gallery prints plus noisy crops of their true matches, in two crop
    sizes: with ``minimum_dim = 40`` the planner scores the small crops at
    block 2 and the large ones at block 3, two clusters."""
    (root / "Gallery").mkdir(parents=True)
    (root / "Query").mkdir()
    prints = {}
    for gi in range(n_gallery):
        h, w = int(rng.integers(70, 90)), int(rng.integers(60, 80))
        img = rng.integers(30, 220, size=(h, w), dtype=np.uint8)
        Image.fromarray(img).save(root / "Gallery" / f"{gi + 1}_1.png")
        prints[gi + 1] = img
    for qi in range(n_query):
        gid = int(rng.integers(1, n_gallery + 1))
        crop = prints[gid][5:55, 5:50] if qi % 2 else prints[gid][3:40, 4:36]
        noise = rng.integers(-15, 16, size=crop.shape)
        crop = np.clip(crop.astype(int) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(crop).save(root / "Query" / f"{gid}_q{qi}.png")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    _make_dataset(root / "data", np.random.default_rng(11))
    model = replica_v2m(seed=0)
    model.features = model.features[:START_BLOCK]
    wdir = root / "weights"
    wdir.mkdir()
    np.savez(wdir / "EfficientNetV2_M.npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})
    cfg = root / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=root / "data", start=START_BLOCK))
    return cfg, wdir


def _s_lines(text):
    return re.findall(r"^S1:.*$", text, flags=re.M)


def test_port_matches_jax_pipeline(setup):
    cfg, wdir = setup
    jp = JPipeline(jload(cfg), weights_dir=str(wdir), verbose=False)
    j_scores = []
    orig = jp._cluster_scores

    def record(plan, next_plan=None):
        scores, q_files = orig(plan, next_plan)
        j_scores.append(np.asarray(scores))
        return scores, q_files

    jp._cluster_scores = record
    j_out = list(jp.run())
    tp = TPipeline(tload(cfg), weights_dir=str(wdir), verbose=False, device="cpu")
    t_out = list(tp.run())

    assert len(t_out) == len(j_out) == len(jp.plans) == 2
    assert [(p.files, p.scale, p.block) for p in tp.plans] == [
        (p.files, p.scale, p.block) for p in jp.plans]
    for t, j, js in zip(t_out, j_out, j_scores):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        assert t.matching_pairs == j.matching_pairs
        np.testing.assert_allclose(t.scores, js, atol=1e-5)
        np.testing.assert_array_equal(ranks_from_scores(js, j.matching_pairs), t.ranks)
    assert all(np.isfinite(t.scores).all() and (t.scores >= 0).all() for t in t_out)

    # the S-lines: the port's CLI against run.py's loop over the JAX outputs
    n_g, n_q = len(jp.dataset.gallery_files), len(jp.dataset.query_files)
    want = io.StringIO()
    with redirect_stdout(want):
        for j in j_out:
            jcmp(j.ranks.tolist(), n_g, n_q)
    got = io.StringIO()
    with redirect_stdout(got):
        torch_main([str(cfg), "--device", "cpu", "--weights-dir", str(wdir)])
    assert _s_lines(got.getvalue()) == _s_lines(want.getvalue())
    assert len(_s_lines(got.getvalue())) == 2


def test_cuda_device_without_card_raises(setup):
    """Asking for the card where there is none is an error, never a silent
    CPU run."""
    import torch

    cfg, wdir = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TPipeline(tload(cfg), weights_dir=str(wdir), verbose=False, device="cuda")

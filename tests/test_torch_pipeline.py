"""The whole slice: the port's Pipeline against the JAX Pipeline end to end.

A tiny Impress-layout dataset (shaped like ``tests/test_pipeline.py``'s) and
one seeded torchvision-layout EfficientNetV2_M checkpoint
(``tests/torch_effnet_replica.py``) in a tmp ``weights/``; both pipelines
read it. Per-query ranks and S-lines must be identical, scores within 1e-5.
The port runs on the CPU, where its scorer is the kernel's plain version.
The same holds for ``ncc_backend = "fft"`` (one gallery block and blocks of
3) and for VGG16 and DenseNet_201 replica checkpoints.
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
from shoeprint_image_retrieval_torch.metrics import cmp_all as tcmp
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline as TPipeline

sys.path.insert(0, str(Path(__file__).parent))
from torch_effnet_replica import replica_densenet201, replica_v2m, replica_vgg  # noqa: E402

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


def _make_dataset(root, rng, n_gallery=8, n_query=5, size=1.0):
    """Gallery prints plus noisy crops of their true matches, in two crop
    sizes: with ``minimum_dim = 40`` the planner scores the small crops at
    block 2 and the large ones at block 3, two clusters. ``size`` scales
    every image and crop."""
    (root / "Gallery").mkdir(parents=True)
    (root / "Query").mkdir()
    prints = {}
    for gi in range(n_gallery):
        h, w = int(int(rng.integers(70, 90)) * size), int(int(rng.integers(60, 80)) * size)
        img = rng.integers(30, 220, size=(h, w), dtype=np.uint8)
        Image.fromarray(img).save(root / "Gallery" / f"{gi + 1}_1.png")
        prints[gi + 1] = img
    for qi in range(n_query):
        gid = int(rng.integers(1, n_gallery + 1))
        big, small = (5, 55, 5, 50), (3, 40, 4, 36)
        y0, y1, x0, x1 = (int(v * size) for v in (big if qi % 2 else small))
        crop = prints[gid][y0:y1, x0:x1]
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


def _jax_run(cfg):
    """The JAX Pipeline, its outputs and each cluster's score matrix."""
    jp = JPipeline(jload(cfg), weights_dir=str(cfg.parent / "weights"), verbose=False)
    j_scores = []
    orig = jp._cluster_scores

    def record(plan, next_plan=None):
        scores, q_files = orig(plan, next_plan)
        j_scores.append(np.asarray(scores))
        return scores, q_files

    jp._cluster_scores = record
    return jp, list(jp.run()), j_scores


def _export(model, path, keep=None):
    """A replica's state dict as the export script writes it; ``keep``
    limits it to those ``features`` children."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if keep is None or k.split(".")[1] in keep}
    np.savez(path, **sd)


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


def _variant_case(root, case):
    """The config and weights of one case of
    :func:`test_port_matches_jax_pipeline_variants`: the FFT cases on the
    dataset of :func:`setup`, the model families on one at half the size
    (the JAX package's direct scorer on the CPU takes minutes at full size
    with VGG16's 64 full-resolution channels)."""
    wdir = root / "weights"
    wdir.mkdir()
    data, min_dim = root / "data", 40
    if case.startswith("fft"):
        model, start, end = "EfficientNetV2_M", START_BLOCK, 2
        replica = replica_v2m(seed=0)
        replica.features = replica.features[:START_BLOCK]
        _export(replica, wdir / f"{model}.npz")
        tpu = f'ncc_backend = "fft"\ngallery_block = {3 if case == "fft_blocks" else 0}\n'
        _make_dataset(data, np.random.default_rng(11))
    else:
        # the start / end blocks of tests/test_weight_parity.py:204-205
        model, start, end, tpu = case, 5, (3 if case == "VGG16" else 5), ""
        if case == "VGG16":
            replica = replica_vgg("VGG16")
            replica.features = replica.features[:start]
            _export(replica, wdir / f"{model}.npz")
        else:
            replica = replica_densenet201()
            names = [n for n, _ in replica.features.named_children()]
            _export(replica, wdir / f"{model}.npz", keep=set(names[:start]))
        _make_dataset(data, np.random.default_rng(12), n_gallery=7, n_query=4, size=0.5)
        min_dim = 20
    text = (RUN_TOML.format(dir=data, start=start)
            .replace('type = "EfficientNetV2_M"', f'type = "{model}"')
            .replace("end_block = 2", f"end_block = {end}")
            .replace("minimum_dim = 40", f"minimum_dim = {min_dim}"))
    cfg = root / "run.toml"
    cfg.write_text(text + tpu)
    return cfg


@pytest.mark.parametrize("case", ["fft_one_block", "fft_blocks", "VGG16", "DenseNet_201"])
def test_port_matches_jax_pipeline_variants(tmp_path, case):
    """The FFT backend with the whole gallery in one block and in blocks of 3
    (a padded tail), and the VGG16 and DenseNet_201 families on replica
    checkpoints: identical plans, ranks and S-lines, scores within 1e-5."""
    cfg = _variant_case(tmp_path, case)
    jp, j_out, j_scores = _jax_run(cfg)
    tp = TPipeline(tload(cfg), weights_dir=str(tmp_path / "weights"), verbose=False,
                   device="cpu")
    t_out = list(tp.run())
    assert len(t_out) == len(j_out) >= 1
    assert [(p.files, p.scale, p.block) for p in tp.plans] == [
        (p.files, p.scale, p.block) for p in jp.plans]
    for t, j, js in zip(t_out, j_out, j_scores):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        np.testing.assert_allclose(t.scores, js, atol=1e-5)
        assert np.isfinite(t.scores).all() and (t.scores >= 0).all()
    n_blocks = -(-len(tp.dataset.gallery_files) // 3) if case == "fft_blocks" else 1
    assert tp.gallery_blocks_scored == n_blocks * len(t_out)
    n_g, n_q = len(jp.dataset.gallery_files), len(jp.dataset.query_files)
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        for j in j_out:
            jcmp(j.ranks.tolist(), n_g, n_q)
    with redirect_stdout(got):
        for t in t_out:
            tcmp(t.ranks.tolist(), n_g, n_q)
    assert _s_lines(got.getvalue()) == _s_lines(want.getvalue()) != []

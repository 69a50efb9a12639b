"""Gallery blocking and on-device ranks: the port's Pipeline against the JAX one.

The tiny two-cluster Impress fixture of ``tests/test_torch_pipeline.py``.
Its features are extracted once (by the port, on the CPU) and handed to
both pipelines, so every (``gallery_block``, ``rank_on_device``) setting
compares the scoring, blocking and ranking of the two packages on identical
inputs: ranks identical, scores within 1e-5. The port must also score the
number of blocks the setting asks for, and its auto block must follow its
byte model for an injected free-memory figure.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_tpu.config import load_config as jload
from shoeprint_image_retrieval_tpu.retrieval.engine import DeviceScores as JDeviceScores
from shoeprint_image_retrieval_tpu.retrieval.engine import Pipeline as JPipeline
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.ops import ncc_kernel
from shoeprint_image_retrieval_torch.retrieval.engine import DeviceScores, Pipeline as TPipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import RUN_TOML, START_BLOCK, _make_dataset  # noqa: E402
from torch_effnet_replica import replica_v2m  # noqa: E402

N_GALLERY = 8


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(run.toml, weights dir, {plan index: features as numpy})."""
    root = tmp_path_factory.mktemp("torch_blocking")
    _make_dataset(root / "data", np.random.default_rng(11), n_gallery=N_GALLERY)
    model = replica_v2m(seed=0)
    model.features = model.features[:START_BLOCK]
    wdir = root / "weights"
    wdir.mkdir()
    np.savez(wdir / "EfficientNetV2_M.npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})
    cfg = root / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=root / "data", start=START_BLOCK)
                   + "pipeline_clusters = false\nprewarm = false\n")
    tp = TPipeline(tload(cfg), weights_dir=str(wdir), verbose=False, device="cpu")
    feats = {}
    for i, plan in enumerate(tp.plans):
        q_maps, q_valid, g_maps, g_valid, q_files = tp._cluster_features(plan)
        feats[i] = (q_maps.numpy(), np.asarray(q_valid), g_maps.numpy(), np.asarray(g_valid),
                    q_files)
    return cfg, wdir, feats


def _with_features(pipe, feats, as_torch: bool):
    """Serve the precomputed features to ``pipe`` in plan order."""
    index = {tuple(plan.files): i for i, plan in enumerate(pipe.plans)}

    def features(plan, next_plan=None):
        q_maps, q_valid, g_maps, g_valid, q_files = feats[index[tuple(plan.files)]]
        if as_torch:  # the port: probe maps as a tensor, gallery maps left on the host
            q_maps = torch.from_numpy(q_maps)
        return q_maps, q_valid, g_maps, g_valid, q_files

    pipe._cluster_features = features
    return pipe


def _configured(load, cfg, gallery_block, rank_on_device):
    config = load(cfg)
    config["tpu"]["gallery_block"] = gallery_block
    config["tpu"]["rank_on_device"] = rank_on_device
    return config


@pytest.mark.parametrize("rank_on_device", [False, True])
@pytest.mark.parametrize("gallery_block", [0, 2, 3])
def test_blocked_port_matches_jax(fixture, gallery_block, rank_on_device):
    cfg, wdir, feats = fixture
    jp = _with_features(JPipeline(_configured(jload, cfg, gallery_block, rank_on_device),
                                  weights_dir=str(wdir), verbose=False), feats, False)
    j_scores = []
    orig = jp._cluster_scores

    def record(plan, next_plan=None):
        scores, q_files = orig(plan, next_plan)
        j_scores.append(scores.materialize() if isinstance(scores, JDeviceScores)
                        else np.asarray(scores))
        return scores, q_files

    jp._cluster_scores = record
    j_out = list(jp.run())
    tp = _with_features(TPipeline(_configured(tload, cfg, gallery_block, rank_on_device),
                                  weights_dir=str(wdir), verbose=False, device="cpu"),
                        feats, True)
    t_out = list(tp.run())

    assert len(t_out) == len(j_out) == 2
    for t, j, js in zip(t_out, j_out, j_scores):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        assert isinstance(t.scores, DeviceScores) == rank_on_device
        scores = t.scores.materialize() if rank_on_device else t.scores
        np.testing.assert_allclose(scores, js, atol=1e-5, rtol=0)
    # the setting changes what runs: blocks of gallery_block prints (0 = one
    # block on the CPU), per cluster
    per_cluster = -(-N_GALLERY // gallery_block) if gallery_block else 1
    assert tp.gallery_blocks_scored == per_cluster * len(tp.plans)


def test_auto_block_from_injected_free_memory(fixture, monkeypatch):
    cfg, wdir, _ = fixture
    c, hraw, n_rows = 176, 46, 1400
    per = ncc_kernel.gallery_block_bytes_per_print(c, hraw, hraw, n_rows)
    hb = hraw - 4
    assert per == 4 * (c * hraw * hraw + 3 * c * hb * hb + 2 * c * (hb + 1) ** 2) + 8 * n_rows
    # the cache pads 5 channels to 8; the raw maps keep 5
    assert ncc_kernel.gallery_block_bytes_per_print(5, hraw, hraw, 0) == 4 * (
        5 * hraw * hraw + 3 * 8 * hb * hb + 2 * 8 * (hb + 1) ** 2)
    margin = ncc_kernel.AUTO_BLOCK_MARGIN_BYTES
    stack, kept = 10**9, 1  # resident: the kept stack and one batch's build temps
    free = 80 * 10**9
    want = (free - 2 * stack - margin) // per
    assert ncc_kernel.auto_gallery_block(10240, per, free, stack, kept) == want
    assert 1 < want < 10240  # an 80 GB card cannot hold this model's 10k gallery at once
    assert ncc_kernel.auto_gallery_block(100, per, free, stack, kept) == 100      # capped at G
    assert ncc_kernel.auto_gallery_block(10240, per, margin, stack, kept) == 1    # floor 1
    assert ncc_kernel.auto_gallery_block(10240, per, free, stack, 3) < want       # kept stacks
    assert ncc_kernel.auto_gallery_block(10240, per, 2 * free, stack, kept) > want  # monotone

    # the engine asks the card for its free bytes only on CUDA and for 0
    pipe = TPipeline(tload(cfg), weights_dir=str(wdir), verbose=False, device="cpu")
    assert pipe._gallery_block(10240, per, stack, kept) == 10240  # CPU: one block
    pipe.device = torch.device("cuda")
    cached = 10**9  # reserved by PyTorch's allocator but unallocated: free to reuse
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free - cached, 85 * 10**9))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 3 * cached)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 2 * cached)
    # the auto block evened out: two blocks of 5120 where 9413 would leave 827
    assert pipe._gallery_block(10240, per, stack, kept) == ncc_kernel.equal_blocks(10240, want)
    assert ncc_kernel.equal_blocks(10240, want) == 5120
    pipe.config["tpu"]["gallery_block"] = 2048
    assert pipe._gallery_block(10240, per, stack, kept) == 2048
    assert pipe._gallery_block(100, per, stack, kept) == 100

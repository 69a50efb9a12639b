"""Fusion scoring (``tpu.fusion_blocks``): the port's Pipeline against the JAX one.

``tests/test_torch_pipeline.py``'s fixture and checkpoint with
``fusion_blocks = [3, 2]``: each cluster scored at blocks 3 and 2 at its
planned scale, the two score matrices summed before ranking. Ranks and
S-lines must equal the JAX fusion run's and the summed scores be within
2e-5 of the JAX blocks' sum; the ranks must also equal the ranks of the sum
of the port's own per-block ``_cluster_scores`` (JAX
``test_fusion_blocks_scoring``). With ``rank_on_device`` the blocks' device
scores are pulled and summed the same way. Fusion starts no lookahead, so
none is thrown away. ``pruned_scoring`` with ``fusion_blocks`` is refused by
both packages.
"""

import io
import sys
from contextlib import redirect_stdout
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from shoeprint_image_retrieval_tpu.config import load_config as jload
from shoeprint_image_retrieval_tpu.metrics import cmp_all as jcmp
from shoeprint_image_retrieval_tpu.retrieval.engine import DeviceScores as JDeviceScores
from shoeprint_image_retrieval_tpu.retrieval.engine import Pipeline as JPipeline
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.metrics import cmp_all as tcmp, ranks_from_scores
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline as TPipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import _s_lines, setup  # noqa: E402,F401  (setup: the fixture)

FUSION = [3, 2]


def _fusion_config(cfg: Path, tmp_path: Path, extra: str = "") -> Path:
    out = tmp_path / "fusion.toml"
    out.write_text(cfg.read_text() + f"fusion_blocks = {FUSION}\n" + extra)
    return out


def _jax_fusion(cfg: Path, wdir: Path):
    """The JAX fusion run and, per cluster, the sum of its blocks' matrices."""
    jp = JPipeline(jload(cfg), weights_dir=str(wdir), verbose=False)
    per_block = []
    orig = jp._cluster_scores

    def record(plan, next_plan=None):
        scores, q_files = orig(plan, next_plan)
        per_block.append(scores.materialize() if isinstance(scores, JDeviceScores)
                         else np.asarray(scores))
        return scores, q_files

    jp._cluster_scores = record
    out = list(jp.run())
    n = len(FUSION)
    sums = [sum(per_block[i * n : (i + 1) * n]) for i in range(len(out))]
    return jp, out, sums


@pytest.mark.parametrize("rank_on_device", [False, True])
def test_fusion_port_matches_jax(setup, tmp_path, rank_on_device):
    cfg, wdir = setup
    fcfg = _fusion_config(cfg, tmp_path, f"rank_on_device = {str(rank_on_device).lower()}\n")
    jp, j_out, j_sums = _jax_fusion(fcfg, wdir)
    tp = TPipeline(tload(fcfg), weights_dir=str(wdir), verbose=False, device="cpu")
    t_out = list(tp.run())
    assert len(t_out) == len(j_out) == 2
    for t, j, js in zip(t_out, j_out, j_sums):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        assert isinstance(t.scores, np.ndarray)  # device scores pulled and summed
        np.testing.assert_allclose(t.scores, js, atol=2e-5, rtol=0)
        assert t.block == j.block  # the planned block is reported, as in JAX
    # every cluster scored once per fusion block, no lookahead started
    assert tp.gallery_blocks_scored == len(FUSION) * len(t_out)
    assert tp.lookahead_seconds == {} and tp._lookahead is None
    n_g, n_q = len(jp.dataset.gallery_files), len(jp.dataset.query_files)
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        for j in j_out:
            jcmp(j.ranks.tolist(), n_g, n_q)
    with redirect_stdout(got):
        for t in t_out:
            tcmp(t.ranks.tolist(), n_g, n_q)
    assert _s_lines(got.getvalue()) == _s_lines(want.getvalue()) != []

    # the fused ranks are the ranks of the sum of the per-block matrices
    control = TPipeline(tload(cfg), weights_dir=str(wdir), verbose=False, device="cpu")
    for out, plan in zip(t_out, control.plans):
        mats = [control._cluster_scores(replace(plan, block=fb)) for fb in FUSION]
        q_files = mats[0][1]
        want = ranks_from_scores(sum(m[0] for m in mats), control.dataset.matching_pairs(q_files))
        np.testing.assert_array_equal(out.ranks, want)
    control.close()


def test_pruned_with_fusion_is_refused_by_both(setup, tmp_path):
    cfg, wdir = setup
    both = _fusion_config(cfg, tmp_path, "pruned_scoring = true\n")
    with pytest.raises(ValueError, match="pruned_scoring"):
        TPipeline(tload(both), weights_dir=str(wdir), verbose=False, device="cpu")
    jp = JPipeline.__new__(JPipeline)  # the JAX engine refuses in run_cluster
    jp.config = jload(both)
    with pytest.raises(ValueError, match="pruned_scoring"):
        jp.run_cluster(plan=None)

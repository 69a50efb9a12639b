"""Pruned scoring: the port's ``retrieval/pruned.py`` against the JAX package's.

One NumPy score function drives both packages' ``pruned_ranks`` on the same
seeded inputs: ranks and every statistic must be equal, and the ranks must
equal ``ranks_from_scores`` on the full matrix (under exact ties,
``ops/topk.ranks_on_device``'s order). The cases are the JAX
package's (``tests/test_pruned.py``): real NCC scores from the NumPy oracle
on a random and a planted gallery, a prefix as deep as the channels, every
print pruned, exact ties, a bound that prunes most of the field; and the
same galleries handed to the port as tensors. Then the port's pruned
Pipeline against the JAX pruned Pipeline and the port's full Pipeline on
``tests/test_torch_pipeline.py``'s fixture: identical ranks.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import shoeprint_image_retrieval_tpu.retrieval.pruned as jpruned
import shoeprint_image_retrieval_torch.retrieval.pruned as tpruned
from shoeprint_image_retrieval_tpu.config import load_config as jload
from shoeprint_image_retrieval_tpu.metrics import ranks_from_scores
from shoeprint_image_retrieval_tpu.retrieval import oracle
from shoeprint_image_retrieval_tpu.retrieval.engine import Pipeline as JPipeline
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.ops.topk import ranks_on_device
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline as TPipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import setup  # noqa: E402,F401  (the fixture)


def _oracle_score_fn(qm, qv, gm, gv):
    """The reference's NCC on the host, whatever kind of maps it is given."""
    qm, gm = (np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m) for m in (qm, gm))
    return oracle.score_matrix(list(qm), list(gm), None, None, "reference")


def _tagged_maps(n, c):
    """(n, C, 4, 4) maps whose [i, 0, 0, 0] holds i, so a hand-written score
    matrix can be looked up by the rows and columns a call was given."""
    maps = np.zeros((n, c, 4, 4), np.float32)
    maps[:, 0, 0, 0] = np.arange(n, dtype=np.float32)
    return maps


def _table_score_fn(full, prefix, c):
    def fn(qm, qv, gm, gv):
        qi, gi = (np.asarray(m)[:, 0, 0, 0].astype(int) for m in (qm, gm))
        return (full if qm.shape[1] == c else prefix)[np.ix_(qi, gi)]
    return fn


def _oracle_case(name):
    rng = np.random.default_rng({"random": 0, "planted": 1, "deep_prefix": 2}[name])
    c = 8 if name != "deep_prefix" else 4
    if name == "random":
        g = rng.normal(size=(12, c, 10, 10)).astype(np.float32)
        q = rng.normal(size=(4, c, 8, 8)).astype(np.float32)
        pairs, k = [3, 7, 0, 11], 2
        qv, gv = np.full((4, 2), 8, np.int32), np.full((12, 2), 10, np.int32)
    elif name == "planted":
        g = rng.normal(size=(16, c, 12, 12)).astype(np.float32)
        pairs, k = [2, 9, 13], 4
        q = np.stack([g[p] for p in pairs])
        qv, gv = np.full((3, 2), 12, np.int32), np.full((16, 2), 12, np.int32)
    else:
        g = rng.normal(size=(6, c, 9, 9)).astype(np.float32)
        q = rng.normal(size=(2, c, 7, 7)).astype(np.float32)
        pairs, k = [5, 1], 99
        qv, gv = np.full((2, 2), 7, np.int32), np.full((6, 2), 9, np.int32)
    return _oracle_score_fn, q, qv, g, gv, pairs, k, 5e-3, None


def _table_case(name):
    """A hand-written score matrix (the channel order pinned to identity)."""
    c, k = 8, 2
    if name == "ties":
        full = np.array([[0.90, 0.50, 0.90, 0.90, 0.10],
                         [0.20, 0.60, 0.60, 0.95, 0.60]], np.float32)
        prefix = np.ones_like(full)  # the bound clears 1: nothing pruned
        pairs, margin = [0, 2], 1e-3
    elif name == "all_pruned":
        c, k = 4, 1
        full = np.full((2, 6), 0.1, np.float32)
        pairs, margin = [1, 4], 1e-4
        full[[0, 1], pairs] = 0.99
        prefix = np.full((2, 6), -3.0 * c, np.float32)  # the bound clears nothing
    else:  # "bound_prunes": true matches far above a tight bound
        c, k = 8, 4
        rng = np.random.default_rng(3)
        full = rng.uniform(0.0, 0.3, size=(6, 40)).astype(np.float32)
        pairs, margin = list(range(6)), 1e-3
        full[np.arange(6), pairs] = 0.95
        prefix = (((full + 0.1) * c - (c - k)) / k).astype(np.float32)
    q, g = _tagged_maps(full.shape[0], c), _tagged_maps(full.shape[1], c)
    qv, gv = np.full((len(q), 2), 4, np.int32), np.full((len(g), 2), 4, np.int32)
    return _table_score_fn(full, prefix, c), q, qv, g, gv, pairs, k, margin, full


@pytest.mark.parametrize("name,as_tensor", [
    ("random", False), ("planted", False), ("deep_prefix", False), ("ties", False),
    ("all_pruned", False), ("bound_prunes", False), ("random", True), ("planted", True)])
def test_pruned_ranks_match_jax(monkeypatch, name, as_tensor):
    if name in ("random", "planted", "deep_prefix"):
        fn, q, qv, g, gv, pairs, k, margin, full = _oracle_case(name)
    else:
        fn, q, qv, g, gv, pairs, k, margin, full = _table_case(name)
        for mod in (jpruned, tpruned):
            monkeypatch.setattr(mod, "channel_order",
                                lambda maps, sample=64: np.arange(maps.shape[1], dtype=np.int32))
    want, want_stats = jpruned.pruned_ranks(fn, q, qv, g, gv, pairs, k=k, margin=margin)
    tq, tg = (torch.from_numpy(q), torch.from_numpy(g)) if as_tensor else (q, g)
    got, got_stats = tpruned.pruned_ranks(fn, tq, qv, tg, gv, pairs, k=k, margin=margin)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got_stats == want_stats
    if full is None:
        full = fn(q, qv, g, gv)
    if name == "ties":
        # exact ties follow ops/topk.ranks_on_device (ties at larger gallery
        # indices count); numpy's argsort leaves their order unspecified
        want_ties = ranks_on_device(torch.from_numpy(full), torch.tensor(pairs)).numpy()
        assert got.tolist() == want_ties.tolist() == [3, 3]
    else:
        np.testing.assert_array_equal(got, ranks_from_scores(full, pairs))
    if name == "all_pruned":
        assert got.tolist() == [1, 1] and got_stats["survivors"] == 0
    if name in ("planted", "bound_prunes"):
        assert got_stats["prune_rate"] > 0.3 and got_stats["survivors"] < len(g)
    if name == "deep_prefix":
        assert got_stats["pair_frac"] == 1.0


@pytest.mark.parametrize("drift", [6e-8, -6e-8])
def test_pass2_ranks_against_its_own_true_pair_score(monkeypatch, drift):
    """A score function whose true-pair scores move by ``drift`` in pass 0's
    batch-diagonal calls (the kernel's tile plan follows the call): ties
    with the true match, at lower and higher gallery indices, and a print
    ``drift / 2`` above it still rank as on the full matrix, because pass 2
    counts against its own score of the true pair."""
    monkeypatch.setattr(tpruned, "channel_order",
                        lambda maps, sample=64: np.arange(maps.shape[1], dtype=np.int32))
    c, k = 8, 2
    full = np.full((2, 6), 0.3, np.float32)
    pairs = [2, 4]
    full[0, [0, 2, 5]] = 0.9  # true match 2 tied with prints 0 and 5
    full[1, 4] = 0.9
    full[1, 1] = np.float32(0.9) + np.float32(abs(drift) / 2)  # just above true match 4
    prefix = np.ones_like(full)  # nothing pruned
    table = _table_score_fn(full, prefix, c)

    def fn(qm, qv, gm, gv):
        s = table(qm, qv, gm, gv)
        return s + np.float32(drift) if len(gm) < full.shape[1] and qm.shape[1] == c else s

    q, g = _tagged_maps(2, c), _tagged_maps(6, c)
    qv, gv = np.full((2, 2), 4, np.int32), np.full((6, 2), 4, np.int32)
    got, stats = tpruned.pruned_ranks(fn, q, qv, g, gv, pairs, k=k, margin=1e-3, batch0=2)
    want = ranks_on_device(torch.from_numpy(full), torch.tensor(pairs)).numpy()
    assert got.tolist() == want.tolist() == [2, 2]
    assert stats["survivors"] == 6


def test_channel_order_matches_jax():
    rng = np.random.default_rng(4)
    g = rng.normal(size=(70, 6, 8, 8)).astype(np.float32)  # more than the 64-print sample
    g[:, 2] *= 10.0
    g[:, 5] *= 5.0
    want = jpruned.channel_order(g)
    for maps in (g, torch.from_numpy(g)):
        got = tpruned.channel_order(maps)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert want[:2].tolist() == [2, 5]


def test_pruned_pipeline_matches_jax_and_the_full_path(setup, tmp_path):
    """``pruned_scoring`` through both Pipelines (prefix k = 16 of the
    fixture's channels): the port's ranks equal the JAX pruned run's and the
    port's full run's; pruned mode returns no score matrix and records its
    statistics; the lookahead still prepares the next cluster."""
    cfg, wdir = setup
    extra = "pruned_scoring = true\nprune_channels = 16\n"
    pruned_cfg = tmp_path / "pruned.toml"
    pruned_cfg.write_text(cfg.read_text() + extra)
    jp = JPipeline(jload(pruned_cfg), weights_dir=str(wdir), verbose=False)
    j_out = list(jp.run())
    tp = TPipeline(tload(pruned_cfg), weights_dir=str(wdir), verbose=False, device="cpu")
    t_out = list(tp.run())
    full = list(TPipeline(tload(cfg), weights_dir=str(wdir), verbose=False, device="cpu").run())
    assert len(t_out) == len(j_out) == len(full) == 2
    for t, j, f in zip(t_out, j_out, full):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        np.testing.assert_array_equal(t.ranks, f.ranks)
        assert t.scores is None and t.matching_pairs == f.matching_pairs
    assert [s["k"] for s in tp.prune_stats] == [16, 16]
    assert all(0.0 <= s["prune_rate"] <= 1.0 and s["pair_frac"] > 0 for s in tp.prune_stats)
    assert "score-pruned" in tp.stage_seconds and tp.lookahead_seconds

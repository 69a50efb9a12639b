"""Sizing a scoring call for the card, and the benches that split one.

* ``ops/ncc_kernel.auto_probe_rows``: whole tiles, capped by the room it is
  given and by the card's row cap, at least one tile; ``probe_row_bytes``
  against a hand count.
* The engine's ``probe_batch = 0``: 56 on the CPU; on a card (free memory
  injected) the rows the model allows, solved in the JAX engine's order.
* ``equal_blocks`` against the JAX engine's balanced-block formula
  (``engine.py:1125-1133``, lane pack 1), 10,240 / 9,857 -> 5,120 included.
* Scores do not depend on the probe batch (7 against 56 probes a call).
* ``kernel_probe``, ``bench_build``, ``bench_cachebuild``, ``bench_fusion``,
  ``bench_pruned`` (both workloads, ``planted`` with ``--plain-check``),
  ``bench --host-maps`` and ``bench_autosize`` at their ``--quick`` sizes
  on the CPU, one JSON line each.
"""

import json

import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_torch import bench
from shoeprint_image_retrieval_torch.benchmarks import (
    bench_autosize, bench_build, bench_cachebuild, bench_fusion, bench_pruned, kernel_probe)
from shoeprint_image_retrieval_torch.metrics import ranks_from_scores
from shoeprint_image_retrieval_torch.ops import ncc_kernel
from shoeprint_image_retrieval_torch.retrieval.engine import (
    DEFAULT_PROBE_BATCH, variant_classes, variant_plan)

TILE = 64  # a tile of rows for the model; the kernel's own is read from its build


@pytest.mark.parametrize("row_bytes,room,tile,cap,want", [
    (1000, 10**12, TILE, 1408, 1408 // TILE * TILE),  # the card's cap binds
    (1000, 10**12, TILE, 1400, 1344),                 # a cap between tiles rounds down
    (10**6, 300 * 10**6, TILE, 1408, 256),            # room for 300 rows: 4 tiles
    (10**6, 10, TILE, 1408, TILE),                    # no room: still one tile
    (10**6, -5, TILE, 1408, TILE),                    # negative room: one tile
    (10**6, 300 * 10**6, 1, 1408, 300),               # the plain scorer: rows, not tiles
    (1000, 10**12, TILE, 10, TILE),                   # a cap under one tile: one tile
])
def test_auto_probe_rows(row_bytes, room, tile, cap, want):
    got = ncc_kernel.auto_probe_rows(row_bytes, room, tile, cap)
    assert got == want and got % tile == 0
    assert got <= max(cap, tile)


def test_probe_row_bytes_by_hand():
    c, feat, tmpl, kern, n_rot, n_scl, n_var, g = 4, (6, 5), (7, 6), (3, 2), 2, 1, 4, 10
    per_probe = 4 * c * 3 * (2 * 30 + 2 * 42)
    row = 4 * c * (2 * 6 + 4 * 42) + 8 * g
    want = row + -(-per_probe // n_var)
    assert ncc_kernel.probe_row_bytes(c, feat, tmpl, kern, n_rot, n_scl, n_var, g) == want
    plain = ncc_kernel.probe_row_bytes(c, feat, tmpl, kern, n_rot, n_scl, n_var, g, (9, 8))
    assert plain == want + 5 * 4 * g * 9 * 8


def _jax_equal_block(g_total, gb, gt=1):
    """The JAX engine's balanced auto block (engine.py:1125-1133)."""
    if gb >= g_total:
        return g_total
    n_blocks = -(-g_total // gb)
    return -(-(-(-g_total // n_blocks)) // gt) * gt


@pytest.mark.parametrize("g_total,gb", [
    (10240, 9857), (10240, 2048), (10240, 5120), (999, 237), (300, 237), (300, 300),
    (300, 1000), (7, 3), (1, 1), (10240, 1)])
def test_equal_blocks_match_jax(g_total, gb):
    got = ncc_kernel.equal_blocks(g_total, gb)
    assert got == _jax_equal_block(g_total, gb)
    assert -(-g_total // got) == -(-g_total // min(gb, g_total))  # as many blocks
    if (g_total, gb) == (10240, 9857):
        assert got == 5120


@pytest.fixture()
def pipe(tmp_path):
    """The bench's engine Pipeline on the CPU, ``probe_batch = 0``."""
    p = bench.engine_pipeline(tmp_path, 0, torch.device("cpu"))
    yield p
    p.close()


def _sizing_args(n_q, g):
    w = bench.make_workload(q=1)
    c, hraw, hc = w["gal"].shape[1], w["gal"].shape[-1], w["canvas"]
    plan = variant_plan(w["q_sizes"], (hc, hc), bench.ROTATIONS, bench.SCALES)
    n_var = sum(variant_classes("reference", plan.n_rot, plan.n_scl)[1])
    return (n_q, g, c, (hc, hc), (hraw, hraw), plan, n_var), plan, n_var, c, hraw


def test_probe_batch_zero_keeps_56_on_the_cpu(pipe):
    args, *_ = _sizing_args(1000, 300)
    assert pipe._probe_batch_and_block(*args, None) == (DEFAULT_PROBE_BATCH, 300)
    args, *_ = _sizing_args(20, 10240)
    assert pipe._probe_batch_and_block(*args, None) == (20, 10240)  # one block, <= Q probes


def test_probe_batch_zero_on_a_card_follows_the_model(pipe, monkeypatch):
    """Free memory injected: the engine's rows are the model's for the block
    it chose, whole tiles, under the row cap; a card with little room gets
    fewer rows and more blocks, all equal."""
    free = {"bytes": 80 * 10**9}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free["bytes"], 85 * 10**9))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    pipe.device = torch.device("cuda")
    args, plan, n_var, c, hraw = _sizing_args(1000, 300)
    pb, gb = pipe._probe_batch_and_block(*args, TILE)
    cap = ncc_kernel.H100_PROBE_ROWS // TILE * TILE // n_var  # the row cap binds
    assert gb == 300 and pb == ncc_kernel.equal_blocks(1000, cap) and pb * n_var <= cap * n_var
    assert -(-1000 // pb) == -(-1000 // cap)  # as many calls, the last one no shorter
    kernel_hw = (plan.template_canvas[0] - 4, plan.template_canvas[1] - 4)

    free["bytes"] = ncc_kernel.AUTO_BLOCK_MARGIN_BYTES + 3 * 10**9
    args, *_ = _sizing_args(1000, 10240)
    pb, gb = pipe._probe_batch_and_block(*args, TILE)
    row_bytes = ncc_kernel.probe_row_bytes(c, (36, 36), plan.template_canvas, kernel_hw,
                                           plan.n_rot, plan.n_scl, n_var, gb)
    room = (3 * 10**9 - gb * ncc_kernel.gallery_block_bytes_per_print(c, hraw, hraw, 0)
            - (int(6e9) if gb < 10240 else 0))
    assert pb == ncc_kernel.equal_blocks(
        1000, max(1, ncc_kernel.auto_probe_rows(row_bytes, room, TILE) // n_var))
    assert gb < 10240 and gb == ncc_kernel.equal_blocks(10240, gb)  # equal blocks


def test_scores_do_not_depend_on_the_probe_batch(tmp_path):
    w = bench.make_workload(quick=True, q=20)
    qmaps = torch.from_numpy(bench.draw_probe_maps(w))
    scores = {}
    for pb in (7, 56):
        root = tmp_path / str(pb)
        root.mkdir()
        p = bench.engine_pipeline(root, pb, torch.device("cpu"))
        scores[pb] = p._score_cluster(qmaps, w["q_sizes"], w["gal"], w["g_sizes"])
        assert p.probe_batches == [min(pb, 20)]
        p.close()
    np.testing.assert_allclose(scores[7], scores[56], atol=1e-6, rtol=0)
    pairs = np.argmax(scores[56], axis=1)
    np.testing.assert_array_equal(ranks_from_scores(scores[7], pairs),
                                  ranks_from_scores(scores[56], pairs))


@pytest.mark.parametrize("name,main,argv,metric", [
    ("kernel_probe", kernel_probe.main, [], "ncc_kernel_ms_per_probe"),
    ("bench_build", bench_build.main, [], "variant_build_ms"),
    ("bench_cachebuild", bench_cachebuild.main, [], "cache_build_ms"),
    ("bench_fusion", bench_fusion.main, [], "probes_per_sec_fusion_two_block"),
    ("bench_pruned_planted", bench_pruned.main, ["--workload", "planted", "--plain-check"],
     "probes_per_sec_pruned"),
    ("bench_pruned_random", bench_pruned.main, ["--workload", "random"], "probes_per_sec_pruned"),
    ("bench_host_maps", bench.main, ["--engine", "--host-maps"], "probes_per_sec_engine_path"),
    ("bench_autosize", bench_autosize.main, [], "auto_sizing_peak_bytes"),
])
def test_benches_quick_on_cpu(capsys, name, main, argv, metric):
    result = main(["--quick", "--device", "cpu", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(result))
    assert result["metric"] == metric and result["device"] == "cpu"
    if name == "kernel_probe":
        assert [p["probes"] for p in result["sweep"]] == list(kernel_probe.QUICK_PBS)
        assert all(p["ms"] > 0 and p["needed_flop"] > 0 and p["bound_ms"] > 0
                   for p in result["sweep"])
    if name.startswith("bench_pruned"):
        assert result["ranks_identical"] and result["t_vs_full_max_abs_diff"] == 0.0
        assert (result["prune_rate"] > 0.5) == (name.endswith("planted"))
        assert result["launches_full"] == result["launches_pruned"] == 0  # no kernel on the CPU
    if name == "bench_pruned_planted":
        check = result["plain_check"]
        assert check["ranks_identical"] and check["max_abs_diff"] == 0.0
        assert sorted(check["calls"]) == ["0", "1", "2"]
        assert [c["channels"] for c in check["calls"]["1"]] == [result["k"]]
    if name == "bench_autosize":  # the CPU keeps 56 probes a call (all 6 here) and one block
        assert result["probe_batch"] == 6 and result["blocks"] == 1 and result["model_bytes"] > 0
    if name == "bench_host_maps":
        assert result["maps"] == "host" and result["value"] > 0
    if name == "bench_fusion":
        assert result["value"] < min(result["block6_probes_per_sec"],
                                     result["block4_probes_per_sec"])
    if name == "bench_cachebuild":
        assert result["block"]["prints"] == 32 and result["bench"]["build_ms"] > 0

"""DenseNet-201 in the benchmark: its configuration run through the whole
harness on the CPU at a tiny size (the program against the float64 plain
reference of ``reference/nets/DenseNet_201.py``), and the reader of the
dense blocks' device spans."""

from __future__ import annotations

import json
import sys
import time
import tomllib
import types

import pytest

from retrieval_bench import harness, traffic
from retrieval_bench.harness import Run
from retrieval_bench.metrics import dense_blocks_ms_per_image
from retrieval_bench.reference import backbones

from .conftest import ROOT, tiny_cell

CONFIG = ROOT / "retrieval_bench" / "configs" / "densenet201-fid300.toml"


def tiny_densenet_config(path):
    """The cell's configuration cut to six ~100 x 90 px prints: block 6
    (through ``transition1``: the stem's padded max pool, ``denseblock1``'s
    six concatenations, the average pool), on two worker processes."""
    txt = CONFIG.read_text()
    for a, b in (("start_block = 8", "start_block = 6"), ("end_block = 6", "end_block = 5"),
                 ("skip_blocks = [7]", "skip_blocks = []"),
                 ("minimum_dim = 300", "minimum_dim = 40"),
                 ("maximum_dim = 800", "maximum_dim = 200"),
                 ("n_processes = 8", "n_processes = 2")):
        assert a in txt
        txt = txt.replace(a, b)
    path.write_text(txt)
    return path


def test_the_config_keeps_the_published_net_to_transition2():
    cfg = tomllib.loads(CONFIG.read_text())
    model = cfg["model"]
    assert (model["type"], model["start_block"], model["end_block"],
            model["skip_blocks"]) == ("DenseNet_201", 8, 6, [7])
    net = backbones.network("DenseNet_201", 8)
    assert backbones.channels(net) == 256
    # 18 dense layers (6 + 12) and two transitions
    dense = [op for op in net.table if op[0] == "dense"]
    assert len(dense) == 18 and [op[2] for op in dense][-1] == 128 + 11 * 32
    assert backbones.out_size(net, (641, 513)) == (40, 32)
    assert backbones.channels(backbones.network("DenseNet_201", 6)) == 128


def test_a_tiny_densenet_cell_is_correct_through_the_harness(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(traffic, "CACHE", tmp_path / "cache")
    cfg = tiny_densenet_config(tmp_path / "tiny.toml")
    cell = tiny_cell("cold", 1e-4)
    monkeypatch.setattr(harness, "cell_files", lambda name: (cell, cfg))
    args = types.SimpleNamespace(workload="dn201-cold-b16", seed=2**31 + 21, seconds=0.2,
                                 trace=0, control=0, device="cpu", workers=2)
    assert harness.run_cell(args, time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sys.stdout.flush()
    assert line["correct"], line["checks"]
    assert line["checks"]["plan"]["value"] == 0
    stages = line["run"]["stages"]
    # one span per kept child in each extraction stage, within the stage
    children = ("conv0", "norm0", "relu0", "pool0", "denseblock1", "transition1")
    for stage in ("extract-query", "extract-gallery"):
        keys = {k for k in stages if k.startswith(f"{stage}.net.")}
        assert keys == {f"{stage}.net.{c}" for c in children}
        assert sum(stages[k] for k in keys) <= stages[stage]


def run_of(stages, images):
    return Run(setup_s=1.0, window_s=20.0, batch_seconds=[5.0] * 4, marks=64,
               stage_delta=dict(stages), images_extracted=images, backbone_flop=0.0,
               ncc_flop=0.0, ncc_bound_s=0.0)


def test_dense_blocks_reader_sums_every_stages_dense_blocks_per_image():
    stages = {"extract-query": 0.5, "extract-query.net.denseblock1": 0.05,
              "extract-query.net.denseblock2": 0.07, "extract-query.net.transition1": 0.01,
              "extract-gallery": 9.0, "extract-gallery.net.denseblock1": 2.0,
              "extract-gallery.net.denseblock2": 3.5, "extract-gallery.net.conv0": 0.4}
    got = dense_blocks_ms_per_image.read(run_of(stages, 2 * 1191))
    assert got == pytest.approx(1e3 * (0.05 + 0.07 + 2.0 + 3.5) / (2 * 1191))


@pytest.mark.parametrize("stages,images", [
    ({"extract-gallery": 9.0, "extract-gallery.ingest-wait": 1.0}, 1191),   # no device spans
    ({"extract-gallery": 9.0, "extract-gallery.net.3": 2.0}, 1191),          # another backbone
    ({"extract-gallery.net.denseblock1": 2.0}, 0),                          # nothing extracted
])
def test_dense_blocks_reader_is_none_without_dense_blocks(stages, images):
    assert dense_blocks_ms_per_image.read(run_of(stages, images)) is None

"""A tiny cell the CPU tests run through the whole harness: six prints of
~100 x 90 px, four marks, EfficientNetV2-M to block 3 (C = 48) on the CPU,
the port's plain scorer, the float64 reference."""

from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path

import pytest

from retrieval_bench import harness, traffic

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(mode: str = "standing", score_gap: float = 1e-4) -> dict:
    return {"config": "tiny", "chips": 1, "mode": mode, "why": "tiny",
            "traffic": {"name": "tiny", "gallery": 6, "print_h": [96, 112],
                        "print_w": [80, 96], "marks": 4, "mark_share": [0.75, 0.9],
                        "layout_seed": 3, "batch": 2, "warm_batches": 1},
            "check": {"marks": 3, "prints": 4, "top": 1, "score_gap": score_gap}}


def tiny_config(path: Path) -> Path:
    txt = (ROOT / "retrieval_bench" / "configs" / "effnetv2m-fid300.toml").read_text()
    for a, b in (("start_block = 6", "start_block = 3"), ("end_block = 4", "end_block = 2"),
                 ("skip_blocks = [5]", "skip_blocks = []"),
                 ("minimum_dim = 300", "minimum_dim = 40"),
                 ("maximum_dim = 800", "maximum_dim = 200"),
                 ("n_processes = 8", "n_processes = 2")):
        assert a in txt
        txt = txt.replace(a, b)
    path.write_text(txt)
    return path


@pytest.fixture
def run_tiny(tmp_path, monkeypatch, capsys):
    """Run the tiny cell once -> (exit code, the result line or None)."""
    monkeypatch.setattr(traffic, "CACHE", tmp_path / "cache")
    cfg = tiny_config(tmp_path / "tiny.toml")

    def go(mode="standing", device="cpu", control=0, seconds=0.2, trace=0, seed=2**31 + 11,
           workload="v2m-cold-b16", score_gap=1e-4):
        cell = tiny_cell(mode, score_gap)
        monkeypatch.setattr(harness, "cell_files", lambda name: (cell, cfg))
        args = types.SimpleNamespace(workload=workload, seed=seed, seconds=seconds, trace=trace,
                                     control=control, device=device, workers=2)
        rc = harness.run_cell(args, time.perf_counter())
        out = capsys.readouterr().out.strip().splitlines()
        sys.stdout.flush()
        return rc, (json.loads(out[-1]) if rc == 0 and out else None)

    return go

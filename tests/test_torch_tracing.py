"""Profiler traces: the port's ``profile_trace`` and ``chip_smoke``'s reading of them.

On the CPU ``tpu.profile_dir`` must give one Chrome trace per cluster with
the pipeline's stage ranges in it; ``chip_smoke.trace_summary`` must read
the device's busy and idle share, its top ops and its idle gaps from a small
hand-written trace.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from shoeprint_image_retrieval_torch.config import load_config
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline
from shoeprint_image_retrieval_torch.utils.tracing import profile_trace

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import RUN_TOML, START_BLOCK, _make_dataset  # noqa: E402


def test_profile_dir_writes_one_trace_per_cluster(tmp_path):
    _make_dataset(tmp_path / "data", np.random.default_rng(11))
    cfg = tmp_path / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=tmp_path / "data", start=START_BLOCK)
                   + f'profile_dir = "{tmp_path / "traces"}"\n')
    pipe = Pipeline(load_config(cfg), weights_dir=None, verbose=False, device="cpu")
    outs = list(pipe.run())
    traces = sorted((tmp_path / "traces").glob("*.json"))
    assert [t.name for t in traces] == [f"cluster{i}.json" for i in range(len(outs))] and outs
    for i, t in enumerate(traces):
        doc = json.loads(t.read_text())
        names = {e.get("name") for e in doc["traceEvents"]}
        # the stage ranges (the second cluster's features are made by the
        # lookahead, mostly inside the first cluster's trace)
        assert {"score", "cache"} <= names and (i > 0 or "extract-query" in names)
        summary = chip_smoke.trace_summary(doc["traceEvents"])
        assert summary["device_events"] == 0 and summary["idle_share"] == 1.0  # the CPU


def test_profile_trace_is_a_no_op_without_a_dir(tmp_path):
    with profile_trace("", "x") as prof:
        assert prof is None
    with profile_trace(None, "x") as prof:
        assert prof is None
    assert not list(tmp_path.iterdir())


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_summary_reads_a_hand_written_trace():
    """Host: ``score`` over [0, 100] us, ``aten::conv`` over [10, 40].
    Device: k1 [0, 10], k2 [20, 30], k1 [50, 60], a copy [55, 62]. Busy:
    [0, 10] + [20, 30] + [50, 62] = 32 of 100. Gaps: [62, 100] (38, only
    ``score`` spans it), [30, 50] (20: ``score``; ``aten::conv`` ends at 40)
    and [10, 20] (10: ``aten::conv`` is the innermost op spanning it)."""
    events = [
        _x("score", "user_annotation", 0, 100), _x("aten::conv", "cpu_op", 10, 30),
        _x("k1", "kernel", 0, 10), _x("k2", "kernel", 20, 10), _x("k1", "kernel", 50, 10),
        _x("Memcpy HtoD", "gpu_memcpy", 55, 7),
        {"ph": "i", "name": "marker", "ts": 5},  # not a timed event
    ]
    s = chip_smoke.trace_summary(events, top=2, gaps=3)
    assert s["window_ms"] == pytest.approx(0.1) and s["busy_ms"] == pytest.approx(0.032)
    assert s["busy_share"] == pytest.approx(0.32) and s["idle_share"] == pytest.approx(0.68)
    assert s["device_events"] == 4
    assert [(o["name"], o["calls"]) for o in s["top_ops"]] == [("k1", 2), ("k2", 1)]
    assert s["top_ops"][0]["ms"] == pytest.approx(0.02)
    assert s["top_ops"][0]["share_of_busy"] == pytest.approx(20 / 32)
    assert [(g["at_ms"], g["ms"], g["host_op"]) for g in s["idle_gaps"]] == [
        (pytest.approx(0.062), pytest.approx(0.038), "score"),
        (pytest.approx(0.03), pytest.approx(0.02), "score"),
        (pytest.approx(0.01), pytest.approx(0.01), "aten::conv"),
    ]
    with pytest.raises(ValueError):
        chip_smoke.trace_summary([{"ph": "i", "name": "x", "ts": 0}])


def test_trace_summary_names_a_gap_on_the_launching_thread():
    """Two threads over one gap [10, 50]: the scorer (tid 1) in ``cache``
    [0, 60] with ``cache.gather`` [5, 50]; a lookahead (tid 2) in
    ``extract-gallery`` [8, 52], shorter than either. The kernel after the
    gap was launched from tid 1, so the gap is ``cache.gather``; the gap at
    the window's end [60, 70], after a copy launched from tid 2, is that
    thread's ``aten::copy_`` [55, 70]. Without the launches' correlation
    every thread counts, and ``extract-gallery`` names the first gap."""
    def x(name, cat, ts, dur, tid, corr=None):
        e = {**_x(name, cat, ts, dur), "pid": 1, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("cache", "user_annotation", 0, 60, 1), x("cache.gather", "user_annotation", 5, 45, 1),
        x("extract-gallery", "user_annotation", 8, 44, 2), x("aten::copy_", "cpu_op", 55, 15, 2),
        x("cudaLaunchKernel", "cuda_runtime", 2, 1, 1, 7),
        x("cudaLaunchKernel", "cuda_runtime", 49, 1, 1, 8),
        x("cudaMemcpyAsync", "cuda_runtime", 54, 1, 2, 9),
        {**x("k1", "kernel", 3, 7, 0, 7), "pid": 0},
        {**x("k2", "kernel", 50, 5, 0, 8), "pid": 0},
        {**x("Memcpy HtoD", "gpu_memcpy", 55, 5, 0, 9), "pid": 0},
    ]
    s = chip_smoke.trace_summary(events, gaps=3)
    assert [(g["at_ms"], g["ms"], g["host_op"]) for g in s["idle_gaps"]] == [
        (pytest.approx(0.01), pytest.approx(0.04), "cache.gather"),
        (pytest.approx(0.06), pytest.approx(0.01), "aten::copy_"),
        (pytest.approx(0.0), pytest.approx(0.003), "cache"),
    ]
    for e in events:
        e.pop("args", None)
    s = chip_smoke.trace_summary(events, gaps=1)
    assert s["idle_gaps"][0]["host_op"] == "extract-gallery"

"""Child spans inside the stage timers (``utils/tracing.span``) and the
pipeline's spans: ``cache.gather`` / ``cache.copy`` in the ``cache`` stage,
``<stage>.ingest-wait`` in the streamed extraction, the calling thread's
``lookahead-wait``, and the profiler traces that hold every thread's ranges.

All on the CPU: the synchronise count is read through a stand-in for
``torch.cuda.synchronize``.
"""

import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_torch.config import load_config
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline
from shoeprint_image_retrieval_torch.utils import tracing
from shoeprint_image_retrieval_torch.utils.tracing import span, stage_timer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import RUN_TOML, START_BLOCK, _make_dataset  # noqa: E402

CACHE_PARTS = ("cache.gather", "cache.copy")


def test_child_span_records_dotted_name_into_its_stage_sink():
    sink = {}
    with stage_timer("cache", verbose=False, sink=sink):
        with span("gather"):
            pass
        with span("gather"):
            pass
    assert set(sink) == {"cache", "cache.gather"}
    assert 0.0 <= sink["cache.gather"] <= sink["cache"]


def test_span_outside_any_stage_is_the_range_alone():
    """No stage open: the range under its bare name, no sink written and
    no stage left open."""
    from torch.profiler import profile

    with profile() as prof:
        with span("gather"):
            pass
    assert "gather" in {e.name for e in prof.events()}
    assert tracing._open.stages == []


def test_span_takes_the_innermost_open_stage():
    outer, inner = {}, {}
    with stage_timer("score-pruned", verbose=False, sink=outer):
        with stage_timer("cache", verbose=False, sink=inner):
            with span("copy"):
                pass
        with span("copy"):
            pass
    assert set(inner) == {"cache", "cache.copy"}
    assert set(outer) == {"score-pruned", "score-pruned.copy"}


def test_threads_never_mix_sinks():
    """More threads than cores, each holding its own stage open while the
    others open theirs (a barrier inside the stage), the interpreter
    switching threads often: a stack shared between threads would give one
    thread's span another's stage, and its sink another's key."""
    n, rounds = 4 * (os.cpu_count() or 1), 20
    sinks = {f"s{i}": {} for i in range(n)}
    barrier = threading.Barrier(n, timeout=30)
    done = []

    def work(name):
        for _ in range(rounds):
            with stage_timer(name, verbose=False, sink=sinks[name]):
                barrier.wait()
                with span("wait"):
                    barrier.wait()
        done.append(name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(name,)) for name in sinks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and sorted(done) == sorted(sinks)
    for name, sink in sinks.items():
        assert set(sink) == {name, f"{name}.wait"}
    assert tracing._open.stages == []


def test_child_spans_never_synchronise(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    sink = {}
    dev = torch.device("cuda")
    with stage_timer("cache", verbose=False, sink=sink, device=dev):
        for part in ("gather", "copy", "gather"):
            with span(part):
                pass
    assert calls == [dev]
    assert set(sink) == {"cache", *CACHE_PARTS}


def test_a_child_span_does_not_print(capsys):
    with stage_timer("cache", verbose=True, sink={}):
        with span("gather"):
            pass
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("[cache] ")


def _pipeline(tmp_path, extra=""):
    _make_dataset(tmp_path / "data", np.random.default_rng(11))
    cfg = tmp_path / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=tmp_path / "data", start=START_BLOCK)
                   + "gallery_block = 3\n" + extra)
    return Pipeline(load_config(cfg), weights_dir=None, verbose=False, device="cpu")


def test_pipeline_records_cache_parts_and_the_lookahead_wait(tmp_path, monkeypatch):
    """Maps at rest on the host (budget 0): every gallery block is gathered
    on the host and copied; cluster 1's features come from the lookahead,
    which cluster 1's call waits for."""
    monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", "0")
    pipe = _pipeline(tmp_path)
    outs = list(pipe.run())
    assert len(outs) == 2 and pipe.gallery_blocks_scored > 2
    st = pipe.stage_seconds
    assert {"cache", *CACHE_PARTS, "lookahead-wait"} <= set(st)
    assert all(st[k] >= 0.0 for k in (*CACHE_PARTS, "lookahead-wait"))
    assert st["cache.gather"] + st["cache.copy"] <= st["cache"]
    # the streamed extraction's wait: cluster 0 on this thread, cluster 1
    # on the lookahead thread, each in its own thread's sink
    for sink in (st, pipe.lookahead_seconds):
        waits = [k for k in sink if k.endswith(".ingest-wait")]
        assert waits and all(sink[k] <= sink[k.split(".")[0]] for k in waits)
    assert not any(k.startswith("cache") or k == "lookahead-wait"
                   for k in pipe.lookahead_seconds)


def test_fusion_has_no_lookahead_wait(tmp_path, monkeypatch):
    monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", "0")
    pipe = _pipeline(tmp_path, f"fusion_blocks = [{START_BLOCK}, 2]\n")
    assert len(list(pipe.run())) == 2
    assert "lookahead-wait" not in pipe.stage_seconds and not pipe.lookahead_seconds
    assert set(CACHE_PARTS) <= set(pipe.stage_seconds)


def _ranges(events, name):
    return [e for e in events if e.get("ph") == "X" and e.get("name") == name]


def test_profile_dir_trace_holds_every_threads_ranges(tmp_path, monkeypatch):
    """Cluster 0's trace: the lookahead thread's stages on a ``tid`` of
    their own (the scorer waits for the lookahead first, so its ranges close
    inside the trace); each ``cache.*`` range inside a ``cache`` range on
    the same ``tid``, their durations summing to the sink's seconds."""
    monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", "0")
    pipe = _pipeline(tmp_path, f'profile_dir = "{tmp_path / "traces"}"\n')
    score = pipe._score_cluster

    def after_the_lookahead(*args):
        if pipe._lookahead is not None:
            pipe._lookahead[1].result()
        return score(*args)

    pipe._score_cluster = after_the_lookahead
    runs = pipe.run()
    next(runs)
    seconds = {k: pipe.stage_seconds[k] for k in CACHE_PARTS}
    list(runs)
    events = json.loads((tmp_path / "traces" / "cluster0.json").read_text())["traceEvents"]
    caches = _ranges(events, "cache")
    assert caches
    home = {e["tid"] for e in caches}
    assert len(home) == 1
    assert any(e["tid"] not in home for e in _ranges(events, "extract-gallery"))
    for part in CACHE_PARTS:
        ranges = _ranges(events, part)
        assert ranges
        for r in ranges:
            assert any(c["tid"] == r["tid"] and c["ts"] <= r["ts"]
                       and r["ts"] + r["dur"] <= c["ts"] + c["dur"] for c in caches)
        assert sum(r["dur"] for r in ranges) / 1e6 == pytest.approx(seconds[part], abs=1e-3)

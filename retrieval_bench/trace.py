"""What a ``torch.profiler`` trace says of the device over a window.

:func:`trace_summary` is a frozen copy of ``chip_smoke.trace_summary``: the
device's busy and idle share (the union of kernel, copy and set intervals
against the window), the device ops with the most total time, and the
longest idle gaps, each named by the innermost host op that spans it (else
the host op that overlaps it most). :func:`record` runs a block under the
profiler and returns the summary with the raw device events that the
per-layer readers take kernel times from.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


def _merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def trace_summary(events: list[dict], top: int = 10, gaps: int = 10) -> dict:
    """Busy / idle share, top device ops and longest idle gaps (ms) of a
    Chrome trace's ``traceEvents`` over the trace's window (first to last
    timed event)."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not timed:
        raise ValueError("the trace holds no timed events")
    span = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in timed]
    w0, w1 = min(s for s, _ in span), max(e for _, e in span)
    dev = [e for e in timed if e.get("cat") in DEVICE_CATS]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
            for e in timed if e.get("cat") in HOST_CATS]
    busy = _merged((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy_us = sum(hi - lo for lo, hi in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)

    def spanning(lo: float, hi: float) -> str | None:
        inside = [h for h in host if h[0] <= lo and h[1] >= hi]
        if inside:
            return min(inside, key=lambda h: h[1] - h[0])[2]
        overlap = [(min(h[1], hi) - max(h[0], lo), h[2]) for h in host]
        overlap = [o for o in overlap if o[0] > 0]
        return max(overlap)[1] if overlap else None

    per_op: dict[str, list] = {}
    for e in dev:
        acc = per_op.setdefault(e.get("name", "")[:120], [0.0, 0])
        acc[0] += float(e["dur"])
        acc[1] += 1
    window = w1 - w0
    return {
        "window_ms": window / 1e3, "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / window if window else 0.0,
        "idle_share": 1.0 - busy_us / window if window else 1.0,
        "device_events": len(dev),
        "top_ops": [{"name": n, "ms": t / 1e3, "calls": c, "share_of_busy": t / busy_us}
                    for n, (t, c) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]],
        "idle_gaps": [{"at_ms": (lo - w0) / 1e3, "ms": d / 1e3, "host_op": spanning(lo, hi)}
                      for d, lo, hi in idle[:gaps]],
    }


@contextlib.contextmanager
def record(enabled: bool, device: torch.device):
    """Profile the block (host and CUDA activity) when ``enabled``. Yields a
    dict that holds, after the block, ``summary`` (:func:`trace_summary`)
    and ``device_events`` (name, ms) of every device event."""
    out: dict = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    with profile(activities=activities) as prof:
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.unlink(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out["summary"] = trace_summary(events)
    out["device_events"] = [(e.get("name", ""), float(e["dur"]) / 1e3) for e in events
                            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]

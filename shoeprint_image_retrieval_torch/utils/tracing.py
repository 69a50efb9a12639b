"""Stage wall-clock timers, the spans inside them, device timing and
profiler traces.

Device work is asynchronous, so a timer given a CUDA device synchronises it
when its stage ends: the time it records is the stage's own, not the time
to enqueue it. Each stage is also a ``torch.profiler`` range of its name, so
a trace (:func:`profile_trace`) shows where one stage ends and the next
begins.

A :func:`span` marks one step of a stage. Opened inside a stage, on the
same thread, it records into that stage's sink under the dotted name
``<stage>.<part>`` (``cache.gather``); outside any stage it is the range
alone. Stages are kept per thread, so a span on a worker thread never
reaches another thread's sink. A span adds no device synchronise: on a card
its seconds are the host's time in the step, and only the enclosing
stage's closing synchronise holds the device work. A stage's self time is
its seconds minus its children's. Spans are ranges of their names too, and
never print.

A :func:`profile_trace` records every thread's ranges and ops, each on its
own ``tid``: the lookahead thread's stages and the stream worker's ops lie
beside the calling thread's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import torch


class _Open(threading.local):
    """The stages open on this thread, innermost last: (name, sink)."""

    def __init__(self):
        self.stages: list[tuple[str, dict | None]] = []


_open = _Open()


@contextlib.contextmanager
def stage_timer(name: str, verbose: bool = True, sink: dict | None = None,
                device: torch.device | None = None):
    stages = _open.stages
    stages.append((name, sink))
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        dt = time.perf_counter() - t0
        stages.pop()
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        if verbose:
            print(f"[{name}] {dt:.2f}s")


@contextlib.contextmanager
def span(part: str):
    """Time the block as a child of the stage open on this thread, into its
    sink as ``<stage>.<part>``; outside any stage, the range ``part`` alone."""
    stages = _open.stages
    if not stages:
        with torch.profiler.record_function(part):
            yield
        return
    parent, sink = stages[-1]
    name = f"{parent}.{part}"
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: str | Path | None, name: str = "trace",
                  device: torch.device | None = None):
    """A ``torch.profiler`` trace of the block, written as the Chrome trace
    ``{log_dir}/{name}.json``; host and CUDA activity on a card, host only
    on the CPU, every thread's ranges and ops in it. A no-op when
    ``log_dir`` is empty (the JAX package's ``profile_trace`` over
    ``jax.profiler``)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    cuda = device is not None and device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=every_thread) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out / f"{name}.json"))


def device_ms(fn, reps: int, device: torch.device, warm: bool = True) -> float:
    """Mean time of ``fn`` over ``reps`` calls, after one warm-up call where
    ``warm``: CUDA events on the card, the host clock on the CPU."""
    if warm:
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps

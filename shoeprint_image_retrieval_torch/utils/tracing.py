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

A :func:`device_span` is a span whose seconds are the device's: inside a
stage that synchronises a card, over work on that card, it records a CUDA
event pair on the card's current stream, and the stage adds the seconds
between them to its sink after its own closing synchronise. It adds no
synchronise either. Anywhere else (the CPU, no stage, a stage that does not
synchronise, work on another card) it is a :func:`span`.

A :func:`profile_trace` records every thread's ranges and ops, each on its
own ``tid``: the lookahead thread's stages and the stream worker's ops lie
beside the calling thread's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@dataclass
class _Stage:
    """One open stage: its name, its sink and, where it synchronises a card
    (and has a sink), that card and its device spans' event pairs (key,
    start, end), read after the synchronise."""

    name: str
    sink: dict | None
    synced: torch.device | None = None
    events: list = field(default_factory=list)


class _Open(threading.local):
    """The stages open on this thread, innermost last."""

    def __init__(self):
        self.stages: list[_Stage] = []


_open = _Open()


def _card(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


@contextlib.contextmanager
def stage_timer(name: str, verbose: bool = True, sink: dict | None = None,
                device: torch.device | None = None):
    stages = _open.stages
    cuda = device is not None and device.type == "cuda"
    stage = _Stage(name, sink, device if cuda and sink is not None else None)
    stages.append(stage)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
            if cuda:
                torch.cuda.synchronize(device)
                for key, start, end in stage.events:
                    sink[key] = sink.get(key, 0.0) + start.elapsed_time(end) / 1e3
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
    stage = stages[-1]
    name = f"{stage.name}.{part}"
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if stage.sink is not None:
            stage.sink[name] = stage.sink.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def device_span(part: str, device: torch.device):
    """Time the block's work on ``device`` as a child of the stage open on
    this thread: its device seconds into the stage's sink as
    ``<stage>.<part>`` once the stage has synchronised ``device``; a
    :func:`span` where the stage would not synchronise ``device``."""
    stages = _open.stages
    stage = stages[-1] if stages else None
    if (stage is None or stage.synced is None or device.type != "cuda"
            or _card(device) != _card(stage.synced)):
        with span(part):
            yield
        return
    name = f"{stage.name}.{part}"
    stream = torch.cuda.current_stream(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.record_function(name):
        start.record(stream)
        yield
        end.record(stream)
    stage.events.append((name, start, end))


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

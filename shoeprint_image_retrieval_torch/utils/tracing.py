"""Stage wall-clock timers, device timing and profiler traces.

Device work is asynchronous, so a timer given a CUDA device synchronises it
when its stage ends: the time it records is the stage's own, not the time
to enqueue it. Each stage is also a ``torch.profiler`` range of its name, so
a trace (:func:`profile_trace`) shows where one stage ends and the next
begins.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def stage_timer(name: str, verbose: bool = True, sink: dict | None = None,
                device: torch.device | None = None):
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        if verbose:
            print(f"[{name}] {dt:.2f}s")


@contextlib.contextmanager
def profile_trace(log_dir: str | Path | None, name: str = "trace",
                  device: torch.device | None = None):
    """A ``torch.profiler`` trace of the block, written as the Chrome trace
    ``{log_dir}/{name}.json``; host and CUDA activity on a card, host only
    on the CPU. A no-op when ``log_dir`` is empty (the JAX package's
    ``profile_trace`` over ``jax.profiler``)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
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

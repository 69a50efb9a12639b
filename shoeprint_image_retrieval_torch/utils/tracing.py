"""Stage wall-clock timers and device timing.

Device work is asynchronous, so a timer on a CUDA pipeline synchronises the
device when its stage ends: the time it records is the stage's own, not the
time to enqueue it.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def stage_timer(name: str, verbose: bool = True, sink: dict | None = None,
                device: torch.device | None = None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        if verbose:
            print(f"[{name}] {dt:.2f}s")


def device_ms(fn, reps: int, device: torch.device) -> float:
    """Mean time of ``fn`` over ``reps`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
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

"""Stage wall-clock timers.

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

"""One cluster scored at the sizing ``tpu.probe_batch = 0`` solves, held
against the memory model behind that sizing.

A cluster of Q = 1024 probes (C = 176 on a 36 x 36 canvas, the reference
sweep of 25 variants a probe) against G prints of 38-46 px through
``Pipeline._score_cluster`` with ``probe_batch = 0`` and
``gallery_block = 0``. The gallery lies in pinned host memory, where the
engine keeps a gallery over ``SIR_DEVICE_MAPS_MAX`` (a 10,240-print gallery
takes 15 GB), and the probes on the card. The engine picks the probe batch
and the gallery block. The bench reports them and the number of calls, and
holds the peak device memory the allocator saw during the cluster
(``torch.cuda.max_memory_allocated`` above what was allocated before)
against two numbers:

* ``model_bytes``: what the engine's model counts for one call at that
  sizing, the block's cache (``gallery_block_bytes_per_print`` with no rows)
  plus the rows (``probe_row_bytes``), and the stacks kept across blocks
  where the engine keeps them;
* ``free_bytes``: what the solve started from, less
  ``AUTO_BLOCK_MARGIN_BYTES``. The peak must stay under it.

The probes' valid windows are 6 x 6 on their 36 x 36 canvas. A call's
memory does not depend on the windows: every buffer is sized by the canvas.
The kernel's work does, because each tile's tap rectangle holds its rows'
windows. So the cluster takes about 3 minutes on an H100 (the kernel's
per-position epilogue still runs for every row, print and channel) where
real windows would take far longer. The times it prints are not the
kernel's rate at real windows.

    python -m shoeprint_image_retrieval_torch.benchmarks.bench_autosize [--g 10240]
        [--q 1024] [--quick] [--device cuda|cpu]

Prints one JSON line. On the CPU the engine keeps 56 probes a call and one
block, and no device memory is read; ``--quick`` shrinks the shapes for that.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import bench
from ..device import free_bytes, resolve_device
from ..ops.boxsum import EDGE_CROP
from ..ops.ncc_kernel import (
    AUTO_BLOCK_MARGIN_BYTES,
    gallery_block_bytes_per_print,
    kernel_tile,
    probe_row_bytes,
)
from ..retrieval.engine import PREBUILD_BYTES, variant_classes, variant_plan
from .bench_10k import block_sizes, generate_block

GEN_BLOCK = 2048  # prints generated on the card at a time, then copied to the host
WINDOW = 6        # the probes' valid size


def make_gallery(g: int, c: int, hi: int, lo: int,
                 dev: torch.device) -> tuple[torch.Tensor, np.ndarray]:
    """(G, C, hi, hi) maps in pinned host memory (in host memory on the
    CPU) and their valid sizes: blocks of ``GEN_BLOCK`` prints made on
    ``dev`` by ``bench_10k.generate_block``."""
    maps = torch.empty((g, c, hi, hi), dtype=torch.float32, pin_memory=dev.type == "cuda")
    sizes = []
    for bi, lo_i in enumerate(range(0, g, GEN_BLOCK)):
        nb = min(GEN_BLOCK, g - lo_i)
        s = block_sizes(bi, nb, lo, hi)
        maps[lo_i : lo_i + nb].copy_(generate_block(bi, s, c, hi, dev))
        sizes.append(s)
    return maps, np.concatenate(sizes)


def run(g: int = 10240, q: int = 1024, quick: bool = False,
        device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    if quick:
        g, q, c, g_lo, g_hi, canvas = 24, 6, 16, 18, 24, 18
    else:
        c, g_lo, g_hi, canvas = 176, 38, 46, 36
    t0 = time.perf_counter()
    gal, g_sizes = make_gallery(g, c, g_hi, g_lo, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    qmaps = torch.zeros((q, c, canvas, canvas), device=dev)
    qmaps[:, :, :WINDOW, :WINDOW] = torch.randn((q, c, WINDOW, WINDOW), generator=gen, device=dev)
    q_sizes = np.full((q, 2), WINDOW, np.int32)
    setup_s = time.perf_counter() - t0

    plan = variant_plan(q_sizes, (canvas, canvas), bench.ROTATIONS, bench.SCALES)
    n_var = sum(variant_classes("reference", plan.n_rot, plan.n_scl)[1])
    kernel_hw = (plan.template_canvas[0] - 2 * EDGE_CROP, plan.template_canvas[1] - 2 * EDGE_CROP)
    with tempfile.TemporaryDirectory(prefix="bench_autosize_") as tmp:
        pipe = bench.engine_pipeline(Path(tmp), 0, dev)
        cuda = dev.type == "cuda"
        if cuda:
            pipe._join_prewarm()
            torch.cuda.synchronize(dev)
            free0 = free_bytes(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pipe._score_cluster(qmaps, q_sizes, gal, g_sizes)
        score_s = time.perf_counter() - t0
        pb, calls = pipe.probe_batches[-1], pipe.gallery_blocks_scored
        peak = torch.cuda.max_memory_allocated(dev) - base if cuda else None
        pipe.close()
    gb = -(-g // calls)
    rows = pb * n_var
    batches = -(-q // pb)
    stack = rows * c * kernel_hw[0] * kernel_hw[1] * 4
    kept = batches * stack if calls > 1 and batches * stack < PREBUILD_BYTES else 0
    model = (gb * gallery_block_bytes_per_print(c, g_hi, g_hi, 0) + kept
             + rows * probe_row_bytes(c, (canvas, canvas), plan.template_canvas, kernel_hw,
                                      plan.n_rot, plan.n_scl, n_var, gb))
    out = {"metric": "auto_sizing_peak_bytes", "g": g, "q": q, "channels": c,
           "probe_batch": pb, "rows": rows, "whole_tiles": rows % kernel_tile().rows == 0
           if cuda else None, "batches": batches, "gallery_block": gb, "blocks": calls,
           "stacks_kept_bytes": kept, "model_bytes": model, "peak_bytes": peak,
           "free_bytes": free0 - AUTO_BLOCK_MARGIN_BYTES if cuda else None,
           "peak_over_model": peak / model if cuda else None,
           "setup_s": setup_s, "score_s": score_s,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    if cuda and peak > free0 - AUTO_BLOCK_MARGIN_BYTES:
        raise RuntimeError(f"bench_autosize: peak {peak} bytes over the free bytes less the "
                           f"margin, {free0 - AUTO_BLOCK_MARGIN_BYTES}: {out}")
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.benchmarks.bench_autosize")
    ap.add_argument("--g", type=int, default=10240)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(args.g, args.q, args.quick, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""Fusion scoring: the cost of scoring a cluster at two truncation blocks.

The port of ``benchmarks/bench_fusion.py``. ``tpu.fusion_blocks`` scores each
cluster once per listed block and sums the score matrices
(``engine.Pipeline.run_cluster``). On seeded maps shaped like
EfficientNetV2_M's two shipped candidate blocks, through the engine's
``_score_cluster`` on device-resident maps (G = 300 prints, Q = 56 probes,
PB = 56, the reference's 25-variant sweep):

* block 6: C = 176 at stride 16, prints of 38-46 px, probes of 28-36 px;
* block 4: C = 80 at stride 8, prints of 76-92 px, probes of 56-72 px.

Fusion's cost is one full scoring pass per block, so its rate is the
harmonic sum of the blocks' rates. Each block is timed once (host clock
around the call, which ends by pulling its scores), after one small call
that builds the kernel and sets the card up.

    python -m shoeprint_image_retrieval_torch.benchmarks.bench_fusion [--quick] [--device cuda|cpu]

Prints one JSON line under the JAX bench's metric name. With ``--device
cpu`` every time is the CPU's; ``--quick`` shrinks the shapes for that.
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
from ..device import resolve_device

# (label, C, print side lo, hi, probe side lo, hi)
BLOCKS = (("block6", 176, 38, 46, 28, 36), ("block4", 80, 76, 92, 56, 72))
QUICK_BLOCKS = (("block6", 16, 18, 24, 14, 18), ("block4", 8, 30, 40, 24, 30))
G, Q, PB = 300, 56, 56


def make_maps(rng: np.random.Generator, n: int, c: int, lo: int, hi: int):
    """(n, C, hi, hi) maps of seeded normals inside (n, 2) valid sizes in
    [lo, hi], zero outside (the JAX bench's draw order)."""
    sizes = np.stack([rng.integers(lo, hi + 1, n), rng.integers(lo, hi + 1, n)], 1).astype(np.int32)
    maps = np.zeros((n, c, hi, hi), np.float32)
    for i, (h, w) in enumerate(sizes):
        maps[i, :, :h, :w] = rng.normal(size=(c, h, w)).astype(np.float32)
    return maps, sizes


def workload(quick: bool = False, q: int = Q) -> list[tuple]:
    """Per block: (label, C, gallery maps, their sizes, ``q`` probe maps,
    their sizes), drawn from one seeded generator in the JAX bench's order."""
    g, q = (16, 4) if quick else (G, q)
    rng = np.random.default_rng(0)
    out = []
    for label, c, g_lo, g_hi, q_lo, q_hi in (QUICK_BLOCKS if quick else BLOCKS):
        gal, g_sizes = make_maps(rng, g, c, g_lo, g_hi)
        qm, q_sizes = make_maps(rng, q, c, q_lo, q_hi)
        out.append((label, c, gal, g_sizes, qm, q_sizes))
    return out


def run(quick: bool = False, q: int = Q, pb: int = PB,
        device: str | torch.device = "cuda") -> dict:
    """Both blocks through the engine, ``q`` probes, ``pb`` a call."""
    dev = resolve_device(device)
    pb = 2 if quick else min(pb, q)
    per_block, seconds = {}, {}
    fused = None
    with tempfile.TemporaryDirectory(prefix="bench_fusion_") as tmp:
        pipe = bench.engine_pipeline(Path(tmp), pb, dev)
        for label, c, gal, g_sizes, qm, q_sizes in workload(quick, q):
            g_in, q_in = torch.from_numpy(gal).to(dev), torch.from_numpy(qm).to(dev)
            if not per_block:  # the kernel's build and the card's first launch
                pipe._score_cluster(q_in[:1], q_sizes[:1], g_in[:2], g_sizes[:2])
            t0 = time.perf_counter()
            s = pipe._score_cluster(q_in, q_sizes, g_in, g_sizes)
            seconds[label] = time.perf_counter() - t0
            per_block[label] = len(qm) / seconds[label]
            fused = s if fused is None else fused + s
            bench.log(f"{label}: C={c} prints <= {gal.shape[-1]} px -> "
                      f"{per_block[label]:.2f} probes/s")
        pipe.close()
    n_q = len(q_sizes)
    if fused.shape != (n_q, len(g_sizes)) or not np.isfinite(fused).all():
        raise RuntimeError(f"bench_fusion: bad fused scores {fused.shape}")
    pps = n_q / sum(seconds.values())
    bench.log(f"fused ({'+'.join(per_block)}): {pps:.2f} probes/s")
    return {"metric": "probes_per_sec_fusion_two_block", "value": pps, "unit": "probes/s",
            **{f"{k}_probes_per_sec": v for k, v in per_block.items()},
            **{f"{k}_s": v for k, v in seconds.items()},
            "probes": n_q, "prints": len(g_sizes), "probe_batch": pb,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.benchmarks.bench_fusion")
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(args.quick, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

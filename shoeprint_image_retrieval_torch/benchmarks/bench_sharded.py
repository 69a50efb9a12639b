"""The sharded scorer's split of the work: one call over 1 / 2 / 4 / 8 shards.

The port of ``benchmarks/bench_sharded.py``'s scaling half: one probe batch
of ``bench.py``'s workload (G = 300, C = 176, PB = 56, N = 1400 rows)
against the fixed gallery, unsharded and sharded 1 / 2 / 4 / 8 ways
(``shard_cache``, ``make_sharded_packed_scorer``) on a mesh that repeats the
device, or with ``--real-devices`` over the visible CUDA devices (as many
shard counts as there are cards). Each sharded call's scores must lie
within 1e-6 of the unsharded call's, with each row's rank of its best print
and of a seeded random print identical. Per shard count it reports the
prints a shard, the bytes the gather moves (N x G/n x 4 x (n - 1) a device
a batch, the JAX bench's ring all-gather formula), the kernel's launches,
the call's ms (CUDA events on the primary device, every mesh device
synchronised before and after; the host clock on the CPU), its bound and
the bound's share of the ms. The bound is the busiest card's
(``kernel_probe.bound`` of the shards that lie on it: the FLOP their
correlation needs, pad prints included, at the 3xTF32 peak, against their
caches read once, the stack once a shard and their scores written once, at
the memory rate), since the cards work at once.

The JAX bench's other half, the sharded wrapper's overhead at a mesh of 1,
has no counterpart: here one device is a mesh of one, and the engine always
scores through the mesh path.

    python -m shoeprint_image_retrieval_torch.benchmarks.bench_sharded [--real-devices]
        [--quick] [--device cuda|cpu]

Prints one JSON line. ``--quick`` shrinks the workload (G = 24, C = 16, PB =
2) for the CPU, where the plain scorer runs and every time is the host
clock's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..ops import ncc_kernel
from ..parallel.mesh import build_mesh, visible_devices
from ..parallel.sharded import make_sharded_packed_scorer, shard_cache
from . import kernel_probe

SHARDS = (1, 2, 4, 8)
SHARD_TOL = 1e-6  # sharded vs unsharded: each pair scored alone, by the same kernel


def _ranks(scores: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Each row's rank of its column ``cols[row]``: 1 + the prints above it."""
    s = scores[np.arange(len(scores)), cols]
    return 1 + (scores > s[:, None]).sum(axis=1)


def scaling(quick: bool = False, device: str | torch.device = "cuda", shards=SHARDS,
            real_devices: bool = False) -> dict:
    """One probe batch against the gallery, unsharded and at each shard
    count; raises if a sharded call's scores or ranks differ."""
    dev = resolve_device(device)
    w = bench.make_workload(quick)
    pb = w["pb"]
    qmaps = bench.draw_probe_maps(w)[:pb]
    inputs = kernel_probe.stack_inputs(w["gal"], w["g_sizes"], qmaps, w["q_sizes"][:pb], dev)
    cache, packed, layout, c = (inputs[k] for k in ("cache", "packed", "layout", "channels"))
    uniq, inv = inputs["slots"]
    g = len(w["gal"])
    on_card = dev.type == "cuda"
    rows = plan = None
    if on_card:
        tile = ncc_kernel.kernel_tile()
        rows = ncc_kernel.row_plan(inputs["row_hw"], inputs["kernel_hw"], tile.rows, dev)
        plan = (rows, ncc_kernel.print_plan(w["g_sizes"] - 4, tile.positions))
    if real_devices:
        pool = visible_devices(dev.type)
        shards = [n for n in shards if n <= len(pool)]
    else:
        pool = [dev] * max(shards)

    def timed(fn, devices) -> tuple[float, torch.Tensor]:
        if not on_card:
            t0 = time.perf_counter()
            res = fn()
            return (time.perf_counter() - t0) * 1e3, res
        for d in devices:
            torch.cuda.synchronize(d)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        for d in devices:
            torch.cuda.synchronize(d)
        return start.elapsed_time(end), res

    def unsharded():
        return ncc_kernel.score_ncc(cache, packed, layout, c, uniq, inv, plan=plan)

    with torch.inference_mode():
        unsharded()  # the first call builds the kernel and sets the card up
        base_ms, base = timed(unsharded, [dev])
        base = base.cpu().numpy()
        stack_bytes = sum(t.numel() * t.element_size() for t in (packed.kernels, uniq, inv))
        cols = [np.argmax(base, axis=1), np.random.default_rng(5).integers(0, g, len(base))]
        want = [_ranks(base, col) for col in cols]
        points = []
        for n in shards:
            mesh = build_mesh(n, pool)
            sharded, g_true = shard_cache(cache, mesh)
            scorer = make_sharded_packed_scorer(mesh, sharded, true_channels=c, layout=layout,
                                                g_true=g_true, use_kernel=True)
            launches0 = ncc_kernel.launch_ncc.launches
            ms, got = timed(lambda: scorer(packed, uniq, inv, rows), mesh.distinct())
            launches = ncc_kernel.launch_ncc.launches - launches0
            got = got.cpu().numpy()
            err = float(np.abs(got - base).max())
            if got.shape != base.shape or err > SHARD_TOL:
                raise AssertionError(f"{n} shards: scores differ from unsharded by {err}")
            if any(not np.array_equal(_ranks(got, col), r) for col, r in zip(cols, want)):
                raise AssertionError(f"{n} shards: ranks differ from unsharded")
            g_shard = sharded[0].valid_hw.shape[0]
            per_card = {}  # device -> [FLOP, bytes] of the shards on it
            for shard, d in zip(sharded, mesh.devices):
                work = per_card.setdefault(d, [0.0, 0])
                work[0] += ncc_kernel.needed_flop(inputs["row_hw"], shard.valid_hw.cpu().numpy(),
                                                  c, tuple(shard.p0.shape[2:]))
                work[1] += (sum(t.numel() * t.element_size() for t in shard) + stack_bytes
                            + layout.n_variants * g_shard * 4)
            least = max((kernel_probe.bound(*work) for work in per_card.values()),
                        key=lambda b: b["bound_ms"])
            points.append({
                "shards": n, "devices": [str(d) for d in mesh.distinct()],
                "prints_per_shard": g_shard,
                "gather_bytes_per_device": layout.n_variants * g_shard * 4 * (n - 1),
                "launches": launches, "ms": ms, "max_abs_diff": err,
                "needed_flop": sum(w[0] for w in per_card.values()),
                "bytes": sum(w[1] for w in per_card.values()),
                "busiest_card": {"needed_flop": max(w[0] for w in per_card.values()),
                                 "bytes": max(w[1] for w in per_card.values())},
                **least, "bound_share": least["bound_ms"] / ms})
            bench.log(f"{n} shards ({len(mesh.distinct())} devices): {ms:.1f} ms, "
                      f"{g_shard} prints a shard, max |diff| {err:.2e}")
            del sharded, scorer
    return {"rows": layout.n_variants, "prints": g, "channels": c, "probes": pb,
            "unsharded_ms": base_ms, "points": points}


def run(quick: bool = False, device: str | torch.device = "cuda",
        real_devices: bool = False) -> dict:
    dev = resolve_device(device)
    return {"metric": "sharded_scorer",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "device_count": torch.cuda.device_count() if dev.type == "cuda" else 1,
            "scaling": scaling(quick, dev, real_devices=real_devices)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m shoeprint_image_retrieval_torch.benchmarks.bench_sharded")
    ap.add_argument("--real-devices", action="store_true",
                    help="shard over the visible CUDA devices, not one device repeated")
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(args.quick, args.device, real_devices=args.real_devices)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""Headline benchmark of the port: probes per second ranked against a gallery.

The port of the repository's ``bench.py``, on the same workload and under
the same metric names:

* **Workload** (the same seeded-numpy recipe): G = 300 gallery prints of
  EfficientNetV2_M-block-6-like maps (C = 176, 38-46 px, height-sorted),
  Q = 168 probes of 28-36 px, the reference's sweep (rotations
  [-15, -9, -3, 3, 9, 15, 180] x scales [1.02, 1.04, 1.08], 25 variants a
  probe), PB = 56 probes (1400 variant rows) per scoring call.
* **Engine mode** (the headline, ``probes_per_sec_engine_path``): a temporary
  ``run.toml`` and ``Pipeline._score_cluster`` on device-resident maps, one
  warm-up call and one timed call; with ``host_maps`` (``--host-maps``, the
  JAX bench's ``BENCH_ENGINE_HOST``) on maps left on the host, which the
  engine moves to the card within the call; ``--cache-bf16`` adds
  ``tpu.cache_dtype = "bfloat16"``, so those host maps rest in bf16 (cast
  before the clock starts, as the engine casts them before scoring).
* **Kernel-level mode** (``kernel``): the gallery cache built once, then per
  probe batch ``build_kernels`` + ``score_ncc`` + ``regroup_max``, one
  warm-up pass and one timed pass.
* ``--bf16`` (the JAX bench's ``BENCH_BF16``): the kernel-level mode scores
  through the NCC kernel's bf16 leg (``compute_dtype = torch.bfloat16``),
  and the engine mode runs with ``tpu.precision = "bfloat16"``, which takes
  the same leg.

    python -m shoeprint_image_retrieval_torch.bench [--quick] [--engine | --kernel] [--host-maps]
        [--cache-bf16] [--bf16] [--device cuda|cpu]

Prints one JSON line on stdout (progress goes to stderr): ``metric``,
``value``, ``unit``, ``vs_baseline`` (value / 100 probes/s, BASELINE.json's
north-star target), ``engine`` and ``kernel`` in probes/s, and the device.
Runs on the card unless ``--device cpu``; ``--quick`` shrinks the workload
(G = 24, C = 16, Q = 4, PB = 2) for the CPU. The engine runs on one device
(``tpu.mesh_shape = 1``, as the JAX bench's). The JAX bench's TPU-only
switch ``BENCH_EPI`` is not carried over, nor ``SIR_FORCE_SHARDED``: here
one device is a mesh of one, and the engine always scores through the
mesh path.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device

ROTATIONS = [-15, -9, -3, 3, 9, 15, 180]
SCALES = [1.02, 1.04, 1.08]
TARGET_PROBES_PER_SEC = 100.0  # BASELINE.json's north-star target


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_workload(quick: bool = False, q: int | None = None) -> dict:
    """The gallery and its sizes, the probe sizes and the numpy generator,
    drawn in the JAX bench's order (seed 0)."""
    if quick:
        g, c, q_def, pb = 24, 16, 4, 2
        g_lo, g_hi, q_lo, q_hi = 18, 24, 14, 18
    else:
        g, c, q_def, pb = 300, 176, 168, 56
        g_lo, g_hi, q_lo, q_hi = 38, 46, 28, 36
    q = q_def if q is None else q
    rng = np.random.default_rng(0)
    g_sizes = np.stack([rng.integers(g_lo, g_hi + 1, g), rng.integers(g_lo, g_hi + 1, g)],
                       1).astype(np.int32)
    g_sizes = g_sizes[np.argsort(-g_sizes[:, 0], kind="stable")]
    gal = np.zeros((g, c, g_hi, g_hi), np.float32)
    for i, (h, w) in enumerate(g_sizes):
        gal[i, :, :h, :w] = rng.normal(size=(c, h, w)).astype(np.float32)
    q_sizes = np.stack([rng.integers(q_lo, q_hi + 1, q), rng.integers(q_lo, q_hi + 1, q)],
                       1).astype(np.int32)
    return {"gal": gal, "g_sizes": g_sizes, "q_sizes": q_sizes, "rng": rng, "c": c,
            "canvas": q_hi, "pb": min(pb, q)}


def draw_probe_maps(w: dict) -> np.ndarray:
    """(Q, C, hc, wc) probe maps: the next draws of the workload's generator."""
    q_sizes, c, hc = w["q_sizes"], w["c"], w["canvas"]
    maps = np.zeros((len(q_sizes), c, hc, hc), np.float32)
    for i, (h, wd) in enumerate(q_sizes):
        maps[i, :, :h, :wd] = w["rng"].normal(size=(c, h, wd)).astype(np.float32)
    return maps


RUN_TOML = """
[dataset]
dir = "{root}"
type = "Impress"
crop = [0.0, 0.0]
n_processes = 2
n_clusters = 1
cluster_minimise_tolerance = 0.05

[model]
type = "EfficientNetV2_M"
clahe_clip_limit = 2.0
clahe_tile_grid_size = [8, 8]
start_block = 6
end_block = 4
skip_blocks = [5]
minimum_dim = 8
maximum_dim = 800

[comparison]
n_processes = 2
rotations = {rotations}
scales = {scales}

[tpu]
mesh_shape = 1
ncc_backend = "pallas"
probe_batch = {pb}
precision = "{precision}"
"""


def engine_pipeline(root: Path, pb: int, device: torch.device, precision: str = "float32",
                    mesh_devices=None):
    """A ``Pipeline`` over a one-print, one-query dummy dataset, with
    ``tpu.precision`` = ``precision`` and the ``Pipeline``'s
    ``mesh_devices``: the bench drives its ``_score_cluster`` with its own
    maps."""
    from PIL import Image

    from .config import load_config
    from .retrieval.engine import Pipeline

    for sub, name in (("Gallery", "1_1.png"), ("Query", "1_q0.png")):
        (root / sub).mkdir()
        Image.fromarray(np.full((24, 24), 128, np.uint8)).save(root / sub / name)
    cfg = root / "run.toml"
    cfg.write_text(RUN_TOML.format(root=root, rotations=ROTATIONS, scales=SCALES, pb=pb,
                                   precision=precision))
    return Pipeline(load_config(cfg), weights_dir=None, verbose=False, device=device,
                    mesh_devices=mesh_devices)


def run_engine_mode(w: dict, qmaps: np.ndarray, device: torch.device,
                    host_maps: bool = False, bf16: bool = False,
                    cache_bf16: bool = False) -> float:
    """Probes/s of ``Pipeline._score_cluster`` on device-resident maps, or
    with ``host_maps`` on maps in host memory; ``bf16`` sets
    ``tpu.precision = "bfloat16"``, ``cache_bf16`` ``tpu.cache_dtype =
    "bfloat16"``."""
    with tempfile.TemporaryDirectory(prefix="bench_engine_") as tmp:
        pipe = engine_pipeline(Path(tmp), w["pb"], device, "bfloat16" if bf16 else "float32")
        if cache_bf16:
            pipe.config["tpu"]["cache_dtype"] = "bfloat16"
        where = torch.device("cpu") if host_maps else device
        q_in = torch.from_numpy(qmaps).to(where)
        g_in = pipe._maps_at_rest(torch.from_numpy(w["gal"]).to(where))
        log(f"engine mode: Pipeline._score_cluster, PB={w['pb']}, {device.type}, "
            f"maps on {where.type}")
        t0 = time.perf_counter()
        pipe._score_cluster(q_in, w["q_sizes"], g_in, w["g_sizes"])
        log(f"warm-up: {time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        scores = pipe._score_cluster(q_in, w["q_sizes"], g_in, w["g_sizes"])
        dt = time.perf_counter() - t0
    if scores.shape != (len(qmaps), len(w["gal"])) or not np.isfinite(scores).all():
        raise RuntimeError(f"engine mode: bad scores {scores.shape}")
    pps = len(qmaps) / dt
    log(f"{len(qmaps)} probes x {len(w['gal'])} prints through the engine in {dt:.3f}s "
        f"-> {pps:.2f} probes/s")
    return pps


def run_kernel_mode(w: dict, qmaps: np.ndarray, device: torch.device,
                    bf16: bool = False) -> float:
    """Probes/s of the per-batch composition on a cache built once; ``bf16``
    scores through the kernel's bf16 leg."""
    from .ops.ncc_direct import PackedVariants, VariantLayout, build_direct_cache
    from .ops import ncc_kernel
    from .retrieval.engine import (
        batch_windows, build_kernels, regroup_max, variant_classes, variant_plan)

    q_sizes, pb, hc = w["q_sizes"], w["pb"], w["canvas"]
    n_q, c = len(q_sizes), w["c"]
    dtype = torch.bfloat16 if bf16 else torch.float32
    t0 = time.perf_counter()
    cache = build_direct_cache(torch.from_numpy(w["gal"]).to(device),
                               torch.from_numpy(w["g_sizes"]).to(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"gallery cache: G={len(w['gal'])} C={c} built in {time.perf_counter() - t0:.2f}s "
        f"({sum(t.numel() * t.element_size() for t in cache) / 1e9:.2f} GB)")
    plan = variant_plan(q_sizes, (hc, hc), ROTATIONS, SCALES)
    include, counts = variant_classes("reference", plan.n_rot, plan.n_scl)
    kernel_hw = (plan.template_canvas[0] - 4, plan.template_canvas[1] - 4)
    layout = VariantLayout(counts, pb)
    tables = [torch.as_tensor(np.asarray(a), device=device) for a in
              (qmaps, q_sizes, plan.rot_idx, plan.rot_ok, plan.wv, plan.wh, plan.scale_hw)]
    # the kernel's tile plan, made on the host as the engine makes it
    tile = ncc_kernel.kernel_tile() if device.type == "cuda" else None
    prints = None if tile is None else ncc_kernel.print_plan(w["g_sizes"] - 4, tile.positions)
    batches = []
    for lo in range(0, n_q, pb):
        take = np.minimum(np.arange(lo, lo + pb), n_q - 1)
        wins, uniq, inv = batch_windows(q_sizes[take], plan.scale_hw[take], plan.n_scl)
        tiles = None if tile is None else (ncc_kernel.row_plan(
            ncc_kernel.host_row_hw(wins, layout, uniq, inv), kernel_hw, tile.rows, device), prints)
        batches.append((torch.as_tensor(take, device=device),
                        *(torch.as_tensor(a, device=device) for a in (wins, uniq, inv)), tiles))
    log(f"PB={pb} variants={sum(counts)} N={layout.n_variants} batches={len(batches)}")

    def run_all() -> list[np.ndarray]:
        rows = []
        with torch.inference_mode():
            for take, wins, uniq, inv, tiles in batches:
                kernels = build_kernels(*(t.index_select(0, take) for t in tables),
                                        kernel_hw=kernel_hw, include_rots_unscaled=include,
                                        n_scl=plan.n_scl)
                scores = ncc_kernel.score_ncc(cache, PackedVariants(kernels, wins), layout, c,
                                              uniq, inv, plan=tiles, compute_dtype=dtype)
                rows.append(regroup_max(scores, layout))
        return [r.cpu().numpy() for r in rows]

    t0 = time.perf_counter()
    run_all()
    log(f"warm-up: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    rows = run_all()
    dt = time.perf_counter() - t0
    if not all(np.isfinite(r).all() for r in rows):
        raise RuntimeError("kernel mode: non-finite scores")
    pps = len(batches) * pb / dt
    log(f"{len(batches) * pb} probes x {sum(counts)} variants x {len(w['gal'])} prints in "
        f"{dt:.3f}s -> {pps:.2f} probes/s (kernel-level)")
    return pps


def run(quick: bool = False, engine: bool = True, kernel: bool = True,
        device: str | torch.device = "cuda", q: int | None = None,
        host_maps: bool = False, bf16: bool = False, cache_bf16: bool = False) -> dict:
    """Both modes (or one) -> the JSON result; ``q`` overrides the probe
    count, ``host_maps`` leaves the engine mode's maps on the host,
    ``cache_bf16`` holds them there in bf16 (``--cache-bf16``), ``bf16``
    scores with bf16 operands (``--bf16``)."""
    if not (engine or kernel):
        raise ValueError("bench: nothing to run (engine and kernel both off)")
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}")
    w = make_workload(quick, q)
    engine_pps = kernel_pps = None
    if engine:
        engine_pps = run_engine_mode(w, draw_probe_maps(w), dev, host_maps, bf16, cache_bf16)
    if kernel:
        kernel_pps = run_kernel_mode(w, draw_probe_maps(w), dev, bf16)
    metric = "probes_per_sec_engine_path" if engine else "probes_per_sec_full_gallery_ncc"
    value = engine_pps if engine else kernel_pps
    result = {"metric": metric, "value": round(value, 3), "unit": "probes/s",
              "vs_baseline": round(value / TARGET_PROBES_PER_SEC, 4)}
    if engine and kernel:
        result.update(engine=round(engine_pps, 3), kernel=round(kernel_pps, 3))
    result["device"] = name
    result["precision"] = "bfloat16" if bf16 else "float32"
    if engine:
        result["maps"] = "host" if host_maps else "device"
        result["cache_dtype"] = "bfloat16" if cache_bf16 else "float32"
    return result


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.bench")
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--engine", action="store_true", help="engine path only")
    mode.add_argument("--kernel", action="store_true", help="kernel-level composition only")
    ap.add_argument("--host-maps", action="store_true",
                    help="engine mode on maps in host memory (BENCH_ENGINE_HOST)")
    ap.add_argument("--cache-bf16", action="store_true",
                    help="engine mode with tpu.cache_dtype = bfloat16 (host maps rest in bf16)")
    ap.add_argument("--bf16", action="store_true",
                    help="score with bf16 operands: the kernel's bf16 leg (BENCH_BF16)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(args.quick, engine=not args.kernel, kernel=not args.engine, device=args.device,
                 host_maps=args.host_maps, bf16=args.bf16, cache_bf16=args.cache_bf16)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

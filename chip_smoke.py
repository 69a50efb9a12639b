#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each printing one JSON line:

1. ``build``: compiles every kernel of the port (``csrc/*.cu``) from the
   sources in the checkout for ``sm_90a``, one ``nvcc`` per source, all
   started together, with the compiler's register/shared-memory report and
   each entry function's registers, spills and ptxas's ``wgmma`` notes
   (the NCC kernel's three instantiations: the 3xTF32 leg's split and float
   patches and the bf16 leg); fails if the NCC kernel or the probe kernel
   spills registers or an NCC instantiation is missing.
2. ``kernel``: the fused NCC scorer ``score_ncc`` (the wrapper the engine
   calls; a warp-specialised 3xTF32 ``wgmma`` implicit GEMM) against its plain PyTorch
   version on the card, at the main-path shapes (G = 300 prints of 38-46 px
   raw, C = 176, probes of 28-36 px, a 34 x 34 kernel canvas, 25 variants
   per probe, PB = 56 probes, N = 1400 rows), plus the edge cases (zero
   template, flat print, zero-energy windows, a template larger than the
   prints). Max |kernel - plain| must be <= 1e-4, each row's true-match
   rank identical and top-1 identical where the margin is clear. Then the
   fixture's cluster-0 call, built from a seed (``kernel_probe.case_inputs
   ("fixture_c0")``: C = 80, 120 prints on 84 x 68 cropped maps, 375 rows
   on a 47 x 39 kernel canvas), held the same way and timed beside its
   bound, its plain version and one ``F.conv2d``, with its design. Reports
   the wrapper's time (CUDA events), the plain version's, one PyTorch
   convolution's (the yardstick, never called by the port), the least time
   the card could take at the route's peak (``bound_ms``, 3xTF32 at
   495 / 3 TFLOP/s) and on the CUDA cores (``bound_fp32_ms``), the FLOP the
   kernel executes for its tile plan, the launch geometry and the design
   (``ncc_design``: the producer and consumer warpgroups and the registers
   ``setmaxnreg`` gives each, the tap ring's depth, the patch buffers, and
   each instantiation's launch registers, spills and ptxas ``wgmma`` notes).
3. ``main_path``: the synthetic Impress fixture
   (``scripts/make_synthetic_impress.generate``, 120 prints, 30 queries) on
   ``benchmarks/synthetic_impress.toml``'s settings through the port's
   ``Pipeline`` — full-width EfficientNetV2_M from seeded init — with the
   ``[tpu]`` defaults (native ingest tiers, streamed extraction with host
   CLAHE, the cluster lookahead, the kernel's build prewarmed) four times, in
   the order plain, kernel, kernel, plain (launch counts reset just before
   the first kernel run and read just after it); then with the kernel three
   more times: ``clahe_host = false`` (CLAHE on the card), ``profile_dir``
   set (a ``torch.profiler`` trace per cluster) and ``pipeline_clusters =
   false``. Ranks and S-lines must be identical in all seven, the kernel
   runs' scores bit-identical to each other, one gallery block a cluster in
   each, and the trace must hold device events. Reports each run's stage
   seconds (its own thread's and the lookahead's), ingest tiers, CLAHE
   route, peak device memory and score time per cluster, and from the
   trace, per cluster: the device's busy and idle share, its 5 ops with the
   most time and its 3 longest idle gaps with the host op that spans each
   on the thread that issued the device work after it
   (:func:`trace_summary`).
   Then ``summed_maps``: the visualisation script's path
   (``scripts/summed_feature_maps``) on the fixture's first query and its
   true print at full resolution, full-width EfficientNetV2_M at block 6
   from seeded init (C = 176). The card's features against the CPU's
   (within 1e-4 of the activation scale); on the card's features, the
   card's per-channel maps and score against the CPU's (within 1e-4 and
   1e-5); the score against the NCC kernel's score of the query's identity
   variant against the print (within 1e-4, one launch). Reports the
   extraction and maps times (CUDA events), the JAX script's loop of one
   call a channel, the engine's packing and kernel call, and the kernel's
   call alone beside its bound, its plain version and one ``F.conv2d``. No
   PNG.
4. ``fft``: the fixture's EfficientNetV2_M config (``main_path``'s) with
   ``ncc_backend = "fft"`` on the card (``ops/ncc.py``: cuFFT through
   ``torch.fft``, one FFT cache a cluster). Ranks and S-lines must equal
   ``main_path``'s plain run; reports the max |Δ| of the scores, the
   ``score`` stage against the kernel runs' and the FFT cache's bytes a
   block.
5. ``families``: the fixture with the ``[tpu]`` defaults through three
   other families at full width from seeded init, each plain then kernel:
   VGG16 (blocks 24 / 17, skipping 18-23: C = 512 at /16, 256 at /8),
   DenseNet_201 (8 / 6, skipping 7: 256 and 128) and EfficientNet_B7
   (6 / 4, skipping 5: 224 and 80). Ranks and S-lines identical, scores
   within 1e-4, the NCC kernel launched for each model. Reports stage
   seconds, peak device memory, score seconds a cluster and, per kernel
   call (CUDA events around the engine's ``score_ncc``), its C, rows,
   prints, ms, its bound by ``kernel``'s formula and one ``F.conv2d`` of
   its operands (``library_ms``, timed after the run).
   Then ``fusion``: the fixture with ``fusion_blocks = [6, 4]``, plain then
   kernel (launch counts reset just before the kernel run, read just after):
   ranks and S-lines identical, the kernel launched at both blocks' C, the
   ranks equal to those of the sum of each block's ``_cluster_scores``;
   ``benchmarks/bench_fusion`` (G = 300, blocks 6 and 4; Q cut from 56 to
   ``FUSION_PROBES``) and its block-4 call timed beside its bound and one
   ``F.conv2d``.
6. ``front_end``: on the fixture's ingested images, the device CLAHE on the
   card against the native host CLAHE, gray (``clahe_batched_dynamic``)
   and RGB (the engine's LAB route, on colour images made from the gray
   ones), and on random sizes below the tile grid against its own CPU run;
   all bit-exact; the times of both. Then the streamed extraction of the
   gallery against the batched one: maps bit-identical, or else the max
   |Δ| is reported and the ranks must be identical.
7. ``extract``: ``benchmarks/bench_extract.run`` at full size (batch 32, a
   704 x 704 canvas, block 6): images/s with CLAHE on the card and on the
   host.
8. ``parity``: ``retrieval/parity.run_parity`` on a fixture of 6 prints and
   3 queries (the NumPy oracle's time bounds its size): the pipeline's
   ranks against the oracle's (cv2's CLAHE, extraction at native shape,
   the NumPy correlation), which must be identical.
   Then ``bf16``: ``tpu.precision`` and ``cache_dtype = "bfloat16"``. One
   main-path call (PB = 56) through the NCC kernel's bf16 leg (``wgmma``
   m64n64k16 on operands rounded to bf16) against the plain scorer on the
   same bf16 operands (within 1e-5, true-match ranks identical), with its
   ms, its bound at 989 TFLOP/s and share of it, the plain ms, one
   ``F.conv2d`` on the bf16 operands, its design (as ``kernel``'s) and its
   max |Δ| against the 3xTF32
   leg, which must exceed 1e-5; the fixture with ``precision =
   "bfloat16"``, plain then kernel, and again with ``cache_dtype =
   "bfloat16"``, ``gallery_block = 40`` and ``SIR_DEVICE_MAPS_MAX = 0``
   (kernel and plain ranks and S-lines identical, scores within 1e-5, the
   at-rest run's more than 1e-5 from the first's, only the bf16 leg
   launched, counts reset just before each
   kernel run and read just after; the S-lines beside the f32 run's);
   the full-width EfficientNetV2_M at block 6 on one ``bench_extract``
   batch, bf16 against f32 (nonzero, within 1e-2 of the activation scale),
   and ``bench_extract`` images/s in bf16.
9. ``backbones``: all 13 model strings at full depth and width from seeded
   init on one masked batch of two images (a 160 x 144 canvas; valid 160 x
   144 and 121 x 97), on the card against the same module and weights on
   the CPU: within 1e-4 of the activation scale, valid sizes equal to
   ``models/summary.output_size``. Reports each forward's ms (CUDA events)
   and output (C, H, W).
10. ``mxu_probe``: the measurement path ``benchmarks/mxu_probe.probe_kernel``
   (launch counts reset just before it and read just after) runs the probe
   kernel ``ops/mma_probe`` in f32, 3xTF32 and bf16 at the JAX default shape
   (512 x 1156 x 128, 48 products a step, 100 steps) and at the NCC row count
   (n = 1400). Each leg is then held against its plain version
   ``probe_plain`` (max |kernel - plain| / max |plain| <= 1e-5 for f32 and
   bf16, <= 1e-4 for 3xTF32) and reports its time, TFLOP/s, the bound at the
   route's published peak, ``library_ms`` (``y_iters`` calls of
   ``torch.matmul`` on the (grid, n, k) stack, never called by the port),
   the bytes its TMA loads stream from L2 (``l2_bytes``, a model of its
   tiles) with the rate they imply, and its launch plan (persistent blocks,
   the parts each tile's products are cut into, scratch bytes), beside
   ``probe_matmul``'s 4096^3 rates and each leg's launch geometry (tile,
   ring stages, consumer warpgroups, shared memory, blocks a cluster).
11. ``bench``: the port's ``bench.py`` at full width (G = 300, C = 176,
   PB = 56) with Q = 56 probes: engine and kernel-level probes/s.
12. ``gallery_blocks``: the same workload through ``Pipeline._score_cluster``
   with ``gallery_block`` 0 and 128 (three blocks, the last of 44 prints),
   each with ``rank_on_device`` off and on. Scores must agree within 1e-6
   and ranks be identical. Reports the auto block ``mem_get_info`` gives at
   a 10,240-print gallery.
13. ``sharded``: gallery sharding (``parallel/``). The fixture through the
   kernel with ``tpu.mesh_shape = 4`` over ``[cuda:0] * 4`` (the
   ``Pipeline``'s ``mesh_devices``), then again in blocks of 40 prints, and
   with ``ncc_backend = "fft"`` over two; each with ``extraction_batch`` the
   shard count times the fixture's 32, so every device extracts the
   unsharded run's chunks. Ranks and S-lines must equal ``main_path``'s
   first kernel run (``fft``'s run for the FFT case), scores within 1e-6,
   every extraction and cluster run over the mesh, and the
   NCC kernel launched once a shard, probe batch and gallery block (counts
   reset just before each run, read just after). Then
   ``benchmarks/bench_sharded`` (one PB = 56 call against G = 300 prints,
   unsharded and over 1 / 2 / 4 / 8 shards of ``cuda:0``, each within 1e-6
   and rank-identical, with its ms, launches, gather bytes, bound and the
   bound's share). Where more than one card
   is visible, ``dryrun.dryrun_multichip`` over them; otherwise the line says
   the copies between cards went unexercised.
14. ``bench_10k``: the port's ``benchmarks/bench_10k.py`` at G = 10,240,
   C = 176, PB = 128, in blocks of 2048 prints (five), with its checks
   (device ranks = host ranks, an oracle subsample within 5e-4, every
   planted match at rank 1).
15. ``sizing``: the NCC kernel alone over PB = 28, 56, 112, 320 at
   the bench's shapes (``benchmarks/kernel_probe``: ms, executed and needed
   FLOP, TFLOP/s, bound share) and at PB = 56 in each of its two patch
   layouts (split, float, float, split), the per-batch variant build
   (``bench_build``), the per-block cache build at G = 300 and 2048
   (``bench_cachebuild``), the engine on host-resident maps in f32 and at
   rest in bf16 (``tpu.cache_dtype``), and the probe
   batch and gallery block ``probe_batch = 0`` gives at G = 300 and 10,240
   (with the block before the equal split).
16. ``pruned``: ``benchmarks/bench_pruned`` on its planted and random
   workloads (G = 1024, Q = 56, k = 22) through the kernel (launch counts
   reset just before each pruned path and read just after it, inside the
   bench; the full path's counted apart): ranks equal to the full path's;
   prune rate, pairs scored, both probes/s and the max |Δ| between pass 0's
   true-match scores and the full path's. On ``planted``, every call of
   the pruned path (passes 0, 1 and 2) is held against the plain scorer on
   the same inputs (within 1e-4) and the plain pruned ranks must equal the
   kernel's. Then pass 1's C = 22 call against the plain scorer (within
   1e-4), timed beside its bound and one ``F.conv2d``.

Every phase reports its seconds (``wall_s``). Then a ``{"kernels": [...]}``
line (the NCC kernel's entry also gives its launches in ``fusion``'s kernel
run, in ``pruned``'s two pruned paths and in ``sharded``'s first run, and per leg, 3xTF32 and bf16, its
ms, plain ms, bound, library ms, max |Δ| and launches on its path), the
card's name and power limit
as ``nvidia-smi`` prints them, and as the last line
``{"ok": true, "device": {...}}``. Any fault exits non-zero before that line;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

# probe kernel vs plain, relative to max |plain|: f32 and bf16 sums in another
# order (bf16 inputs are exact in f32, and so are their products); 3xTF32
# also drops the lo*lo term (~2^-22 relative)
PROBE_TOL = {"f32": 1e-5, "f32_3xtf32": 1e-4, "bf16": 1e-5}
BLOCK_TOL = 1e-6  # blocked vs unblocked engine scores: the kernel scores each print alone
# kernel vs plain: float32 sums over 176 channels x 1156 taps in another
# order, and 3xTF32 products (lo*lo dropped, ~2^-22 relative a product)
TOL = 1e-4
# the kernel against a float64 plain version on this many of the main-path
# prints: its error must stay under half of a plain TF32 path's
PRECISION_PRINTS = 16
PROBES = 56  # probes per scoring call on the main path: 56 x 25 variants = 1400 rows
REPS = 2     # timed calls after one warm-up
BLOCK = 128  # gallery_blocks: three blocks of the G = 300 bench gallery, the last of 44
G_10K, BLOCK_10K = 10240, 2048  # bench_10k: five blocks
# parity: the NumPy oracle correlates every variant of every query with
# every print, channel by channel, on the host (12 prints x 4 queries took
# 175 s on the H100's host); this fixture keeps it near a minute
PARITY_GALLERY, PARITY_QUERIES = 6, 3

# backbones: every model string at full depth on one masked batch
BACKBONE_CANVAS = (160, 144)
BACKBONE_VALID = ((160, 144), (121, 97))
# card vs CPU forward, relative to the activation scale (max |CPU output|):
# float32 convolutions in other algorithms (TF32 off). Relative, not
# absolute: from seeded init the B-series' activations shrink to ~1e-12
BACKBONE_TOL = 1e-4
# families: (model, start_block, end_block, skip_blocks), each planned at
# stride 16 and stride 8 on the fixture
FAMILIES = (
    ("VGG16", 24, 17, [18, 19, 20, 21, 22, 23]),
    ("DenseNet_201", 8, 6, [7]),
    ("EfficientNet_B7", 6, 4, [5]),
)

ROTATIONS = [-15, -9, -3, 3, 9, 15, 180]
SCALES = [1.02, 1.04, 1.08]
# fusion: the fixture's two planned blocks, each scored for every cluster;
# bench_fusion cut to this many probes (its block 4, a 73 x 73 kernel canvas
# over 88 x 88 prints at C = 80, takes ~9x block 6's FLOP a probe)
FUSION_BLOCKS = (6, 4)
FUSION_PROBES = 8
# sizing: the probe batches of the kernel's sweep (kernel_probe.PBS less
# 64 and 224, which the curve does not need, to keep the script's time)
SIZING_PBS = (28, 56, 112, 320)
# sizing: the cluster size the auto probe batch is solved for (more probes
# than the card's row cap holds, so the cap and not the cluster decides)
AUTO_PROBES = 1024
# bf16: the kernel's bf16 leg against the plain scorer on the same bf16
# operands: f32 sums of exact products in another order, each run of 8 tap
# chunks in the truncating accumulator. The bf16 rounding itself moves the
# main-path scores by more than this from the 3xTF32 leg's, so the check
# also tells the legs apart
BF16_TOL = 1e-5
# bf16 features against f32, relative to the activation scale (the JAX
# package gives ~2e-3 on the TPU, where its bf16 convs keep f32 outputs)
BF16_FEATURE_TOL = 1e-2
BF16_BLOCK = 40  # the cache_dtype run: three gallery blocks of the fixture's 120 prints
# sharded: the fixture over [cuda:0] * SHARDS (and its FFT run over two), once
# in blocks of SHARD_BLOCK; sharded vs unsharded scores within BLOCK_TOL
SHARDS = 4
SHARD_BLOCK = 40
# summed_maps: card vs CPU features relative to the activation scale; on the
# card's features, cuFFT's score and per-channel maps against the CPU FFT's
SUMMED_MAPS_TOL = {"features": 1e-4, "score": 1e-5, "maps": 1e-4}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean time of ``fn`` on the card over ``reps`` runs after one warm-up
    (none without ``warm``), from CUDA events (``utils.tracing.device_ms``)."""
    import torch

    from shoeprint_image_retrieval_torch.utils.tracing import device_ms

    return device_ms(fn, reps, torch.device("cuda"), warm=warm)


def spill_bytes(ptxas_lines: list[str]) -> int:
    """Spill stores plus spill loads over every kernel of one report."""
    return sum(int(m) for ln in ptxas_lines for m in re.findall(r"(\d+) bytes spill", ln))


def ptxas_entries(report: str) -> list[dict]:
    """Each compiled entry function of one ``nvcc -Xptxas -v`` report with
    its registers (at launch: ``setmaxnreg`` moves them between roles
    after), its spill bytes and ptxas's notes on its ``wgmma`` (the codes of
    serialised or compiler-waited products); the NCC kernel's
    instantiations also with their leg (``ops/ncc_kernel.LAYOUTS``: float
    and split are the 3xTF32 leg's patch layouts)."""
    from shoeprint_image_retrieval_torch.ops.ncc_kernel import LAYOUTS

    notes: dict[str, list[str]] = {}
    for m in re.finditer(r"\((C\d+)\)[^\n]*function '([^']+)'", report):
        notes.setdefault(m.group(2), []).append(m.group(1))
    entries, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"entry": m.group(1), "registers": None, "spill_bytes": 0,
                   "wgmma_notes": notes.get(m.group(1), [])}
            inst = re.search(r"ncc_score_kernelILNS_\d+LegE(\d+)E", m.group(1))
            if inst:
                cur["layout"] = LAYOUTS[int(inst.group(1))]
            entries.append(cur)
        elif cur is not None and "spill" in ln:
            cur["spill_bytes"] += spill_bytes([ln])
        elif cur is not None and (m := re.search(r"Used (\d+) registers", ln)):
            cur["registers"] = int(m.group(1))
    return entries


def ncc_design(build: dict, geometry: dict) -> dict:
    """The NCC kernel's design beside a call's times: its roles (the
    producer warpgroup and its consumers, the registers ``setmaxnreg`` gives
    each), the call's tap-ring depth and patch buffers, and each
    instantiation's launch registers, spills and ptxas ``wgmma`` notes."""
    keys = ("threads", "producer_warpgroups", "consumer_warpgroups", "producer_regs",
            "consumer_regs", "stages", "patch", "patch_buffers", "smem_bytes")
    return {**{k: geometry[k] for k in keys},
            "instantiations": [{k: e[k] for k in ("layout", "registers", "spill_bytes",
                                                  "wgmma_notes")}
                               for e in build["sources"]["ncc_score"]["entries"] if "layout" in e]}


def phase_build() -> dict:
    from shoeprint_image_retrieval_torch.ops import build

    t0 = time.perf_counter()
    out = {"phase": "build", "sources": {}}
    names = sorted(src.stem for src in build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        results = list(pool.map(build.compile_source, names))
    for name, (seconds, report) in zip(names, results):
        lines = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        out["sources"][name] = {"nvcc_s": seconds, "ptxas": lines,
                                "spill_bytes": spill_bytes(lines),
                                "entries": ptxas_entries(report)}
    out["wall_s"] = time.perf_counter() - t0
    for name in ("ncc_score", "mma_probe"):
        if out["sources"][name]["spill_bytes"]:
            raise AssertionError(f"{name} spills registers: {out['sources'][name]}")
    # both legs of the NCC kernel were compiled: 3xTF32 in two patch layouts
    # and bf16
    legs = {e.get("layout") for e in out["sources"]["ncc_score"]["entries"]}
    want = {"float", "split", "bf16"}
    if not want <= legs:
        raise AssertionError(f"ncc_score: instantiations {sorted(legs, key=str)}, expected "
                             f"{sorted(want)}")
    return out


def main_shape_inputs(pb: int, device: str = "cuda", g: int = 300, c: int = 176, seed: int = 0):
    """Main-path operands on the card: a random G=300 gallery (bench.py's
    recipe) and PB probes cut from gallery prints with noise, so every probe
    has a true match."""
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.ops.ncc_direct import (
        PackedVariants, VariantLayout, build_direct_cache)
    from shoeprint_image_retrieval_torch.retrieval.engine import (
        batch_windows, build_kernels, variant_classes, variant_plan)

    rng = np.random.default_rng(seed)
    g_sizes = rng.integers(38, 47, size=(g, 2)).astype(np.int32)
    g_sizes = g_sizes[np.argsort(-g_sizes[:, 0], kind="stable")]
    gal = np.zeros((g, c, 46, 46), np.float32)
    for i, (h, w) in enumerate(g_sizes):
        gal[i, :, :h, :w] = rng.normal(size=(c, h, w))
    q_sizes = rng.integers(28, 37, size=(pb, 2)).astype(np.int32)
    truth = rng.integers(0, g, size=pb)
    qmaps = np.zeros((pb, c, 36, 36), np.float32)
    for i, (h, w) in enumerate(q_sizes):
        gh, gw = g_sizes[truth[i]]
        hh, ww = min(h, gh), min(w, gw)
        q_sizes[i] = (hh, ww)
        y0, x0 = rng.integers(0, gh - hh + 1), rng.integers(0, gw - ww + 1)
        qmaps[i, :, :hh, :ww] = (gal[truth[i], :, y0 : y0 + hh, x0 : x0 + ww]
                                 + 0.5 * rng.normal(size=(c, hh, ww)))

    dev = torch.device(device)
    cache = build_direct_cache(torch.from_numpy(gal).to(dev), torch.from_numpy(g_sizes).to(dev))
    plan = variant_plan(q_sizes, (36, 36), ROTATIONS, SCALES)
    include, counts = variant_classes("reference", plan.n_rot, plan.n_scl)
    kernel_hw = (plan.template_canvas[0] - 4, plan.template_canvas[1] - 4)
    t = [torch.from_numpy(np.asarray(a)).to(dev) for a in
         (qmaps, q_sizes, plan.rot_idx, plan.rot_ok, plan.wv, plan.wh, plan.scale_hw)]
    kernels = build_kernels(*t, kernel_hw=kernel_hw, include_rots_unscaled=include,
                            n_scl=plan.n_scl)
    wins, uniq, inv = batch_windows(q_sizes, plan.scale_hw, plan.n_scl)
    packed = PackedVariants(kernels, torch.from_numpy(wins).to(dev))
    layout = VariantLayout(counts, pb)
    slots = (torch.from_numpy(uniq).to(dev), torch.from_numpy(inv).to(dev))
    row_truth = truth[np.concatenate([np.repeat(np.arange(pb), n) for n in counts])]
    return cache, packed, layout, slots, row_truth, c


def true_match_ranks(scores, row_truth):
    import numpy as np

    order = np.argsort(-scores, axis=1, kind="stable")
    return np.argmax(order == row_truth[:, None], axis=1) + 1


def edge_cases(device: str = "cuda") -> float:
    """Kernel vs plain on the card at small shapes with the degenerate
    inputs; returns the max abs difference."""
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.ops.ncc_direct import (
        PackedVariants, VariantLayout, build_direct_cache, fold_template, score_direct)
    from shoeprint_image_retrieval_torch.ops.ncc_kernel import score_ncc

    dev = torch.device(device)
    rng = np.random.default_rng(1)
    c = 3
    gal = np.zeros((4, c, 16, 16), np.float32)
    gal[0] = rng.normal(size=(c, 16, 16))                 # ordinary print
    gal[2, :, 9:, :] = rng.normal(size=(c, 7, 16))         # flat top: zero-energy windows
    gal[3, :, :10, :9] = rng.normal(size=(c, 10, 9))       # small print
    g_valid = np.asarray([[16, 16], [16, 16], [16, 16], [10, 9]], np.int32)  # print 1 flat
    cache = build_direct_cache(torch.from_numpy(gal).to(dev), torch.from_numpy(g_valid).to(dev))
    marks = np.zeros((3, c, 24, 24), np.float32)
    m_valid = np.asarray([[9, 9], [9, 9], [24, 24]], np.int32)
    marks[1, :, :9, :9] = rng.normal(size=(c, 9, 9))
    marks[1, 0] = 0.0                                      # one zero template channel
    marks[2] = rng.normal(size=(c, 24, 24))                # template larger than every print
    kernels = fold_template(torch.from_numpy(marks).to(dev), torch.from_numpy(m_valid).to(dev),
                            (20, 20))
    packed = PackedVariants(kernels, torch.from_numpy(m_valid - 4).to(dev))
    layout = VariantLayout((1,), 3)
    got = score_ncc(cache, packed, layout, c)
    want = score_direct(cache, packed, layout, c)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise AssertionError(f"edge cases: non-finite scores\n{got}\n{want}")
    if not (np.all(got[0] == 0.0) and np.all(got[:, 1] == 0.0)):
        raise AssertionError(f"edge cases: zero template / flat print must score 0\n{got}")
    err = float(np.abs(got - want).max())
    if err > TOL:
        raise AssertionError(f"edge cases: kernel vs plain max abs err {err}\n{got}\n{want}")
    return err


def float64_errors(cache, packed, layout, c, uniq, inv, got) -> dict:
    """Max |score - float64 score| over the first PRECISION_PRINTS prints
    for the kernel's ``got``, the plain version in FP32 and the plain
    version with cuDNN's TF32 convolutions (the precision 3xTF32 must beat)."""
    import torch

    from shoeprint_image_retrieval_torch.ops.ncc_direct import (
        DirectGalleryCache, PackedVariants, score_direct)

    t0 = time.perf_counter()
    sub = DirectGalleryCache(*(t[:, :PRECISION_PRINTS] for t in cache[:3]),
                             cache.valid_hw[:PRECISION_PRINTS])
    exact = score_direct(DirectGalleryCache(*(t.double() for t in sub[:3]), sub.valid_hw),
                         PackedVariants(packed.kernels.double(), packed.window_hw),
                         layout, c, uniq, inv)
    plain = score_direct(sub, packed, layout, c, uniq, inv)
    tf32_was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = score_direct(sub, packed, layout, c, uniq, inv)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_was
    kernel = got[:, :PRECISION_PRINTS]
    errs = {name: float((s.double() - exact).abs().max())
            for name, s in (("kernel", kernel), ("plain_f32", plain), ("plain_tf32", tf32))}
    errs["prints"] = PRECISION_PRINTS
    errs["seconds"] = time.perf_counter() - t0
    return errs


def phase_kernel(build: dict, pb: int = PROBES, reps: int = REPS, device: str = "cuda",
                 g: int = 300, c: int = 176) -> dict:
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.benchmarks import kernel_probe
    from shoeprint_image_retrieval_torch.ops import ncc_kernel
    from shoeprint_image_retrieval_torch.ops.ncc_direct import row_slots, score_direct

    t0 = time.perf_counter()
    edge_err = edge_cases(device)
    cache, packed, layout, (uniq, inv), row_truth, c = main_shape_inputs(pb, device, g, c)
    launches0 = ncc_kernel.launch_ncc.launches
    got = ncc_kernel.score_ncc(cache, packed, layout, c, uniq, inv)
    # the plain version's one call, timed (it takes ~15 s: no repeats)
    held = []
    plain_ms = cuda_ms(lambda: held.append(score_direct(cache, packed, layout, c, uniq, inv)), 1,
                       warm=False)
    want = held.pop()
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    err = float(np.abs(got_np - want_np).max())
    if not np.isfinite(got_np).all() or err > TOL:
        raise AssertionError(f"kernel vs plain at the main-path shapes: max abs err {err}")
    rk, rp = true_match_ranks(got_np, row_truth), true_match_ranks(want_np, row_truth)
    if not np.array_equal(rk, rp):
        raise AssertionError(f"true-match ranks differ in {int((rk != rp).sum())} rows")
    # top-1 must agree wherever the plain top-2 gap exceeds twice the tolerance
    top2 = np.sort(want_np, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * TOL
    top1_same = np.argmax(got_np, axis=1)[clear] == np.argmax(want_np, axis=1)[clear]
    if not top1_same.all():
        raise AssertionError("top-1 prints differ on rows with a clear margin")
    err64 = float64_errors(cache, packed, layout, c, uniq, inv, got)
    if not err64["kernel"] < 0.5 * err64["plain_tf32"]:
        raise AssertionError(f"the kernel is not well inside plain TF32's error: {err64}")

    kernel_ms = cuda_ms(lambda: ncc_kernel.score_ncc(cache, packed, layout, c, uniq, inv), reps)
    # yardstick: one cuDNN convolution (TF32 off) computing the channel-summed
    # raw correlation on the same operands; the port never calls it
    hk, wk = packed.kernels.shape[-2:]
    library_ms = kernel_probe.library_ms({"cache": cache, "packed": packed, "channels": c,
                                          "kernel_hw": (int(hk), int(wk))}, torch.device(device))

    # the least time the card could take: the correlation's needed
    # multiply-adds at the route's peak (3xTF32; FP32 on the CUDA cores
    # beside it), against every input of score_ncc read once and the output
    # written once at the memory rate
    slots, row_slot = row_slots(packed, layout, uniq, inv)
    row_hw = slots[row_slot].cpu().numpy()
    gvalid = cache.valid_hw.cpu().numpy()
    flops = ncc_kernel.needed_flop(row_hw, gvalid, c, tuple(cache.p0.shape[2:]))
    tile = ncc_kernel.kernel_tile()
    rows = ncc_kernel.row_plan(row_hw, (int(hk), int(wk)), tile.rows)
    prints = ncc_kernel.print_plan(gvalid, tile.positions)
    # a count from the host model of the blocks the plan launches
    executed = ncc_kernel.executed_flop(rows, gvalid, c, (int(hk), int(wk)), tile)
    inputs = (cache.p0, cache.int1, cache.int2, cache.valid_hw, packed.kernels, uniq, inv)
    in_bytes = sum(t.numel() * t.element_size() for t in inputs)
    out_bytes = got.numel() * got.element_size()
    bound = kernel_probe.bound(flops, in_bytes + out_bytes)
    n, g = got.shape
    geometry = ncc_kernel.launch_geometry(cache.p0.shape[3], int(hk), int(wk), rows, prints)
    return {
        "phase": "kernel", "probes": pb, "rows": n, "prints": g, "channels": c,
        "kernel_hw": [int(hk), int(wk)], "geometry": geometry,
        "design": ncc_design(build, geometry),
        "tiles": len(rows.taps), "position_blocks_per_print": prints.n_chunks,
        "max_abs_err": err, "edge_case_max_abs_err": edge_err, "err_vs_float64": err64,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **bound,
        "bound_fp32_ms": kernel_probe.bound(flops, in_bytes + out_bytes, "f32")["bound_ms"],
        "needed_flop": flops, "executed_flop": executed, "bytes": in_bytes + out_bytes,
        "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "bound_share": bound["bound_ms"] / kernel_ms,
        "fixture_c0": fixture_c0_call(build, device),
        "comparison_launches": ncc_kernel.launch_ncc.launches - launches0,
        "wall_s": time.perf_counter() - t0,
    }


def fixture_c0_call(build: dict, device: str = "cuda") -> dict:
    """The fixture's cluster-0 call built synthetically
    (``kernel_probe.case_inputs("fixture_c0")``: C = 80, 120 prints on 84 x
    68 cropped maps, 375 rows on a 47 x 39 kernel canvas) against the plain
    scorer (within TOL, true-match ranks identical), timed beside its bound
    and one ``F.conv2d``, with its launch geometry and design."""
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.benchmarks import kernel_probe

    dev = torch.device(device)
    inputs = kernel_probe.case_inputs("fixture_c0", dev)
    call = kernel_probe.probe_call(inputs, dev, library=True, plain=True, keep=True)
    got, want = call.pop("out").cpu().numpy(), call.pop("plain_out").cpu().numpy()
    if not np.isfinite(got).all() or call["max_abs_err"] > TOL:
        raise AssertionError(f"kernel vs plain at fixture_c0: max abs err {call['max_abs_err']}")
    rk = true_match_ranks(got, inputs["row_truth"])
    rp = true_match_ranks(want, inputs["row_truth"])
    if not np.array_equal(rk, rp):
        raise AssertionError(f"fixture_c0: true-match ranks differ in {int((rk != rp).sum())} rows")
    # the split pairs fit shared memory once at this shape: the float patch, twice
    geometry = (call["geometry"]["patch"], call["geometry"]["patch_buffers"])
    if geometry != ("float", 2):
        raise AssertionError(f"fixture_c0: launch geometry {geometry}, not the float patch twice")
    return {"case": "fixture_c0", **call, "design": ncc_design(build, call["geometry"])}


def run_pipeline(config: dict, backend: str, device: str = "cuda", mesh_devices=None, **tpu):
    """One run of the fixture through ``Pipeline.run``, with ``[tpu]``
    overrides and the ``Pipeline``'s ``mesh_devices``; -> (outputs,
    S-lines, what the run took)."""
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.metrics import cmp, s_line
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    cfg = copy.deepcopy(config)
    cfg["tpu"]["ncc_backend"] = backend
    cfg["tpu"].update(tpu)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = Pipeline(cfg, weights_dir=None, verbose=False, device=device,
                    mesh_devices=mesh_devices)
    outs, score_s = [], []
    for out in pipe.run():
        outs.append(out)
        score_s.append(pipe.stage_seconds["score"] - sum(score_s))
    wall = time.perf_counter() - t0
    n_g, n_q = len(pipe.dataset.gallery_files), len(pipe.dataset.query_files)
    lines = []
    for out in outs:
        if out.scores.shape != (out.n_queries, n_g) or not np.isfinite(out.scores).all():
            raise AssertionError(f"{backend} {tpu}: bad scores {out.scores.shape}")
        if out.ranks.min() < 1 or out.ranks.max() > n_g:
            raise AssertionError(f"{backend} {tpu}: ranks out of range")
        lines.append(s_line({p: cmp(out.ranks.tolist(), p, n_g, n_q) * 100
                             for p in (1, 5, 10, 15, 20)}))
    # one gallery block a cluster (or tpu.gallery_block's count), each
    # fusion block apart
    gb = int(cfg["tpu"]["gallery_block"])
    blocks = (-(-n_g // gb) if gb else 1) * max(1, len(cfg["tpu"]["fusion_blocks"]))
    if pipe.gallery_blocks_scored != len(outs) * blocks:
        raise AssertionError(f"{backend} {tpu}: {pipe.gallery_blocks_scored} gallery blocks "
                             f"for {len(outs)} clusters")
    return outs, lines, {
        "backend": backend, "tpu": tpu, "wall_s": wall, "stages_s": pipe.stage_seconds,
        "lookahead_s": pipe.lookahead_seconds, "score_s_per_cluster": score_s,
        "ingest_tiers": dict(pipe.ingest_tiers), "clahe": dict(pipe.clahe_routes),
        "conv_routes": dict(pipe.conv_routes),
        "gallery_blocks": pipe.gallery_blocks_scored, "cache_bytes": pipe.cache_bytes,
        "probe_batches": pipe.probe_batches, "mesh_runs": dict(pipe.mesh_runs),
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }


def _merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


def trace_summary(events: list[dict], top: int = 5, gaps: int = 3) -> dict:
    """What one Chrome trace (``torch.profiler``'s ``traceEvents``) says of
    the device over the trace's window (first to last timed event): its busy
    and idle share (the union of kernel, copy and set intervals against the
    window), the ``top`` device ops with the most total time, and the
    ``gaps`` longest idle gaps, each with the innermost host op that spans
    it (else the host op that overlaps it most). A gap's host ops are those
    of the thread that launched the device work that ends it (the last
    before it, for a gap at the window's end), found by the launch's
    ``correlation``; all threads' where the trace links no launch. Times in
    ms."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not timed:
        raise ValueError("the trace holds no timed events")
    span = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in timed]
    w0, w1 = min(s for s, _ in span), max(e for _, e in span)
    dev = [e for e in timed if e.get("cat") in DEVICE_CATS]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""),
             (e.get("pid"), e.get("tid"))) for e in timed if e.get("cat") in HOST_CATS]
    launcher = {e["args"]["correlation"]: (e.get("pid"), e.get("tid"))
                for e in timed if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    busy = _merged((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy_us = sum(hi - lo for lo, hi in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)

    def issuer(lo: float, hi: float):
        after = [e for e in dev if float(e["ts"]) == hi]
        before = [e for e in dev if float(e["ts"]) + float(e["dur"]) == lo]
        for e in after + before:
            thread = launcher.get(e.get("args", {}).get("correlation"))
            if thread is not None:
                return thread
        return None

    def spanning(lo: float, hi: float) -> str | None:
        thread = issuer(lo, hi)
        ops = [h for h in host if thread is None or h[3] == thread]
        inside = [h for h in ops if h[0] <= lo and h[1] >= hi]
        if inside:
            return min(inside, key=lambda h: h[1] - h[0])[2]
        overlap = [(min(h[1], hi) - max(h[0], lo), h[2]) for h in ops]
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


def summarize_traces(trace_dir: Path) -> dict:
    """:func:`trace_summary` of every ``cluster{i}.json`` under ``trace_dir``."""
    out = {}
    for path in sorted(trace_dir.glob("cluster*.json")):
        doc = json.loads(path.read_text())
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        out[path.stem] = {"trace_bytes": path.stat().st_size, **trace_summary(events)}
    return out


def fixture_config(dataset: Path) -> dict:
    """``benchmarks/synthetic_impress.toml`` pointed at ``dataset``, without
    the on-disk gallery cache, on one device (the file's ``mesh_shape = 0``
    would take every visible card): only ``phase_sharded`` sets a mesh."""
    from shoeprint_image_retrieval_torch.config import load_config

    config = load_config(Path(__file__).resolve().parent / "benchmarks" / "synthetic_impress.toml")
    config["dataset"]["dir"] = str(dataset)
    config["tpu"]["cache_dir"] = ""
    config["tpu"]["mesh_shape"] = 1
    return config


def phase_main_path(tmp: Path, device: str = "cuda", gallery: int = 120,
                    queries: int = 30) -> tuple[dict, int, tuple, tuple]:
    """Plain, kernel, kernel, plain, so that neither backend always pays the
    first run's warm-up; then the kernel with CLAHE on the card, with a
    trace, and without the cluster lookahead. Returns the phase's line, the
    kernel's launches and the first plain and kernel runs (outputs,
    S-lines, info)."""
    import numpy as np

    from scripts.make_synthetic_impress import generate
    from shoeprint_image_retrieval_torch.ops import ncc_kernel

    t0 = time.perf_counter()
    generate(tmp / "Dataset", gallery=gallery, queries=queries)
    gen_s = time.perf_counter() - t0
    config = fixture_config(tmp / "Dataset")
    trace_dir = tmp / "traces"

    runs = [run_pipeline(config, "direct", device)]
    ncc_kernel.launch_ncc.launches = 0
    runs.append(run_pipeline(config, "auto", device))
    launches = ncc_kernel.launch_ncc.launches
    if launches < 1:
        raise AssertionError("the main path did not launch the NCC kernel")
    runs += [run_pipeline(config, "auto", device), run_pipeline(config, "direct", device),
             run_pipeline(config, "auto", device, clahe_host=False),
             run_pipeline(config, "auto", device, profile_dir=str(trace_dir)),
             run_pipeline(config, "auto", device, pipeline_clusters=False)]
    p_outs, p_lines, _ = runs[0]
    k_outs = runs[1][0]
    max_err, kernel_err = 0.0, {}
    for i, (outs, lines, info) in enumerate(runs):
        name = f"run {i} {info['backend']} {info['tpu']}"
        want_route = "device" if info["tpu"].get("clahe_host") is False else "host"
        if set(info["clahe"]) != {want_route}:
            raise AssertionError(f"{name}: CLAHE routes {info['clahe']}, expected {want_route}")
        if len(outs) != len(p_outs):
            raise AssertionError(f"{name}: planned different clusters")
        for o, p, k in zip(outs, p_outs, k_outs):
            if not np.array_equal(o.ranks, p.ranks):
                raise AssertionError(f"ranks differ: {name} {o.ranks} plain {p.ranks}")
            max_err = max(max_err, float(np.abs(o.scores - p.scores).max()))
            if info["backend"] == "auto":
                kernel_err[i] = max(kernel_err.get(i, 0.0), float(np.abs(o.scores - k.scores).max()))
        if lines != p_lines:
            raise AssertionError(f"S-lines differ: {name} {lines} vs plain {p_lines}")
    if any(kernel_err.values()):
        raise AssertionError(f"kernel runs differ from the first kernel run: {kernel_err}")
    traces = summarize_traces(trace_dir)
    if len(traces) != len(p_outs) or (device == "cuda" and not all(
            t["device_events"] for t in traces.values())):
        raise AssertionError(f"the profiled run's traces hold no device events: {traces}")
    return {
        "phase": "main_path", "dataset_gen_s": gen_s, "wall_s": time.perf_counter() - t0,
        "clusters": [{"queries": o.n_queries, "block": o.block, "scale": o.scale,
                      "ranks": o.ranks.tolist()} for o in p_outs],
        "s_lines": p_lines, "kernel_launches": launches,
        "runs": [info for _, _, info in runs],
        "scores_max_abs_diff": max_err,
        "kernel_runs_max_abs_diff_vs_run_1": kernel_err,
        "traces": traces,
    }, launches, runs[0], runs[1]


def phase_summed_maps(dataset: Path, device: str = "cuda", reps: int = REPS) -> dict:
    """The visualisation script's path (``scripts/summed_feature_maps``) on
    the fixture's first query (``Query/{gid}_q0.jpg``) and its true print
    (``Gallery/{gid}_1.jpg``) at full resolution, full-width EfficientNetV2_M
    at block 6 from seeded init: the card's features against the CPU's, the
    card's per-channel maps and score against the CPU's on the card's
    features, and the score against the NCC kernel's score of the query's
    identity variant against the print (``engine_score``; launch counts
    reset just before it, read just after)."""
    import numpy as np
    import torch
    from PIL import Image

    from shoeprint_image_retrieval_torch.benchmarks import kernel_probe
    from shoeprint_image_retrieval_torch.models.weights import build_model
    from shoeprint_image_retrieval_torch.ops import ncc_kernel
    from shoeprint_image_retrieval_torch.ops.ncc import normxcorr_same
    from shoeprint_image_retrieval_torch.scripts import summed_feature_maps as sfm

    t0 = time.perf_counter()
    dev = torch.device(device)
    query = sorted((dataset / "Query").glob("*_q0.jpg"))[0]
    pair = {"query": query, "print": dataset / "Gallery" / f"{query.name.split('_q')[0]}_1.jpg"}
    imgs = {k: np.asarray(Image.open(path).convert("L")) for k, path in pair.items()}
    cpu = build_model(sfm.MODEL, sfm.BLOCK, None, "cpu")
    card = copy.deepcopy(cpu).to(dev)

    def extract(model, where):
        return [sfm.feature_maps(img, model, where, str(pair[k])) for k, img in imgs.items()]

    t1 = time.perf_counter()
    want = extract(cpu, "cpu")
    cpu_extract_s = time.perf_counter() - t1
    got = extract(card, dev)
    q, p = got
    feature_err = []
    for w, g in zip(want, got):
        scale = float(w.abs().max())
        err = float((g.cpu() - w).abs().max())
        if g.shape != w.shape or not torch.isfinite(g).all() or not 0 < scale \
                or err > SUMMED_MAPS_TOL["features"] * scale:
            raise AssertionError(f"summed_maps: card features {tuple(g.shape)} vs CPU "
                                 f"{tuple(w.shape)}: max abs err {err} (scale {scale})")
        feature_err.append({"max_abs_err": err, "scale": scale})
    corr, summed, score = sfm.channel_maps(q, p)
    corr_h, summed_h, score_h = sfm.channel_maps(q.cpu(), p.cpu())
    map_err = float((corr.cpu() - corr_h).abs().max())
    if not (np.isfinite(score) and torch.isfinite(corr).all()
            and abs(score - score_h) <= SUMMED_MAPS_TOL["score"]
            and map_err <= SUMMED_MAPS_TOL["maps"]):
        raise AssertionError(f"summed_maps: card maps vs CPU maps: score {score} vs {score_h}, "
                             f"max abs err per channel map {map_err}")
    ncc_kernel.launch_ncc.launches = 0
    kernel_score = sfm.engine_score(q, p)
    launches = ncc_kernel.launch_ncc.launches
    if dev.type == "cuda" and launches != 1:
        raise AssertionError(f"summed_maps: the identity-variant check launched the NCC kernel "
                             f"{launches} times, expected once")
    if abs(kernel_score - score) > TOL:
        raise AssertionError(f"summed_maps: score {score} vs the NCC kernel's identity-variant "
                             f"score {kernel_score}")
    timed = dev.type == "cuda"
    kernel_call = None
    if timed:  # the kernel's N = 1, G = 1 call alone, beside its bound and one F.conv2d
        cache, packed, layout = sfm.engine_operands(q, p)
        window = packed.window_hw
        call = kernel_probe.probe_call(
            {"cache": cache, "packed": packed, "layout": layout, "channels": q.shape[0],
             "kernel_hw": tuple(q.shape[-2:]), "row_hw": window.cpu().numpy(),
             "slots": (window, torch.zeros(1, dtype=torch.int64, device=dev))},
            dev, library=True, plain=True)
        kernel_call = {k: call[k] for k in ("rows", "prints", "channels", "canvas", "kernel_hw",
                                            "ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by", "max_abs_err", "geometry")}
    return {
        "phase": "summed_maps", "query": query.name, "print": pair["print"].name,
        "image_hw": {k: list(img.shape) for k, img in imgs.items()},
        "maps_chw": {"query": list(q.shape), "print": list(p.shape)},
        "score": score, "score_cpu": score_h, "kernel_score": kernel_score,
        "kernel_launches": launches,
        "score_max_abs_diff_vs_cpu": abs(score - score_h),
        "maps_max_abs_diff_vs_cpu": map_err,
        "score_max_abs_diff_vs_kernel": abs(score - kernel_score),
        "summed_max_abs_diff_vs_cpu": float((summed.cpu() - summed_h).abs().max()),
        "features_vs_cpu": feature_err,
        # CUDA events: both images' extraction as the script runs it, the
        # batched per-channel maps, the JAX script's loop of one call a
        # channel, and the engine's packing plus the kernel's N = 1, G = 1 call
        "extract_ms": cuda_ms(lambda: extract(card, dev), reps) if timed else None,
        "maps_ms": cuda_ms(lambda: sfm.channel_maps(q, p), reps) if timed else None,
        "maps_loop_ms": cuda_ms(lambda: [normxcorr_same(q[c], p[c]) for c in range(len(q))],
                                reps) if timed else None,
        "engine_score_ms": cuda_ms(lambda: sfm.engine_score(q, p), reps) if timed else None,
        "kernel_call": kernel_call,
        "cpu_extract_s": cpu_extract_s,
        "tol": SUMMED_MAPS_TOL | {"kernel": TOL},
        "wall_s": time.perf_counter() - t0,
    }


def held_runs(name: str, got: tuple, want: tuple, tol: float) -> float:
    """Ranks and S-lines of two fixture runs identical, scores within
    ``tol``; -> the max |Δ| of the scores."""
    import numpy as np

    (g_outs, g_lines, _), (w_outs, w_lines, _) = got, want
    if len(g_outs) != len(w_outs):
        raise AssertionError(f"{name}: planned different clusters")
    err = 0.0
    for g, w in zip(g_outs, w_outs):
        if not np.array_equal(g.ranks, w.ranks):
            raise AssertionError(f"{name}: ranks differ {g.ranks} vs {w.ranks}")
        err = max(err, float(np.abs(g.scores - w.scores).max()))
    if g_lines != w_lines:
        raise AssertionError(f"{name}: S-lines differ {g_lines} vs {w_lines}")
    if err > tol:
        raise AssertionError(f"{name}: scores differ by {err} > {tol}")
    return err


def phase_fft(dataset: Path, plain: tuple, kernel_score_s: list[float],
              device: str = "cuda") -> tuple[dict, tuple]:
    """The fixture's main-path config with ``ncc_backend = "fft"``: ranks and
    S-lines against ``main_path``'s plain run. -> (the line, the run)."""
    t0 = time.perf_counter()
    run = run_pipeline(fixture_config(dataset), "fft", device)
    err = held_runs("fft vs plain", run, plain, TOL)
    info = run[2]
    return {"phase": "fft", "clusters": len(run[0]), "s_lines": run[1],
            "scores_max_abs_diff_vs_plain": err, "run": info,
            "score_s": info["stages_s"]["score"], "kernel_runs_score_s": kernel_score_s,
            "cache_bytes_per_block": info["cache_bytes"],
            "wall_s": time.perf_counter() - t0}, run


@contextlib.contextmanager
def timed_launches(library: bool = False):
    """Time every NCC kernel call the engine makes inside the block: CUDA
    events around the ``score_ncc`` that the engine's scorer
    (``parallel/sharded.make_sharded_packed_scorer``) calls (which, with
    the engine's tile plan, only launches the kernel; the kernel's launch
    count is untouched).
    Yields a list that holds, after the block, one record a call: C, rows,
    prints, canvas, ms and the bound by ``phase_kernel``'s formula; with
    ``library``, also one ``F.conv2d`` of each call's operands, timed after
    the block (the operands are kept until then)."""
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.benchmarks.kernel_probe import bound, library_ms
    from shoeprint_image_retrieval_torch.ops.ncc_kernel import needed_flop
    from shoeprint_image_retrieval_torch.parallel import sharded

    real = sharded.score_ncc
    pending, records = [], []

    def timed(cache, packed, layout, true_channels, slot_hw=None, slot_map=None, plan=None,
              compute_dtype=torch.float32):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(cache, packed, layout, true_channels, slot_hw, slot_map, plan=plan,
                   compute_dtype=compute_dtype)
        end.record()
        moved = sum(t.numel() * t.element_size() for t in (*cache, packed.kernels,
                                                            plan[0].table, out))
        operands = ({"cache": cache, "packed": packed, "channels": packed.kernels.shape[1],
                     "kernel_hw": tuple(packed.kernels.shape[2:])} if library else None)
        pending.append((start, end, tuple(packed.kernels.shape), tuple(cache.p0.shape),
                        cache.valid_hw.clone(), plan[0], moved, operands))
        return out

    sharded.score_ncc = timed
    try:
        yield records
    finally:
        sharded.score_ncc = real
        torch.cuda.synchronize()
        for start, end, (n, c, hk, wk), (_, g, hb, wb), gvalid, rows, moved, operands in pending:
            row_hw = rows.windows[np.arange(n) // rows.m_tile, rows.slots]
            flops = needed_flop(row_hw, gvalid.cpu().numpy(), c, (hb, wb))
            least = bound(flops, moved)
            ms = start.elapsed_time(end)
            records.append({"channels": c, "rows": n, "prints": g, "canvas": [hb, wb],
                            "kernel_hw": [hk, wk], "ms": ms, **least,
                            "needed_flop": flops, "bytes": moved,
                            "bound_share": least["bound_ms"] / ms,
                            "library_ms": None if operands is None else library_ms(
                                operands, torch.device("cuda"))})


def phase_families(dataset: Path, device: str = "cuda", families=FAMILIES) -> dict:
    """VGG16, DenseNet_201 and EfficientNet_B7 through the fixture, plain then
    kernel: the NCC kernel at the channel counts these backbones give."""
    from shoeprint_image_retrieval_torch.ops import ncc_kernel

    t0 = time.perf_counter()
    base = fixture_config(dataset)
    launch = ncc_kernel.launch_ncc
    out = {"phase": "families", "models": {}}
    for model, start, end, skip in families:
        t1 = time.perf_counter()
        cfg = copy.deepcopy(base)
        cfg["model"].update(type=model, start_block=start, end_block=end, skip_blocks=skip)
        plain = run_pipeline(cfg, "direct", device)
        launch.launches = 0
        with timed_launches(library=True) as calls:
            kernel = run_pipeline(cfg, "auto", device)
        launches = launch.launches
        if launches < 1:
            raise AssertionError(f"{model}: the fixture's run did not launch the NCC kernel")
        err = held_runs(f"{model} kernel vs plain", kernel, plain, TOL)
        out["models"][model] = {
            "blocks": [start, end, skip],
            "clusters": [{"queries": o.n_queries, "block": o.block, "scale": o.scale,
                          "ranks": o.ranks.tolist()} for o in plain[0]],
            "s_lines": plain[1], "kernel_launches": launches, "scores_max_abs_diff": err,
            "plain": plain[2], "kernel": kernel[2], "ncc_calls": calls,
            "wall_s": time.perf_counter() - t1,
        }
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_sizing(device: str = "cuda") -> dict:
    """What one scoring call is made of on the card: the NCC kernel alone
    over a sweep of probe batches and in each patch layout
    (``benchmarks/kernel_probe``), the
    per-batch variant build (``bench_build``), the per-block cache build
    (``bench_cachebuild``), the engine on maps left on the host
    (``bench.run(host_maps=True)``, in f32 and at rest in bf16), and the
    sizing the engine picks for ``probe_batch = 0`` at G = 300 and at
    G = 10,240 with the equal-block split there."""
    import torch

    from shoeprint_image_retrieval_torch import bench
    from shoeprint_image_retrieval_torch.benchmarks import bench_build, bench_cachebuild, kernel_probe
    from shoeprint_image_retrieval_torch.device import free_bytes
    from shoeprint_image_retrieval_torch.ops import ncc_kernel
    from shoeprint_image_retrieval_torch.retrieval.engine import variant_classes, variant_plan

    t0 = time.perf_counter()
    dev = torch.device(device)
    out = {"phase": "sizing", "kernel_probe": kernel_probe.run(SIZING_PBS, device=device),
           "bench_build": bench_build.run(device=device),
           "bench_cachebuild": bench_cachebuild.run(device=device),
           "engine_host_maps": bench.run(device=device, q=PROBES, kernel=False, host_maps=True),
           "engine_host_maps_cache_bf16": bench.run(device=device, q=PROBES, kernel=False,
                                                    host_maps=True, cache_bf16=True)}
    # probe_batch = 0 on this card, for a cluster of AUTO_PROBES probes
    w = bench.make_workload(q=1)
    c, hraw, hc = w["gal"].shape[1], w["gal"].shape[-1], w["canvas"]
    plan = variant_plan(w["q_sizes"], (hc, hc), bench.ROTATIONS, bench.SCALES)
    n_var = sum(variant_classes("reference", plan.n_rot, plan.n_scl)[1])
    tile = ncc_kernel.kernel_tile()
    auto = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sizing_") as tmp:
        pipe = bench.engine_pipeline(Path(tmp), 0, dev)
        for g in (300, G_10K):
            pb, gb = pipe._probe_batch_and_block(AUTO_PROBES, g, c, (hc, hc), (hraw, hraw), plan,
                                                 n_var, tile.rows)
            kernel_hw = (plan.template_canvas[0] - 4, plan.template_canvas[1] - 4)
            per_print = ncc_kernel.gallery_block_bytes_per_print(c, hraw, hraw, pb * n_var)
            stack = pb * n_var * c * kernel_hw[0] * kernel_hw[1] * 4
            unbalanced = ncc_kernel.auto_gallery_block(g, per_print, free_bytes(dev), stack, 1)
            auto[str(g)] = {"probes": AUTO_PROBES, "probe_batch": pb, "rows": pb * n_var,
                            "block": gb, "blocks": -(-g // gb),
                            "auto_block_before_split": unbalanced,
                            "tail_before_split": g - (-(-g // unbalanced) - 1) * unbalanced}
        pipe.close()
    out["auto"] = auto
    out["h100_probe_rows"] = ncc_kernel.H100_PROBE_ROWS
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_fusion(dataset: Path, device: str = "cuda") -> tuple[dict, int]:
    """The fixture with ``fusion_blocks = [6, 4]``, plain then kernel: ranks
    and S-lines identical, the kernel launched at both blocks' channels, the
    fused ranks equal to the ranks of the sum of the per-block
    ``_cluster_scores``; then ``benchmarks/bench_fusion`` and one block-4
    call at its shapes beside its bound and one ``F.conv2d``."""
    import numpy as np

    from shoeprint_image_retrieval_torch.benchmarks import bench_fusion
    from shoeprint_image_retrieval_torch.metrics import ranks_from_scores
    from shoeprint_image_retrieval_torch.ops import ncc_kernel
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    t0 = time.perf_counter()
    cfg = fixture_config(dataset)
    cfg["tpu"]["fusion_blocks"] = list(FUSION_BLOCKS)
    plain = run_pipeline(cfg, "direct", device)
    ncc_kernel.launch_ncc.launches = 0
    with timed_launches() as calls:
        kernel = run_pipeline(cfg, "auto", device)
    launches = ncc_kernel.launch_ncc.launches
    err = held_runs("fusion kernel vs plain", kernel, plain, TOL)
    channels = sorted({r["channels"] for r in calls})
    if launches < 1 or len(channels) != len(FUSION_BLOCKS):
        raise AssertionError(f"fusion: {launches} kernel launches at channels {channels}")
    # the fused ranks are the ranks of the sum of each block's matrix
    control_cfg = copy.deepcopy(cfg)
    control_cfg["tpu"].update(fusion_blocks=[], ncc_backend="auto")
    control = Pipeline(control_cfg, weights_dir=None, verbose=False, device=device)
    for out, plan in zip(kernel[0], control.plans):
        mats = [control._cluster_scores(dataclasses.replace(plan, block=fb))
                for fb in FUSION_BLOCKS]
        want = ranks_from_scores(sum(m[0] for m in mats),
                                 control.dataset.matching_pairs(mats[0][1]))
        if not np.array_equal(out.ranks, want):
            raise AssertionError(f"fusion: ranks {out.ranks} vs the summed blocks' {want}")
    control.close()
    with timed_launches(library=True) as bench_calls:
        bench = bench_fusion.run(q=FUSION_PROBES, device=device)
    c4 = bench_fusion.BLOCKS[1][1]
    block4 = [r for r in bench_calls if r["channels"] == c4 and r["prints"] == bench_fusion.G]
    if not block4:
        raise AssertionError(f"fusion: no block-4 call in bench_fusion's {bench_calls}")
    return {"phase": "fusion", "fusion_blocks": list(FUSION_BLOCKS),
            "clusters": [{"queries": o.n_queries, "block": o.block, "scale": o.scale,
                          "ranks": o.ranks.tolist()} for o in plain[0]],
            "s_lines": plain[1], "kernel_launches": launches, "kernel_channels": channels,
            "scores_max_abs_diff": err, "plain": plain[2], "kernel": kernel[2],
            "ncc_calls": calls, "bench_fusion": bench, "block4_calls": block4,
            "wall_s": time.perf_counter() - t0}, launches


def phase_pruned(device: str = "cuda") -> tuple[dict, int]:
    """``benchmarks/bench_pruned`` on both workloads through the kernel:
    ranks equal to the full path's, the spread of pass 0's true-match scores
    against the full path's, the kernel's launches in the pruned path alone
    (the count reset just before it and read just after, inside the bench)
    and in the full path. On ``planted`` each call of the pruned path is
    also made by the plain scorer on the same inputs (within ``TOL``, the
    plain path's ranks equal to the kernel's). Then pass 1's C = 22 call at
    the bench's shapes against the plain scorer (within ``TOL``), beside its
    bound and one ``F.conv2d``. -> (result, launches in the pruned paths)"""
    import torch

    from shoeprint_image_retrieval_torch.benchmarks import bench_pruned, kernel_probe
    from shoeprint_image_retrieval_torch.retrieval.pruned import channel_order

    t0 = time.perf_counter()
    dev = torch.device(device)
    workloads = bench_pruned.make_workloads()
    runs = {kind: bench_pruned.run(w, device=device, plain_check=kind == "planted")
            for kind, w in workloads.items()}
    launches = sum(r["launches_pruned"] for r in runs.values())
    if min(r["launches_pruned"] for r in runs.values()) < 1:
        raise AssertionError(f"pruned: the kernel was not launched in a pruned path: {runs}")
    check = runs["planted"]["plain_check"]
    if check["max_abs_diff"] > TOL:
        raise AssertionError(f"pruned: kernel vs plain max abs err {check['max_abs_diff']} "
                             f"> {TOL}: {check['calls']}")
    w = workloads["random"]
    ck = channel_order(w["gal"])[: runs["random"]["k"]]
    pb = bench_pruned.PB
    pass1 = kernel_probe.probe_call(
        kernel_probe.stack_inputs(w["gal"][:, ck], w["g_sizes"], w["qmaps"][:pb, ck],
                                  w["q_sizes"][:pb], dev), dev, library=True, warm=False,
        plain=True)
    if pass1["max_abs_err"] > TOL:
        raise AssertionError(f"pruned: pass 1's call, kernel vs plain max abs err "
                             f"{pass1['max_abs_err']} > {TOL}")
    return {"phase": "pruned", "runs": runs, "kernel_launches": launches, "pass1_call": pass1,
            "wall_s": time.perf_counter() - t0}, launches


def phase_backbones(device: str = "cuda", names=None, canvas=BACKBONE_CANVAS,
                    valid=BACKBONE_VALID, reps: int = REPS) -> dict:
    """Every model string at full depth and width from seeded init: the card
    against the same module and weights on the CPU, valid sizes against
    ``summary.output_size``."""
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.models.registry import REGISTRY, get_backbone
    from shoeprint_image_retrieval_torch.models.summary import output_size
    from shoeprint_image_retrieval_torch.models.weights import seeded_init

    t0 = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    x = np.zeros((len(valid), 3, *canvas), np.float32)
    for i, (h, w) in enumerate(valid):
        x[i, :, :h, :w] = rng.normal(size=(3, h, w))
    x_cpu, v_cpu = torch.from_numpy(x), torch.tensor(valid, dtype=torch.int32)
    x_dev, v_dev = x_cpu.to(dev), v_cpu.to(dev)
    out = {"phase": "backbones", "canvas": list(canvas), "valid": [list(v) for v in valid],
           "models": {}}
    for name in names or REGISTRY:
        t1 = time.perf_counter()
        features = get_backbone(name).build(None)
        seeded_init(features, name)
        features.eval()
        with torch.inference_mode():
            want, want_v = features(x_cpu, v_cpu)
            features.to(dev)
            got, got_v = features(x_dev, v_dev)
            ms = cuda_ms(lambda: features(x_dev, v_dev), reps) if dev.type == "cuda" else None
        got, got_v = got.cpu(), got_v.cpu()
        sizes = [output_size(features, hw) for hw in valid]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or not 0 < scale or err > BACKBONE_TOL * scale:
            raise AssertionError(f"{name}: card vs CPU max abs err {err} (scale {scale})")
        if not (torch.equal(got_v, want_v)
                and [tuple(s[1:]) for s in sizes] == [tuple(v) for v in got_v.tolist()]
                and all(s[0] == got.shape[1] for s in sizes)):
            raise AssertionError(f"{name}: valid sizes {got_v.tolist()} / {want_v.tolist()} "
                                 f"against summary.output_size {sizes}")
        out["models"][name] = {
            "chw": list(sizes[0]), "chw_second": list(sizes[1]), "forward_ms": ms,
            "max_abs_err": err, "scale": scale,
            "params": sum(p.numel() for p in features.parameters()),
            "wall_s": time.perf_counter() - t1,
        }
        del features, got, want
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_front_end(dataset: Path, device: str = "cuda", reps: int = REPS) -> dict:
    """The device CLAHE against the native host CLAHE on the fixture's
    ingested images, and the streamed extraction against the batched one."""
    from collections import Counter

    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.data import native_ingest
    from shoeprint_image_retrieval_torch.data.loader import load_images, pack_canvas
    from shoeprint_image_retrieval_torch.metrics import ranks_from_scores
    from shoeprint_image_retrieval_torch.ops import clahe
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    t0 = time.perf_counter()
    dev = torch.device(device)
    pipe = Pipeline(fixture_config(dataset), weights_dir=None, verbose=False, device=device)
    ds, plan = pipe.dataset, pipe.plans[-1]
    crop, n_threads = pipe.config["dataset"]["crop"], pipe.config["dataset"]["n_processes"]
    clip = pipe.config["model"]["clahe_clip_limit"]
    grid = tuple(pipe.config["model"]["clahe_tile_grid_size"])
    tiers = Counter()
    g_imgs = load_images(ds.gallery_dir, ds.gallery_files, plan.scale, crop, n_threads, tiers)
    q_imgs = load_images(ds.query_dir, sorted(plan.files), plan.scale, crop, n_threads, tiers)
    out = {"phase": "front_end", "images": len(g_imgs) + len(q_imgs), "ingest_tiers": dict(tiers),
           "scale": plan.scale, "block": plan.block}

    def held(name: str, images, device_fn):
        """Device CLAHE of the packed images against the native one per
        image; the times of both."""
        batch, valid = pack_canvas(images)
        u8, v = torch.from_numpy(batch).to(dev), torch.from_numpy(valid).to(dev)
        got = device_fn(u8, v)
        if got.device.type != dev.type:
            raise AssertionError(f"{name}: device CLAHE ran on {got.device}")
        got = got.cpu().numpy()
        want = native_ingest.clahe_batch(images, clip, grid, n_threads)
        bad = sum(not np.array_equal(got[i, : w.shape[0], : w.shape[1]], w)
                  for i, w in enumerate(want))
        if bad:
            raise AssertionError(f"{name}: device CLAHE differs from the native one on {bad} images")
        native_ingest.clahe_batch(images, clip, grid, n_threads)
        t1 = time.perf_counter()
        for _ in range(reps):
            native_ingest.clahe_batch(images, clip, grid, n_threads)
        out[name] = {"images": len(images), "canvas": list(batch.shape[1:3]), "bit_exact": True,
                     "device_ms": cuda_ms(lambda: device_fn(u8, v), reps) if dev.type == "cuda"
                     else None,
                     "host_ms": (time.perf_counter() - t1) * 1e3 / reps}

    imgs = g_imgs + q_imgs
    held("gray", imgs, lambda u8, v: clahe.clahe_batched_dynamic(u8, v, clip, grid))
    rgb = [np.stack([im, np.roll(im, 17, axis=1), 255 - im], axis=-1) for im in imgs[:32]]
    held("rgb", rgb, pipe._device_clahe)

    # sizes below the tile grid, where the native CLAHE refuses: the card
    # against the same function on the CPU
    rng = np.random.default_rng(7)
    tiny_hw = rng.integers(1, 13, (64, 2)).astype(np.int32)
    tiny_hw[np.arange(64), rng.integers(0, 2, 64)] = rng.integers(1, min(grid), 64)
    tiny = np.zeros((64, 12, 12), np.uint8)
    for i, (h, w) in enumerate(tiny_hw):
        tiny[i, :h, :w] = rng.integers(0, 256, (h, w))
    on_dev = clahe.clahe_batched_dynamic(torch.from_numpy(tiny).to(dev),
                                         torch.from_numpy(tiny_hw).to(dev), clip, grid).cpu()
    on_cpu = clahe.clahe_batched_dynamic(torch.from_numpy(tiny), torch.from_numpy(tiny_hw), clip, grid)
    if not torch.equal(on_dev, on_cpu):
        raise AssertionError("device CLAHE below the tile grid differs from its CPU run")
    out["below_tile_grid"] = {"images": len(tiny), "bit_exact": True}

    # the gallery, streamed and batched
    model = pipe._model_for_block(plan.block)
    t1 = time.perf_counter()
    ms, vs = pipe._extract_streamed(model, ds.gallery_dir, ds.gallery_files, plan.scale, pipe._g_hdr)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stream_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    mb, vb = pipe._extract(model, pipe._host_clahe(g_imgs))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    batched_s = time.perf_counter() - t1
    if not np.array_equal(vs, vb):
        raise AssertionError("streamed and batched extraction give other valid sizes")
    identical = bool(torch.equal(ms, mb))
    delta = 0.0 if identical else float((ms - mb).abs().max())
    out["streamed_vs_batched"] = {"prints": len(vs), "maps_bit_identical": identical,
                                  "max_abs_diff": delta, "streamed_s": stream_s,
                                  "batched_s": batched_s}
    if not identical:
        q_maps, q_valid = pipe._extract(model, pipe._host_clahe(q_imgs))
        pairs = ds.matching_pairs(sorted(plan.files))
        ranks = [ranks_from_scores(pipe._score_cluster(q_maps, q_valid, m, v), pairs)
                 for m, v in ((ms, vs), (mb, vb))]
        if not np.array_equal(*ranks):
            raise AssertionError("streamed and batched gallery maps rank differently")
        out["streamed_vs_batched"]["ranks_identical"] = True
    pipe.close()
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_extract(device: str = "cuda") -> dict:
    from shoeprint_image_retrieval_torch.benchmarks import bench_extract

    t0 = time.perf_counter()
    return {"phase": "extract", **bench_extract.run(device=device),
            "wall_s": time.perf_counter() - t0}


def phase_parity(tmp: Path, device: str = "cuda", gallery: int = PARITY_GALLERY,
                 queries: int = PARITY_QUERIES) -> dict:
    """``run_parity`` on a small fixture; its exit status must be 0."""
    import contextlib
    import io

    from scripts.make_synthetic_impress import generate
    from shoeprint_image_retrieval_torch.retrieval.parity import run_parity

    t0 = time.perf_counter()
    generate(tmp / "Parity", gallery=gallery, queries=queries)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = run_parity(fixture_config(tmp / "Parity"), weights_dir=None, device=device)
    lines = [ln for ln in log.getvalue().splitlines()
             if ln.startswith(("cluster", "PARITY", "S1", "Pipeline", "Oracle"))]
    if rc != 0:
        raise AssertionError("parity: the pipeline's ranks differ from the oracle's:\n"
                             + "\n".join(lines))
    return {"phase": "parity", "prints": gallery, "queries": queries,
            "exit_status": rc, "report": lines,
            "wall_s": time.perf_counter() - t0}


def phase_bf16(dataset: Path, plain_f32: tuple, extract_f32: dict, build: dict,
               device: str = "cuda") -> tuple[dict, int]:
    """``tpu.precision`` and ``tpu.cache_dtype = "bfloat16"`` on the card.

    (a) One main-path call (PB = 56) through the NCC kernel's bf16 leg
    (``kernel_probe.probe_call``: its ms, bound at the bf16 rate, plain bf16
    call and one ``F.conv2d`` on the bf16 operands), held against the plain
    scorer on the same bf16 operands (within ``BF16_TOL``, true-match ranks
    identical) and further than ``BF16_TOL`` from the 3xTF32 leg's scores.
    (b) The fixture with ``precision = "bfloat16"``, plain then
    kernel, and once more with ``cache_dtype = "bfloat16"``,
    ``gallery_block`` = ``BF16_BLOCK`` and ``SIR_DEVICE_MAPS_MAX = 0``:
    kernel and plain ranks and S-lines identical (scores within
    ``BF16_TOL``), only the bf16 leg launched (counts reset just before
    each kernel run, read just after), every extraction on the bf16 conv
    route; the S-lines beside the f32 run's and the per-query ranks that
    moved. (c) The full-width
    EfficientNetV2_M at block 6 on one ``bench_extract`` batch in bf16
    against f32: nonzero and within ``BF16_FEATURE_TOL`` of the activation
    scale; ``bench_extract`` in bf16 beside ``extract``'s f32 rate.
    -> (result, the bf16 leg's launches in the fixture's kernel run)"""
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch.benchmarks import bench_extract, kernel_probe
    from shoeprint_image_retrieval_torch.models.layers import set_conv_precision
    from shoeprint_image_retrieval_torch.models.registry import get_backbone
    from shoeprint_image_retrieval_torch.models.weights import build_model
    from shoeprint_image_retrieval_torch.ops import ncc_kernel
    from shoeprint_image_retrieval_torch.ops.ncc_direct import row_slots
    from shoeprint_image_retrieval_torch.ops.preprocess import normalize_batch

    t0 = time.perf_counter()
    dev = torch.device(device)
    launch = ncc_kernel.launch_ncc

    def reset_counts():
        launch.launches = 0
        launch.leg_launches = dict.fromkeys(ncc_kernel.PRECISIONS, 0)

    # (a) the main-path call
    cache, packed, layout, slots, row_truth, c = main_shape_inputs(PROBES, device)
    slot_hw, row_slot = row_slots(packed, layout, *slots)
    inputs = {"cache": cache, "packed": packed, "layout": layout, "channels": c,
              "kernel_hw": tuple(int(v) for v in packed.kernels.shape[-2:]),
              "row_hw": slot_hw[row_slot].cpu().numpy(), "slots": slots}
    reset_counts()
    call = kernel_probe.probe_call(inputs, dev, library=True, plain=True, precision="bf16",
                                   keep=True)
    call["launches"] = dict(launch.leg_launches)
    call["design"] = ncc_design(build, call["geometry"])
    if call["launches"]["bf16"] < 1 or call["launches"]["f32_3xtf32"]:
        raise AssertionError(f"bf16: the main-path call launched {call['launches']}")
    got, want = call.pop("out"), call.pop("plain_out")
    err = call["max_abs_err"]
    if not bool(torch.isfinite(got).all()) or err > BF16_TOL:
        raise AssertionError(f"bf16 leg vs plain bf16 at the main-path shapes: max abs err {err}")
    got_np = got.cpu().numpy()
    rk, rp = true_match_ranks(got_np, row_truth), true_match_ranks(want.cpu().numpy(), row_truth)
    if not np.array_equal(rk, rp):
        raise AssertionError(f"bf16: true-match ranks differ in {int((rk != rp).sum())} rows")
    f32_leg = ncc_kernel.score_ncc(cache, packed, layout, c, *slots)
    vs_f32 = float((got - f32_leg).abs().max())
    if not vs_f32 > BF16_TOL:
        raise AssertionError(f"bf16: the leg's scores are within {vs_f32} of the 3xTF32 "
                             f"leg's (<= {BF16_TOL}): its operands were not rounded")
    rf = true_match_ranks(f32_leg.cpu().numpy(), row_truth)
    call.update(probes=PROBES, max_abs_diff_vs_3xtf32_leg=vs_f32,
                scale_3xtf32_leg=float(f32_leg.abs().max()),
                true_match_ranks_moved_vs_3xtf32_leg=int((rk != rf).sum()))
    del cache, packed, got, want, f32_leg, inputs

    # (b) the fixture end to end
    config = fixture_config(dataset)
    f32_outs, f32_lines, _ = plain_f32

    def moved_ranks(run):
        return sum(int((o.ranks != f.ranks).sum()) for o, f in zip(run[0], f32_outs))

    fixture = {}
    for name, tpu in (("precision", {"precision": "bfloat16"}),
                      ("cache_dtype", {"precision": "bfloat16", "cache_dtype": "bfloat16",
                                       "gallery_block": BF16_BLOCK})):
        budget = "0" if name == "cache_dtype" else str(int(2e9))
        with mock.patch.dict(os.environ, {"SIR_DEVICE_MAPS_MAX": budget}):
            plain = run_pipeline(config, "direct", device, **tpu)
            reset_counts()
            kernel = run_pipeline(config, "auto", device, **tpu)
            launches = dict(launch.leg_launches)
        if launches["bf16"] < 1 or launches["f32_3xtf32"]:
            raise AssertionError(f"bf16 fixture ({name}): kernel launches {launches}")
        for run in (plain, kernel):
            if set(run[2]["conv_routes"]) != {"bfloat16:bf16"}:
                raise AssertionError(f"bf16 fixture ({name}): conv routes "
                                     f"{run[2]['conv_routes']}")
        fixture[name] = {"runs": (plain, kernel), "launches": launches,
                         "scores_max_abs_diff": held_runs(f"bf16 fixture ({name}) kernel vs "
                                                          "plain", kernel, plain, BF16_TOL)}
    # the host maps were rounded: the scores moved against maps kept on the card
    at_rest = max(float(np.abs(a.scores - b.scores).max()) for a, b in zip(
        fixture["cache_dtype"]["runs"][1][0], fixture["precision"]["runs"][1][0]))
    if not at_rest > BF16_TOL:
        raise AssertionError(f"bf16 fixture: cache_dtype moved the scores by {at_rest} "
                             f"(<= {BF16_TOL}): the host maps were not rounded")

    # (c) extraction
    t1 = time.perf_counter()
    spec = get_backbone(bench_extract.MODEL)
    model = build_model(bench_extract.MODEL, 6, None, dev)
    u8, valid = bench_extract.make_batch(32, 704)
    u8d, vd = torch.from_numpy(u8).to(dev), torch.from_numpy(valid).to(dev)
    with torch.inference_mode():
        x = normalize_batch(u8d, vd, spec.mean, spec.std)
        f32_maps = model(x, vd)[0]
        set_conv_precision(model, "bfloat16")
        bf16_maps = model(x, vd)[0]
    feat_scale = float(f32_maps.abs().max())
    feat_err = float((bf16_maps - f32_maps).abs().max())
    if not 0.0 < feat_err <= BF16_FEATURE_TOL * feat_scale:
        raise AssertionError(f"bf16 features vs f32: max abs diff {feat_err} at scale "
                             f"{feat_scale} (must be nonzero and <= {BF16_FEATURE_TOL} of it)")
    del model, f32_maps, bf16_maps, x
    extraction = {"batch": 32, "canvas": 704, "block": 6, "max_abs_diff": feat_err,
                  "scale": feat_scale, "relative": feat_err / feat_scale,
                  "bench_extract_bf16": bench_extract.run(device=device, bf16=True),
                  "bench_extract_f32": {k: extract_f32[k] for k in
                                        ("device_clahe", "host_clahe", "backbone_ms")},
                  "wall_s": time.perf_counter() - t1}

    return {"phase": "bf16", "main_shape_call": call,
            "fixture": {name: {
                "s_lines": f["runs"][0][1], "s_lines_f32": f32_lines,
                "clusters": [{"block": o.block, "ranks": o.ranks.tolist()}
                             for o in f["runs"][0][0]],
                "per_query_ranks_moved_vs_f32": moved_ranks(f["runs"][1]),
                "kernel_launches": f["launches"],
                "scores_max_abs_diff": f["scores_max_abs_diff"],
                "plain": f["runs"][0][2], "kernel": f["runs"][1][2]}
                for name, f in fixture.items()},
            "cache_dtype_scores_max_abs_diff_vs_device_maps": at_rest,
            "extraction": extraction,
            "wall_s": time.perf_counter() - t0}, fixture["precision"]["launches"]["bf16"]


def phase_mxu_probe(device: str = "cuda") -> tuple[dict, int]:
    """The probe's measurement path, then every leg held against its plain
    version and timed beside it."""
    import torch

    from shoeprint_image_retrieval_torch.benchmarks import kernel_probe, mxu_probe
    from shoeprint_image_retrieval_torch.ops import mma_probe as mp

    t0 = time.perf_counter()
    dev = torch.device(device)
    mp.launch_mma.launches = 0
    path = mxu_probe.probe_kernel(device=device)
    launches = mp.launch_mma.launches
    if launches < 1:
        raise AssertionError("the probe path did not launch the probe kernel")
    legs = []
    for r in path:
        prec, n, k, lanes, y_iters, grid = (r[key] for key in
                                            ("precision", "n", "k", "lanes", "y_iters", "grid"))
        a, b = mxu_probe.probe_inputs(n, k, lanes, prec, dev)
        got = mp.launch_mma(a, b, y_iters, grid, prec)
        want = mp.probe_plain(a, b, y_iters, grid)
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        if not bool(torch.isfinite(got).all()) or rel_err > PROBE_TOL[prec]:
            raise AssertionError(f"probe {prec} {r['shape']}: relative err {rel_err} "
                                 f"> {PROBE_TOL[prec]}")
        plain_ms = cuda_ms(lambda: mp.probe_plain(a, b, y_iters, grid), REPS)
        # yardstick: y_iters cuBLAS products of the (grid, n, k) stack in the
        # leg's input dtype (TF32 off for f32); the port never calls it
        stack = a.expand(grid, n, k).contiguous()
        library_ms = cuda_ms(lambda: [torch.matmul(stack, b) for _ in range(y_iters)], REPS)
        del stack
        flop = mp.probe_flop(n, k, lanes, y_iters, grid)
        moved = a.numel() * a.element_size() + b.numel() * b.element_size() + got.numel() * 4
        least = kernel_probe.bound(flop, moved, prec)
        # what the kernel's TMA loads stream from L2 (a model of its tiles),
        # and the rate that implies at the measured time
        l2 = mp.l2_bytes(n, k, lanes, y_iters, grid, prec)
        legs.append({**r, "max_abs_err": abs_err, "max_rel_err": rel_err, "plain_ms": plain_ms,
                     "library_ms": library_ms, **least, "flop": flop, "bytes": moved,
                     "bound_share": least["bound_ms"] / r["ms"],
                     "l2_bytes": l2, "l2_tb_per_s": l2 / (r["ms"] * 1e-3) / 1e12,
                     **mp.launch_plan(n, k, lanes, y_iters, grid, prec)})
        del got, want
    matmul = mxu_probe.probe_matmul(device=device)
    return {"phase": "mxu_probe", "launches": launches, "geometry": mp.tile_geometry(),
            "legs": legs, "matmul_4096": matmul,
            "wall_s": time.perf_counter() - t0}, launches


def phase_bench(device: str = "cuda") -> dict:
    """The port's bench.py at full width, Q = PROBES."""
    from shoeprint_image_retrieval_torch import bench
    from shoeprint_image_retrieval_torch.ops import ncc_kernel

    t0 = time.perf_counter()
    ncc_kernel.launch_ncc.launches = 0
    result = bench.run(device=device, q=PROBES)
    return {"phase": "bench", **result, "ncc_launches": ncc_kernel.launch_ncc.launches,
            "wall_s": time.perf_counter() - t0}


def phase_gallery_blocks(device: str = "cuda") -> dict:
    """Pipeline._score_cluster on the bench workload with gallery_block 0
    and BLOCK, rank_on_device off and on: scores within BLOCK_TOL,
    identical ranks."""
    import numpy as np
    import torch

    from shoeprint_image_retrieval_torch import bench
    from shoeprint_image_retrieval_torch.device import free_bytes
    from shoeprint_image_retrieval_torch.metrics import ranks_from_scores
    from shoeprint_image_retrieval_torch.ops import ncc_kernel
    from shoeprint_image_retrieval_torch.retrieval.engine import DeviceScores

    t0 = time.perf_counter()
    dev = torch.device(device)
    w = bench.make_workload(q=PROBES)
    q_in = torch.from_numpy(bench.draw_probe_maps(w)).to(dev)
    g_in = torch.from_numpy(w["gal"]).to(dev)
    n_q, n_g = len(w["q_sizes"]), len(w["g_sizes"])
    runs, ref = [], None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_blocks_") as tmp:
        for i, (gb, rank_dev) in enumerate(((0, False), (BLOCK, False), (BLOCK, True),
                                            (0, True))):
            root = Path(tmp) / str(i)
            root.mkdir()
            pipe = bench.engine_pipeline(root, w["pb"], dev)
            pipe.config["tpu"]["gallery_block"] = gb
            pipe.config["tpu"]["rank_on_device"] = rank_dev
            t1 = time.perf_counter()
            scores = pipe._score_cluster(q_in, w["q_sizes"], g_in, w["g_sizes"])
            if rank_dev:
                if not isinstance(scores, DeviceScores):
                    raise AssertionError("rank_on_device did not keep the scores on the device")
                mat = scores.materialize()
            else:
                mat = scores
            seconds = time.perf_counter() - t1
            if ref is None:
                ref = mat
                # two sets of true columns: each row's best print and seeded random ones
                pairs = [np.argmax(ref, axis=1),
                         np.random.default_rng(5).integers(0, n_g, n_q)]
            rank_sets = [scores.ranks(p) if rank_dev else ranks_from_scores(mat, p)
                         for p in pairs]
            if i == 0:
                ref_ranks = rank_sets
            err = float(np.abs(mat - ref).max())
            if mat.shape != (n_q, n_g) or not np.isfinite(mat).all() or err > BLOCK_TOL:
                raise AssertionError(f"gallery_block={gb} rank_on_device={rank_dev}: "
                                     f"scores differ by {err}")
            for got, want in zip(rank_sets, ref_ranks):
                if not np.array_equal(got, want):
                    raise AssertionError(f"gallery_block={gb} rank_on_device={rank_dev}: "
                                         f"ranks differ")
            runs.append({"gallery_block": gb, "rank_on_device": rank_dev,
                         "blocks": pipe.gallery_blocks_scored, "score_s": seconds,
                         "max_abs_diff": err})
        # the auto block at a 10,240-print gallery of these prints, with the
        # engine's resident bytes for one PB-probe batch's stack kept across blocks
        c, hraw = w["gal"].shape[1], w["gal"].shape[-1]
        hk = int(w["canvas"] * max(bench.SCALES)) - 4  # the kernel canvas, 34 x 34
        n_rows = w["pb"] * 25
        per_print = ncc_kernel.gallery_block_bytes_per_print(c, hraw, hraw, n_rows)
        free = free_bytes(dev)
        auto = ncc_kernel.auto_gallery_block(G_10K, per_print, free, n_rows * c * hk * hk * 4, 1)
    return {"phase": "gallery_blocks", "prints": n_g, "probes": n_q, "runs": runs,
            "auto_block": {"gallery": G_10K, "block": auto, "bytes_per_print": per_print,
                           "free_bytes": free, "mem_get_info": torch.cuda.mem_get_info(dev)},
            "wall_s": time.perf_counter() - t0}


def phase_sharded(dataset: Path, kernel_run: tuple, fft_run: tuple,
                  device: str = "cuda") -> tuple[dict, int]:
    """Gallery sharding (``parallel/``) on the card; -> (the line, the NCC
    kernel's launches in the first sharded fixture run)."""
    import torch

    from shoeprint_image_retrieval_torch.benchmarks import bench_sharded
    from shoeprint_image_retrieval_torch.dryrun import dryrun_multichip
    from shoeprint_image_retrieval_torch.ops import ncc_kernel

    t0 = time.perf_counter()
    config = fixture_config(dataset)
    batch = int(config["tpu"]["extraction_batch"])
    out = {"phase": "sharded", "device_count": torch.cuda.device_count(), "runs": {}}
    launches = {}
    # each device extracts the main path's chunks: the chunk is n times the
    # main path's, so every device's batch has the main path's shape
    for name, n, backend, want_run, tpu in (
            ("mesh4", SHARDS, "auto", kernel_run, {}),
            ("mesh4_blocks", SHARDS, "auto", kernel_run, {"gallery_block": SHARD_BLOCK}),
            ("fft_mesh2", 2, "fft", fft_run, {})):
        ncc_kernel.launch_ncc.launches = 0
        run = run_pipeline(config, backend, device, mesh_devices=[device] * n, mesh_shape=n,
                           extraction_batch=n * batch, **tpu)
        launches[name] = ncc_kernel.launch_ncc.launches
        outs, _, info = run
        err = held_runs(f"sharded {name} vs unsharded", run, want_run, BLOCK_TOL)
        score_key = "fft" if backend == "fft" else "score"
        want_runs = {f"extract:{n}": 2 * len(outs), f"{score_key}:{n}": len(outs)}
        if info["mesh_runs"] != want_runs:
            raise AssertionError(f"{name}: mesh runs {info['mesh_runs']}, expected {want_runs}")
        blocks = info["gallery_blocks"] // len(outs)
        want_launches = 0 if backend == "fft" else sum(
            n * -(-o.n_queries // pb) * blocks for o, pb in zip(outs, info["probe_batches"]))
        if launches[name] != want_launches:
            raise AssertionError(f"{name}: {launches[name]} kernel launches, expected "
                                 f"{want_launches} (one a shard, batch and block)")
        out["runs"][name] = {"shards": n, "max_abs_diff": err, "launches": launches[name],
                             "blocks_per_cluster": blocks, **info}
    out["scaling"] = bench_sharded.scaling(device=device)
    if torch.cuda.device_count() > 1:
        n = min(torch.cuda.device_count(), SHARDS)
        out["dryrun"] = dryrun_multichip(n, [f"cuda:{i}" for i in range(n)])
    else:
        out["dryrun"] = ("one CUDA device visible: the copies between cards went "
                         "unexercised; every mesh here repeats cuda:0")
    out["wall_s"] = time.perf_counter() - t0
    return out, launches["mesh4"]


def phase_bench_10k(device: str = "cuda") -> dict:
    from shoeprint_image_retrieval_torch.benchmarks import bench_10k

    t0 = time.perf_counter()
    result = bench_10k.run(g=G_10K, block=BLOCK_10K, pb=128, device=device)
    return {"phase": "bench_10k", **result, "wall_s": time.perf_counter() - t0}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from shoeprint_image_retrieval_torch.device import resolve_device
    from shoeprint_image_retrieval_torch.ops import mma_probe, ncc_kernel

    resolve_device("cuda")
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0)})
    build = phase_build()
    emit(build)
    kern = phase_kernel(build)
    emit(kern)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        main_path, launches, plain, kernel_run = phase_main_path(Path(tmp))
        emit(main_path)
        dataset = Path(tmp) / "Dataset"
        emit(phase_summed_maps(dataset))
        kernel_score_s = [r["stages_s"]["score"] for r in main_path["runs"]
                          if r["backend"] == "auto"]
        fft, fft_run = phase_fft(dataset, plain, kernel_score_s)
        emit(fft)
        emit(phase_families(dataset))
        fusion, fusion_launches = phase_fusion(dataset)
        emit(fusion)
        emit(phase_front_end(dataset))
        extract = phase_extract()
        emit(extract)
        emit(phase_parity(Path(tmp)))
        bf16, bf16_launches = phase_bf16(dataset, plain, extract, build)
        emit(bf16)
        emit(phase_backbones())
        probe, probe_launches = phase_mxu_probe()
        emit(probe)
        emit(phase_bench())
        emit(phase_gallery_blocks())
        sharded, sharded_launches = phase_sharded(dataset, kernel_run, fft_run)
        emit(sharded)
    emit(phase_bench_10k())
    emit(phase_sizing())
    pruned, pruned_launches = phase_pruned()
    emit(pruned)
    primary = probe["legs"][0]  # the JAX default shape, f32: probe_pallas's first leg
    emit({"kernels": [{
        "name": "ncc_score",
        "route": "cuda",
        "source": ncc_kernel.SOURCE,
        "replaces": ncc_kernel.REPLACES,
        "launches": launches,
        "max_abs_err": max(kern["max_abs_err"], kern["edge_case_max_abs_err"]),
        "ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "launches_fusion": fusion_launches,
        "launches_pruned": pruned_launches,
        # the fixture over [cuda:0] * 4 (tpu.mesh_shape = 4): one launch a
        # shard, probe batch and gallery block
        "launches_sharded": sharded_launches,
        # the 3xTF32 call's roles, ring and instantiations (the bf16 leg's
        # under its leg)
        "design": kern["design"],
        # the fixture's cluster-0 call (a 47 x 39 canvas over 84 x 68 maps)
        # alone; its launches on the path are main_path's cluster 0
        "fixture_c0": {key: kern["fixture_c0"][key] for key in
                       ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}
                      | {"design": {k: kern["fixture_c0"]["design"][k]
                                    for k in ("stages", "patch", "patch_buffers")}},
        # the 3xTF32 leg is the entry's primary; the bf16 leg's launches are
        # its fixture run's (tpu.precision = "bfloat16")
        "legs": {
            "f32_3xtf32": {"ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
                           "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
                           "library_ms": kern["library_ms"],
                           "max_abs_err": kern["max_abs_err"], "launches": launches},
            "bf16": {key: bf16["main_shape_call"][key] for key in
                     ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                      "design")}
                    | {"launches": bf16_launches},
        },
    }, {
        "name": "mma_probe",
        "route": "cuda",
        "source": mma_probe.SOURCE,
        "replaces": mma_probe.REPLACES,
        "launches": probe_launches,
        "max_abs_err": max(leg["max_abs_err"] for leg in probe["legs"]),
        "max_rel_err": max(leg["max_rel_err"] for leg in probe["legs"]),
        "ms": primary["ms"],
        "plain_ms": primary["plain_ms"],
        "bound_ms": primary["bound_ms"],
        "bound_by": primary["bound_by"],
        "library_ms": primary["library_ms"],
        "leg": f"{primary['precision']} {primary['shape']}",
        "legs": {f"{leg['precision']} {leg['shape']}": {
            key: leg[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "tflops")}
            for leg in probe["legs"]},
    }]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

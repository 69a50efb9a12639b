#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each printing one JSON line:

1. ``build``: compiles every kernel of the port (``csrc/*.cu``) from the
   sources in the checkout for ``sm_90a``, with the compiler's
   register/shared-memory report.
2. ``kernel``: the fused NCC scorer ``score_ncc`` (the wrapper the engine
   calls) against its plain PyTorch version on the card, at the main-path
   shapes (G = 300 prints of 38-46 px raw, C = 176, probes of 28-36 px, a
   34 x 34 kernel canvas, 25 variants per probe, PB = 56 probes, N = 1400
   rows), plus the edge cases (zero template, flat print, zero-energy
   windows, a template larger than the prints). Max |kernel - plain| must be
   <= 1e-4 and each row's true-match rank identical. Reports the wrapper's
   time (CUDA events), the plain version's, one PyTorch convolution's (the
   yardstick, never called by the port) and the least time the card could
   take (``bound_ms``).
3. ``main_path``: the synthetic Impress fixture
   (``scripts/make_synthetic_impress.generate``, 120 prints, 30 queries) on
   ``benchmarks/synthetic_impress.toml``'s settings through the port's
   ``Pipeline`` — full-width EfficientNetV2_M from seeded init — four times,
   in the order plain, kernel, kernel, plain (launch counts reset just before
   the first kernel run and read just after it); ranks and S-lines must be
   identical in all four. Reports each run's stage times and score time per
   cluster.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` prints them, and as the last line
``{"ok": true, "device": {...}}``. Any fault exits non-zero before that line;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet): FP32 on the CUDA cores and
# device-memory bandwidth; bound_ms uses them.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-4  # kernel vs plain: float32 sums over 176 channels x 1156 taps in another order
PROBES = 56  # probes per scoring call on the main path: 56 x 25 variants = 1400 rows
REPS = 2     # timed calls after one warm-up

ROTATIONS = [-15, -9, -3, 3, 9, 15, 180]
SCALES = [1.02, 1.04, 1.08]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` on the card over ``reps`` runs after one
    warm-up, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> dict:
    from shoeprint_image_retrieval_torch.ops import build

    t0 = time.perf_counter()
    out = {"phase": "build", "sources": {}}
    for src in sorted(build.CSRC.glob("*.cu")):
        seconds, report = build.compile_source(src.stem)
        lines = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        out["sources"][src.stem] = {"nvcc_s": seconds, "ptxas": lines}
    out["wall_s"] = time.perf_counter() - t0
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


def window_taps(extent: int, canvas: int):
    """(extent + 1, canvas + 1) table: for a window of size ``k`` centred as
    the box sums centre it (``[y - k//2, y + (k-1)//2]``) and a print of
    valid size ``v``, the taps that land inside the print, summed over the
    print's valid output positions ``y < v``."""
    import numpy as np

    k = np.arange(extent + 1)[:, None, None]
    v = np.arange(canvas + 1)[None, :, None]
    y = np.arange(canvas)[None, None, :]
    lo = np.maximum(y - k // 2, 0)
    hi = np.minimum(y + (k - 1) // 2, v - 1)
    return np.where(y < v, np.maximum(hi - lo + 1, 0), 0).sum(axis=-1).astype(np.float64)


def needed_flop(row_hw, gvalid, c: int, canvas_hw: tuple[int, int]) -> float:
    """Multiply-adds the correlation needs on these inputs, as FLOP: for each
    (row, print, channel), the row's window taps that overlap the print's
    valid region, over the print's valid output positions. Taps that fall on
    the zero padding around a print are not counted."""
    hmax, wmax = int(row_hw[:, 0].max()), int(row_hw[:, 1].max())
    th, tw = window_taps(hmax, canvas_hw[0]), window_taps(wmax, canvas_hw[1])
    fh = th[row_hw[:, 0][:, None], gvalid[:, 0][None, :]]  # (N, G)
    fw = tw[row_hw[:, 1][:, None], gvalid[:, 1][None, :]]
    return 2.0 * c * float((fh * fw).sum())


def phase_kernel(pb: int = PROBES, reps: int = REPS, device: str = "cuda", g: int = 300,
                 c: int = 176) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from shoeprint_image_retrieval_torch.ops import ncc_kernel
    from shoeprint_image_retrieval_torch.ops.ncc_direct import row_slots, score_direct

    edge_err = edge_cases(device)
    cache, packed, layout, (uniq, inv), row_truth, c = main_shape_inputs(pb, device, g, c)
    launches0 = ncc_kernel.launch_ncc.launches
    got = ncc_kernel.score_ncc(cache, packed, layout, c, uniq, inv)
    want = score_direct(cache, packed, layout, c, uniq, inv)
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

    kernel_ms = cuda_ms(lambda: ncc_kernel.score_ncc(cache, packed, layout, c, uniq, inv), reps)
    plain_ms = cuda_ms(lambda: score_direct(cache, packed, layout, c, uniq, inv), reps)
    # yardstick: one cuDNN convolution (TF32 off) computing the channel-summed
    # raw correlation on the same operands; the port never calls it
    hk, wk = packed.kernels.shape[-2:]
    lib_in = F.pad(cache.p0.transpose(0, 1), (wk // 2, wk - 1 - wk // 2, hk // 2, hk - 1 - hk // 2))
    lib_w = packed.kernels.contiguous()
    library_ms = cuda_ms(lambda: F.conv2d(lib_in, lib_w), reps)
    del lib_in

    # the least time the card could take: the correlation's needed FP32
    # multiply-adds at the peak FP32 rate, against every input of score_ncc
    # read once and the output written once at the memory rate
    slots, row_slot = row_slots(packed, layout, uniq, inv)
    row_hw = slots[row_slot].cpu().numpy()
    gvalid = cache.valid_hw.cpu().numpy()
    flops = needed_flop(row_hw, gvalid, c, tuple(cache.p0.shape[2:]))
    inputs = (cache.p0, cache.int1, cache.int2, cache.valid_hw, packed.kernels, uniq, inv)
    in_bytes = sum(t.numel() * t.element_size() for t in inputs)
    out_bytes = got.numel() * got.element_size()
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    n, g = got.shape
    return {
        "phase": "kernel", "probes": pb, "rows": n, "prints": g, "channels": c,
        "kernel_hw": [int(hk), int(wk)],
        "geometry": ncc_kernel.launch_geometry(cache.p0.shape[2], cache.p0.shape[3], int(hk), int(wk)),
        "max_abs_err": err, "edge_case_max_abs_err": edge_err,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "needed_flop": flops, "bytes": in_bytes + out_bytes,
        "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "comparison_launches": ncc_kernel.launch_ncc.launches - launches0,
    }


def run_pipeline(config: dict, backend: str, device: str = "cuda"):
    import numpy as np

    from shoeprint_image_retrieval_torch.metrics import cmp, s_line
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    cfg = copy.deepcopy(config)
    cfg["tpu"]["ncc_backend"] = backend
    t0 = time.perf_counter()
    pipe = Pipeline(cfg, weights_dir=None, verbose=False, device=device)
    outs, score_s = [], []
    for out in pipe.run():
        outs.append(out)
        score_s.append(pipe.stage_seconds["score"] - sum(score_s))
    wall = time.perf_counter() - t0
    n_g, n_q = len(pipe.dataset.gallery_files), len(pipe.dataset.query_files)
    lines = []
    for out in outs:
        if out.scores.shape != (out.n_queries, n_g) or not np.isfinite(out.scores).all():
            raise AssertionError(f"{backend}: bad scores {out.scores.shape}")
        if out.ranks.min() < 1 or out.ranks.max() > n_g:
            raise AssertionError(f"{backend}: ranks out of range")
        lines.append(s_line({p: cmp(out.ranks.tolist(), p, n_g, n_q) * 100
                             for p in (1, 5, 10, 15, 20)}))
    return outs, lines, {"backend": backend, "wall_s": wall, "stages_s": pipe.stage_seconds,
                         "score_s_per_cluster": score_s}


def phase_main_path(tmp: Path, device: str = "cuda", gallery: int = 120,
                    queries: int = 30) -> tuple[dict, int]:
    """Plain, kernel, kernel, plain, so that neither backend always pays the
    first run's warm-up."""
    import numpy as np

    from scripts.make_synthetic_impress import generate
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.ops import ncc_kernel

    t0 = time.perf_counter()
    generate(tmp / "Dataset", gallery=gallery, queries=queries)
    gen_s = time.perf_counter() - t0
    config = load_config(Path(__file__).resolve().parent / "benchmarks" / "synthetic_impress.toml")
    config["dataset"]["dir"] = str(tmp / "Dataset")
    config["tpu"]["cache_dir"] = ""

    runs = [run_pipeline(config, "direct", device)]
    ncc_kernel.launch_ncc.launches = 0
    runs.append(run_pipeline(config, "auto", device))
    launches = ncc_kernel.launch_ncc.launches
    if launches < 1:
        raise AssertionError("the main path did not launch the NCC kernel")
    runs += [run_pipeline(config, "auto", device), run_pipeline(config, "direct", device)]
    p_outs, p_lines, _ = runs[0]
    max_err = 0.0
    for outs, lines, info in runs[1:]:
        if len(outs) != len(p_outs):
            raise AssertionError(f"{info['backend']}: planned different clusters")
        for o, p in zip(outs, p_outs):
            if not np.array_equal(o.ranks, p.ranks):
                raise AssertionError(f"ranks differ: {info['backend']} {o.ranks} plain {p.ranks}")
            max_err = max(max_err, float(np.abs(o.scores - p.scores).max()))
        if lines != p_lines:
            raise AssertionError(f"S-lines differ: {info['backend']} {lines} vs plain {p_lines}")
    return {
        "phase": "main_path", "dataset_gen_s": gen_s,
        "clusters": [{"queries": o.n_queries, "block": o.block, "scale": o.scale,
                      "ranks": o.ranks.tolist()} for o in p_outs],
        "s_lines": p_lines, "kernel_launches": launches,
        "runs": [info for _, _, info in runs],
        "scores_max_abs_diff": max_err,
    }, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from shoeprint_image_retrieval_torch.device import resolve_device
    from shoeprint_image_retrieval_torch.ops import ncc_kernel

    resolve_device("cuda")
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0)})
    emit(phase_build())
    kern = phase_kernel()
    emit(kern)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        main_path, launches = phase_main_path(Path(tmp))
    emit(main_path)
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
    }]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

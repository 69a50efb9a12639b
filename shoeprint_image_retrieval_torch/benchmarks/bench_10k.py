"""10k-print gallery bench: the gallery streamed in blocks, ranks on the device.

The port of ``benchmarks/bench_10k.py``. A 10,240-print direct cache (p0
and two integral images, f32, C = 176, 42 x 42) takes ~39 GB, so the
gallery is streamed through the fused NCC kernel in ``--block``-print
blocks: per block the prints are generated on the device from a
``torch.Generator`` seeded ``1000 + block`` (neither host nor device ever
holds the whole gallery), the block's direct cache is built, every probe
batch is scored against it, and the score columns go into a device-resident
(Q, G) buffer. The true-match ranks are counted on the device
(``ops/topk.ranks_on_device``), so the timed result pull is Q int32s.

Probes are noisy crops of block-0 prints, so each has a planted true match.
Checks, outside the timed loop: the device ranks equal the host ranks of the
pulled matrix (``metrics.ranks_from_scores``); the scores of a probe/print
subsample agree with the CPU oracle (``retrieval/oracle.py``) within 5e-4;
every planted match ranks 1st.

    python -m shoeprint_image_retrieval_torch.benchmarks.bench_10k [--g 10240]
        [--block 0] [--pb 128] [--sweep] [--quick] [--device cuda|cpu]

``--block 0`` takes the engine's auto block (the largest that fits the
card's free memory; the whole gallery on the CPU). ``--sweep`` scores the
full 25-variant reference sweep, 64 probes per call, each batch's variant
stack built once and reused across blocks. Prints one JSON line with the JAX
bench's keys and the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import free_bytes, resolve_device

ROTATIONS = [-15, -9, -3, 3, 9, 15, 180]
SCALES = [1.02, 1.04, 1.08]
ORACLE_TOL = 5e-4  # kernel f32 sums in another order than the CPU oracle's float64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def block_sizes(bi: int, nb: int, lo: int, hi: int) -> np.ndarray:
    """Valid (h, w) of block ``bi``'s ``nb`` prints, height-sorted."""
    rng = np.random.default_rng(1000 + bi)
    sizes = np.stack([rng.integers(lo, hi + 1, nb), rng.integers(lo, hi + 1, nb)],
                     1).astype(np.int32)
    return sizes[np.argsort(-sizes[:, 0], kind="stable")]


def generate_block(bi: int, sizes: np.ndarray, c: int, hi: int,
                   device: torch.device) -> torch.Tensor:
    """Block ``bi``'s (nb, C, hi, hi) maps, made on the device from a
    generator seeded ``1000 + bi``, zero outside each print's valid size."""
    gen = torch.Generator(device=device).manual_seed(1000 + bi)
    maps = torch.randn((len(sizes), c, hi, hi), generator=gen, device=device)
    s = torch.as_tensor(sizes, device=device)
    ar = torch.arange(hi, device=device)
    rows = ar[None, :, None] < s[:, 0, None, None]
    cols = ar[None, None, :] < s[:, 1, None, None]
    return torch.where((rows & cols)[:, None], maps, torch.zeros((), device=device))


def run(g: int = 10240, block: int = 0, pb: int = 128, sweep: bool = False,
        quick: bool = False, device: str | torch.device = "cuda") -> dict:
    from ..metrics import ranks_from_scores
    from ..ops import ncc_kernel
    from ..ops.ncc_direct import PackedVariants, VariantLayout, build_direct_cache, fold_template
    from ..ops.topk import ranks_on_device
    from ..retrieval import oracle
    from ..retrieval.engine import (
        batch_windows, build_kernels, regroup_max, variant_classes, variant_plan)

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}")
    if quick:
        G, BLK, C, PB = 64, 16, 8, 2
        g_lo, g_hi, q_lo, q_hi = 18, 24, 14, 18
    else:
        G, BLK, C, PB = g, block, 176, pb
        g_lo, g_hi, q_lo, q_hi = 38, 46, 28, 36
    rotations = ROTATIONS if sweep else []
    scales = SCALES if sweep else []
    QB = (2 if quick else 64) if sweep else PB  # probes per scoring call
    hc = q_hi
    smax = max([1.0] + scales)
    tc = (max(hc, int(hc * smax)), max(hc, int(hc * smax)))
    kernel_hw = (tc[0] - 4, tc[1] - 4)
    n_var = 1 + (1 + len(rotations)) * len(scales)

    if not BLK:
        # the engine's auto block; every batch's variant stack stays resident
        if dev.type == "cuda":
            BLK = ncc_kernel.auto_gallery_block(
                G, ncc_kernel.gallery_block_bytes_per_print(C, g_hi, g_hi, QB * n_var),
                free_bytes(dev), QB * n_var * C * kernel_hw[0] * kernel_hw[1] * 4,
                -(-PB // QB))
        else:
            BLK = G
    # the probes are planted in block 0, which must hold them all
    BLK = max(BLK, min(PB, G))
    n_blocks = -(-G // BLK)
    log(f"G={G} in {n_blocks} blocks of {BLK}; C={C}; PB={PB} probes "
        f"({n_var} variant(s) each, {QB} a call)")

    # probes: noisy crops of block-0 prints, probe i planted on print i
    rng = np.random.default_rng(7)
    bs0 = block_sizes(0, min(BLK, G), g_lo, g_hi)
    block0 = generate_block(0, bs0, C, g_hi, dev)[:PB].cpu().numpy()
    q_sizes = np.zeros((PB, 2), np.int32)
    qmaps = np.zeros((PB, C, hc, hc), np.float32)
    q_native = []
    for i in range(PB):
        sh, sw = int(bs0[i, 0]), int(bs0[i, 1])
        ch = min(max(q_lo, sh - 6), q_hi, sh)
        cw = min(max(q_lo, sw - 6), q_hi, sw)
        crop = block0[i, :, :ch, :cw] + 0.05 * rng.normal(size=(C, ch, cw)).astype(np.float32)
        q_native.append(crop.astype(np.float32))
        qmaps[i, :, :ch, :cw] = crop
        q_sizes[i] = (ch, cw)

    def on_dev(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=dev)

    # the kernel's tile plan, made on the host: its rows' half with each
    # variant stack, its prints' half with each block
    tile = ncc_kernel.kernel_tile() if dev.type == "cuda" else None

    def stack(kernels, wins, uniq, inv):
        rows = None if tile is None else ncc_kernel.row_plan(
            ncc_kernel.host_row_hw(wins, layout, uniq, inv), kernel_hw, tile.rows, dev)
        return PackedVariants(kernels, on_dev(wins)), on_dev(uniq), on_dev(inv), rows

    # variant stacks, built once and reused across every block
    batches, batch_rows = [], []
    with torch.inference_mode():
        if not sweep:
            layout = VariantLayout((1,), PB)
            windows = (q_sizes - 4).astype(np.int32)
            uniq, inv = np.unique(windows, axis=0, return_inverse=True)
            kernels = fold_template(on_dev(qmaps), on_dev(q_sizes), kernel_hw)
            batches.append(stack(kernels, windows, uniq, inv.reshape(-1)))
            batch_rows.append(0)
        else:
            plan = variant_plan(q_sizes, (hc, hc), rotations, scales)
            include, counts = variant_classes("reference", plan.n_rot, plan.n_scl)
            layout = VariantLayout(counts, QB)
            tables = [on_dev(a) for a in (qmaps, q_sizes, plan.rot_idx, plan.rot_ok, plan.wv,
                                          plan.wh, plan.scale_hw)]
            for lo in range(0, PB, QB):
                take = np.minimum(np.arange(lo, lo + QB), PB - 1)
                kernels = build_kernels(*(t.index_select(0, on_dev(take)) for t in tables),
                                        kernel_hw=kernel_hw, include_rots_unscaled=include,
                                        n_scl=plan.n_scl)
                wins, uniq, inv = batch_windows(q_sizes[take], plan.scale_hw[take], plan.n_scl)
                batches.append(stack(kernels, wins, uniq, inv))
                batch_rows.append(lo)
            log(f"{len(batches)} variant stacks built "
                f"({sum(b[0].kernels.numel() * 4 for b in batches) / 1e9:.2f} GB), "
                f"reused across all blocks")

        def score_block(cache, k, sizes):
            packed, uniq, inv, rows = batches[k]
            tiles = None if tile is None else (rows, ncc_kernel.print_plan(sizes - 4, tile.positions))
            s = ncc_kernel.score_ncc(cache, packed, layout, C, uniq, inv, plan=tiles)
            return regroup_max(s, layout) if sweep else s

        # warm-up: the kernel library and the CUDA context, on a few prints
        t0 = time.perf_counter()
        nw = min(8, len(bs0))
        score_block(build_direct_cache(generate_block(0, bs0, C, g_hi, dev)[:nw],
                                       on_dev(bs0[:nw])), 0, bs0[:nw]).cpu()
        log(f"warm-up: {time.perf_counter() - t0:.2f}s")

        buf = torch.zeros((len(batches) * QB, G), dtype=torch.float32, device=dev)
        launches0 = ncc_kernel.launch_ncc.launches
        cache_gb = 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for bi in range(n_blocks):
            b_lo = bi * BLK
            nb = min(BLK, G - b_lo)
            sizes = block_sizes(bi, nb, g_lo, g_hi)
            cache = build_direct_cache(generate_block(bi, sizes, C, g_hi, dev), on_dev(sizes))
            if bi == 0:
                cache_gb = sum(t.numel() * t.element_size() for t in cache) / 1e9
            for k in range(len(batches)):
                lo = batch_rows[k]
                buf[lo : lo + QB, b_lo : b_lo + nb] = score_block(cache, k, sizes)
            del cache
        pairs = torch.arange(PB, device=dev)  # probe i's planted match is global print i
        ranks = ranks_on_device(buf[:PB], pairs).cpu().numpy()
        dt = time.perf_counter() - t0
    launches = ncc_kernel.launch_ncc.launches - launches0
    pps = PB / dt
    log(f"{PB} probes x {n_var} variant(s) x {G} prints (streamed, {n_blocks} blocks) in "
        f"{dt:.2f}s -> {pps:.3f} probes/s")

    # device ranks == host ranks of the pulled matrix (the pull the device
    # path exists to avoid, so outside the timed loop)
    full = buf[:PB].cpu().numpy()
    host_ranks = ranks_from_scores(full, list(range(PB)))
    if not np.array_equal(ranks, host_ranks):
        raise RuntimeError(f"device ranks {ranks} != host ranks {host_ranks}")
    log("device ranks == host metrics.ranks_from_scores: ok")

    # oracle subsample: per-pair scores, and every planted match 1st
    sub_q, sub_g = min(3, PB), min(40, len(bs0))
    bm = generate_block(0, bs0, C, g_hi, dev)[:sub_g].cpu().numpy()
    want = np.zeros((sub_q, sub_g), np.float32)
    for qi in range(sub_q):
        for gi in range(sub_g):
            want[qi, gi] = oracle.pair_similarity(q_native[qi], bm[gi, :, :bs0[gi, 0], :bs0[gi, 1]])
    got = full[:sub_q, :sub_g]
    top1_ok = bool((ranks == 1).all())
    if sweep:
        # class 0 of the sweep is the unrotated original: max over variants
        # is at least the oracle's unrotated score
        err = float((want - got).max())
        log(f"oracle subsample: sweep score >= unrotated oracle score (max shortfall {err:.2e})")
    else:
        err = float(np.abs(got - want).max())
        log(f"oracle subsample: max |delta| = {err:.2e}")
    log(f"planted matches rank 1st across the gallery: {top1_ok}")
    if not (err < ORACLE_TOL and top1_ok):
        raise RuntimeError(f"oracle check failed: err {err} (limit {ORACLE_TOL}), "
                           f"planted matches at rank 1: {top1_ok}")
    return {
        "metric": ("probes_per_sec_10k_gallery_full_sweep" if sweep
                   else "probes_per_sec_10k_gallery_streamed"),
        "value": round(pps, 3),
        "unit": "probes/s",
        "gallery": G,
        "block": BLK,
        "variants": n_var,
        "per_block_cache_gb": round(cache_gb, 3),
        "rank_pull_bytes": int(ranks.nbytes),
        "host_path_pull_bytes": PB * G * 4,
        "device": name,
        "seconds": dt,
        "blocks": n_blocks,
        "kernel_launches": launches,
        "oracle_err": err,
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.benchmarks.bench_10k")
    ap.add_argument("--g", type=int, default=10240)
    ap.add_argument("--block", type=int, default=0, help="prints per block; 0 = auto")
    ap.add_argument("--pb", type=int, default=128, help="probes")
    ap.add_argument("--sweep", action="store_true", help="the 25-variant reference sweep")
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(args.g, args.block, args.pb, args.sweep, args.quick, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""The per-batch variant build: what one scoring call costs besides the kernel.

The port of ``benchmarks/bench_build.py``. At ``bench.py``'s probe shapes
(PB = 56 probes of 28-36 px on a 36 x 36 canvas, C = 176, 7 rotations x 3
scales, 25 variants a probe, a 34 x 34 kernel canvas) it times each part of
``retrieval/engine.build_kernels`` on the device (CUDA events, mean of
``reps`` after a warm-up):

* ``rotate`` — ``rotate_maps``, one gather per probe and its mask;
* ``scale`` — the two batched resample products per scale;
* ``fold`` — ``fold_template`` of every class (demean, energy scale,
  centring gathers);
* ``build_kernels`` — the whole build as the engine calls it;

and on the host clock the engine's per-batch host work: ``batch_windows``
(the window dedup) and, on a card, ``row_plan`` (the kernel's row tile plan
and the upload of its table). The JAX bench's ``rows`` and ``onehot`` rotations are
TPU formulations of the same gather; the port ships the gather only, and
this bench times that.

    python -m shoeprint_image_retrieval_torch.benchmarks.bench_build [--quick] [--device cuda|cpu]

Prints one JSON line. With ``--device cpu`` every time is the CPU's;
``--quick`` shrinks the shapes for that.
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
from ..ops.boxsum import EDGE_CROP
from ..ops.ncc_direct import VariantLayout, fold_template
from ..retrieval.engine import (
    batch_windows, build_kernels, rotate_maps, variant_classes, variant_maps, variant_plan)
from ..utils.tracing import device_ms

PB = 56


def host_ms(fn, reps: int) -> float:
    """Mean host-clock time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


@torch.inference_mode()
def run(pb: int = PB, reps: int = 3, quick: bool = False,
        device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    w = bench.make_workload(quick, q=pb)
    qmaps = bench.draw_probe_maps(w)
    q_sizes, hc = w["q_sizes"], w["canvas"]
    plan = variant_plan(q_sizes, (hc, hc), bench.ROTATIONS, bench.SCALES)
    include, counts = variant_classes("reference", plan.n_rot, plan.n_scl)
    kernel_hw = (plan.template_canvas[0] - 2 * EDGE_CROP, plan.template_canvas[1] - 2 * EDGE_CROP)
    layout = VariantLayout(counts, pb)
    maps, valid, rot_idx, rot_ok, wv, wh, scale_hw = (
        torch.from_numpy(np.asarray(a)).to(dev) for a in
        (qmaps, q_sizes, plan.rot_idx, plan.rot_ok, plan.wv, plan.wh, plan.scale_hw))
    c = maps.shape[1]
    rot = rotate_maps(maps, rot_idx, rot_ok)
    base, scaled = variant_maps(maps, rot_idx, rot_ok, wv, wh, include_rots_unscaled=include,
                                n_scl=plan.n_scl)

    def scale():
        for si in range(plan.n_scl):
            vert = torch.einsum("poh,prchw->prcow", wv[:, si], rot)
            torch.einsum("pqw,prcow->prcoq", wh[:, si], vert)

    def fold():
        b0 = base.shape[1]
        fold_template(base.reshape(pb * b0, c, hc, hc), valid.repeat_interleave(b0, dim=0),
                      kernel_hw)
        for si, sc in enumerate(scaled):
            fold_template(sc.reshape(-1, c, *sc.shape[-2:]),
                          scale_hw[:, si].repeat_interleave(sc.shape[1], dim=0), kernel_hw)

    def build():
        return build_kernels(maps, valid, rot_idx, rot_ok, wv, wh, scale_hw, kernel_hw=kernel_hw,
                             include_rots_unscaled=include, n_scl=plan.n_scl)

    stack = build()
    out = {"metric": "variant_build_ms", "probes": pb, "rows": layout.n_variants,
           "channels": c, "kernel_hw": list(kernel_hw),
           "stack_bytes": stack.numel() * stack.element_size(),
           "rotate_ms": device_ms(lambda: rotate_maps(maps, rot_idx, rot_ok), reps, dev),
           "scale_ms": device_ms(scale, reps, dev),
           "fold_ms": device_ms(fold, reps, dev),
           "build_kernels_ms": device_ms(build, reps, dev)}
    wins, uniq, inv = batch_windows(q_sizes, plan.scale_hw, plan.n_scl)
    out["batch_windows_ms"] = host_ms(
        lambda: batch_windows(q_sizes, plan.scale_hw, plan.n_scl), reps)
    rows = ncc_kernel.host_row_hw(wins, layout, uniq, inv)
    # the kernel's tile is read from the built kernel: no plan on the CPU
    out["row_plan_ms"] = None if dev.type != "cuda" else host_ms(
        lambda: ncc_kernel.row_plan(rows, kernel_hw, ncc_kernel.kernel_tile().rows, dev), reps)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.benchmarks.bench_build")
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(pb=2 if args.quick else PB, quick=args.quick, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

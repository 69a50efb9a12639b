"""The NCC kernel alone: one scoring call on a prebuilt stack and tile plan.

The port of ``benchmarks/kernel_probe.py``. ``bench.py`` times the whole
probe-batch step (variant build, fold, kernel); this probe builds the
variant stack, the gallery cache and the kernel's tile plan first and times
only ``ops/ncc_kernel.score_ncc`` (CUDA events), at ``bench.py``'s shapes
(G = 300 prints of 38-46 px, C = 176, probes of 28-36 px, 25 variants a
probe) for each probe batch of a sweep (PB = 28, 56, 64, 112, 224, 320). Each
point reports its ms, ms a probe, the FLOP the correlation needs on these
inputs (``needed_flop``) and the FLOP the kernel executes for its plan
(``executed_flop``, a host model of its blocks), the TFLOP/s the needed
FLOP give and the call's share of its bound: the larger of the needed FLOP
at 3xTF32's peak and every input read once and the output written once at
the memory rate (:func:`bound`, from the published peaks in
:data:`PEAK_FLOPS`). On a card it then times the main path's batch (PB =
56) in each of the 3xTF32 leg's two patch layouts, split and float, in the
order split, float, float, split. ``--precision bf16`` runs the sweep
through the kernel's bf16 leg instead (``tpu.precision = "bfloat16"``):
its bound is the needed FLOP at the bf16 rate, its plain version and
library call take bf16 operands, and it has one patch layout. The JAX
probe's TPU-only switches (``NCC_SKIP``, ``CLASS_CANVAS``, ``EPI``,
``DTYPES``) are not carried over.

:func:`probe_call` times one call on any inputs (``chip_smoke.py`` uses it
for the pruned pass-1 call), optionally beside one ``F.conv2d`` of the same
correlation (the library yardstick; the port never calls it) and one call
of the plain scorer.

    python -m shoeprint_image_retrieval_torch.benchmarks.kernel_probe [--pbs 28 56 ...]
        [--precision f32_3xtf32|bf16] [--quick] [--device cuda|cpu]

Prints one JSON line. With ``--device cpu`` the plain scorer runs and every
time is the CPU's host clock, not a device time; ``--quick`` shrinks the
workload for that.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from .. import bench
from ..device import resolve_device
from ..ops import ncc_kernel
from ..ops.boxsum import EDGE_CROP
from ..ops.ncc_direct import PackedVariants, VariantLayout, build_direct_cache, score_direct
from ..retrieval.engine import batch_windows, build_kernels, variant_classes, variant_plan
from ..utils.tracing import device_ms

# Published H100 SXM dense peaks (NVIDIA data sheet), the bounds of every
# kernel the port times: FP32 on the CUDA cores, 3xTF32 (three TF32
# tensor-core products, 495 TFLOP/s, for one f32 product: the NCC kernel's
# route), BF16 on the tensor cores; and the device-memory rate
PEAK_FLOPS = {"f32": 67e12, "f32_3xtf32": 495e12 / 3, "bf16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
PBS = (28, 56, 64, 112, 224, 320)  # 320 x 25 = ops/ncc_kernel.H100_PROBE_ROWS
QUICK_PBS = (2, 3)
LAYOUT_PB = 56  # the main path's probe batch: the patch layouts timed against each other


def bound(flop: float, moved: float, route: str = "f32_3xtf32") -> dict:
    """The least time the card could take: ``flop`` at the route's peak
    against ``moved`` bytes at the memory rate, the larger of the two."""
    t_ops = flop / PEAK_FLOPS[route] * 1e3
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def stack_inputs(gal: np.ndarray, g_sizes: np.ndarray, qmaps: np.ndarray, q_sizes: np.ndarray,
                 device: torch.device, rotations=bench.ROTATIONS, scales=bench.SCALES) -> dict:
    """The gallery cache, one probe batch's variant stack (every probe of
    ``qmaps``, the reference sweep) and its windows, built as the engine
    builds them, on ``device``."""
    pb, c, hc, wc = qmaps.shape
    cache = build_direct_cache(torch.from_numpy(gal).to(device),
                               torch.from_numpy(g_sizes).to(device))
    plan = variant_plan(q_sizes, (hc, wc), rotations, scales)
    include, counts = variant_classes("reference", plan.n_rot, plan.n_scl)
    kernel_hw = (plan.template_canvas[0] - 2 * EDGE_CROP, plan.template_canvas[1] - 2 * EDGE_CROP)
    tables = [torch.from_numpy(np.asarray(a)).to(device) for a in
              (qmaps, q_sizes, plan.rot_idx, plan.rot_ok, plan.wv, plan.wh, plan.scale_hw)]
    with torch.inference_mode():
        kernels = build_kernels(*tables, kernel_hw=kernel_hw, include_rots_unscaled=include,
                                n_scl=plan.n_scl)
    wins, uniq, inv = batch_windows(q_sizes, plan.scale_hw, plan.n_scl)
    layout = VariantLayout(counts, pb)
    return {"cache": cache, "packed": PackedVariants(kernels, torch.from_numpy(wins).to(device)),
            "layout": layout, "channels": c, "kernel_hw": kernel_hw,
            "row_hw": ncc_kernel.host_row_hw(wins, layout, uniq, inv),
            "slots": (torch.from_numpy(uniq).to(device), torch.from_numpy(inv).to(device))}


def probe_call(inputs: dict, device: torch.device, library: bool = False,
               warm: bool = True, plain: bool = False, patch: str = "auto",
               precision: str = "f32_3xtf32", keep: bool = False) -> dict:
    """Time one ``score_ncc`` call on :func:`stack_inputs`' operands with the
    engine's host tile plan (the plain scorer on the CPU), after one warm-up
    call where ``warm`` (the first call of a process builds the kernel and
    its first launch sets the card up; later shapes need none), in the
    kernel's ``precision`` leg (``ops/ncc_kernel.PRECISIONS``) and ``patch``
    layout (``ops/ncc_kernel.PATCHES``). With ``library``, one ``F.conv2d``
    computing the channel-summed raw correlation of the same operands (in
    the leg's dtype) too; with ``plain``, one call of the plain scorer
    (``score_direct``, in the leg's dtype): its ms and the largest |kernel -
    plain|; with ``keep``, the scores too (``out`` and, with ``plain``,
    ``plain_out``, tensors for the caller's checks). -> ms, FLOP, bytes and
    bound at the leg's peak."""
    dtype = ncc_kernel.DTYPE_OF_LEG[precision]
    cache, packed, layout, c = (inputs[k] for k in ("cache", "packed", "layout", "channels"))
    kernel_hw, row_hw = inputs["kernel_hw"], inputs["row_hw"]
    gvalid = cache.valid_hw.cpu().numpy()
    plan = executed = geometry = None
    if device.type == "cuda":
        tile = ncc_kernel.kernel_tile()
        plan = (ncc_kernel.row_plan(row_hw, kernel_hw, tile.rows, device),
                ncc_kernel.print_plan(gvalid, tile.positions))
        executed = ncc_kernel.executed_flop(plan[0], gvalid, c, kernel_hw, tile)
        geometry = ncc_kernel.launch_geometry(cache.p0.shape[3], *kernel_hw, *plan, patch,
                                              precision)

    def call():
        return ncc_kernel.score_ncc(cache, packed, layout, c, *inputs["slots"], plan=plan,
                                    patch=patch, compute_dtype=dtype)

    holder = []
    ms = device_ms(lambda: holder.append(call()), 1, device, warm=warm)
    out = holder.pop()
    holder.clear()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("kernel_probe: non-finite scores")
    n, g = out.shape
    hb, wb = cache.p0.shape[2:]
    needed = ncc_kernel.needed_flop(row_hw, gvalid, c, (hb, wb))
    moved = sum(t.numel() * t.element_size() for t in (*cache, packed.kernels, *inputs["slots"],
                                                        out))
    result = {"rows": n, "prints": g, "channels": c, "canvas": [hb, wb],
              "kernel_hw": list(kernel_hw), "precision": precision, "patch": patch,
              "geometry": geometry, "ms": ms,
              "needed_flop": needed, "executed_flop": executed, "bytes": moved,
              "tflops": needed / (ms * 1e-3) / 1e12, **bound(needed, moved, precision)}
    result["bound_share"] = result["bound_ms"] / ms
    if plain:
        want = []
        result["plain_ms"] = device_ms(
            lambda: want.append(score_direct(cache, packed, layout, c, *inputs["slots"],
                                             compute_dtype=dtype)), 1, device, warm=False)
        result["max_abs_err"] = float((out - want[0]).abs().max())
        if keep:
            result["plain_out"] = want[0]
    if keep:
        result["out"] = out
    del out
    if library:
        result["library_ms"] = library_ms(inputs, device, dtype)
    return result


def library_ms(inputs: dict, device: torch.device, dtype: torch.dtype = torch.float32) -> float:
    """One ``F.conv2d`` (TF32 off) computing the channel-summed raw
    correlation of :func:`stack_inputs`' operands in ``dtype`` (cast before
    the clock starts): every variant row against every print, the yardstick
    a library gives for the kernel's work; timed after one small call (the
    library's first use)."""
    cache, kernels, c = inputs["cache"], inputs["packed"].kernels, inputs["channels"]
    hk, wk = inputs["kernel_hw"]
    lib_in = F.pad(cache.p0[:c].transpose(0, 1),  # the cache pads C to a multiple of 8
                   (wk // 2, wk - 1 - wk // 2, hk // 2, hk - 1 - hk // 2)).to(dtype)
    kernels = kernels.to(dtype)
    with torch.inference_mode():
        F.conv2d(lib_in[:1], kernels[:1])
        return device_ms(lambda: F.conv2d(lib_in, kernels), 1, device, warm=False)


def run(pbs=PBS, quick: bool = False, device: str | torch.device = "cuda",
        layout_pb: int | None = LAYOUT_PB, precision: str = "f32_3xtf32") -> dict:
    """The sweep over probe batches on one gallery, through the kernel's
    ``precision`` leg: one probe batch of each size, its first probes drawn
    from one set. On a card, with ``layout_pb`` and the 3xTF32 leg, the
    batch of that size once more in each patch layout of the kernel, in the
    order split, float, float, split (``layouts``)."""
    dev = resolve_device(device)
    w = bench.make_workload(quick, q=max(pbs))
    qmaps = bench.draw_probe_maps(w)
    sweep = []
    for i, pb in enumerate(pbs):
        inputs = stack_inputs(w["gal"], w["g_sizes"], qmaps[:pb], w["q_sizes"][:pb], dev)
        point = probe_call(inputs, dev, warm=i == 0, precision=precision)
        point.update(probes=pb, ms_per_probe=point["ms"] / pb,
                     probes_per_s=pb / (point["ms"] * 1e-3))
        sweep.append(point)
        bench.log(f"PB={pb} N={point['rows']}: {point['ms']:.1f} ms, "
                  f"{point['ms_per_probe']:.2f} ms a probe, {point['tflops']:.1f} TFLOP/s")
        del inputs
    out = {"metric": "ncc_kernel_ms_per_probe", "precision": precision, "sweep": sweep,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if layout_pb and dev.type == "cuda" and precision == "f32_3xtf32":
        inputs = stack_inputs(w["gal"], w["g_sizes"], qmaps[:layout_pb],
                              w["q_sizes"][:layout_pb], dev)
        runs = [probe_call(inputs, dev, warm=False, patch=patch)
                for patch in ("split", "float", "float", "split")]
        out["layouts"] = {"probes": layout_pb, "rows": runs[0]["rows"],
                          **{patch: {"ms": [r["ms"] for r in runs if r["patch"] == patch],
                                     "geometry": next(r["geometry"] for r in runs
                                                      if r["patch"] == patch)}
                             for patch in ("split", "float")}}
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.benchmarks.kernel_probe")
    ap.add_argument("--pbs", type=int, nargs="+", default=None,
                    help=f"probe batches of the sweep (default {' '.join(map(str, PBS))})")
    ap.add_argument("--precision", default="f32_3xtf32", choices=tuple(ncc_kernel.PRECISIONS),
                    help="the kernel's leg (bf16: tpu.precision = \"bfloat16\")")
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    pbs = args.pbs or (QUICK_PBS if args.quick else PBS)
    result = run(pbs, args.quick, args.device, precision=args.precision)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

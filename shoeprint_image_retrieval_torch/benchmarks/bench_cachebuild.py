"""The per-block gallery prep: what the engine pays once per gallery block.

The port of ``benchmarks/bench_cachebuild.py``. ``bench.py``'s kernel-level
mode builds the gallery cache outside its timed loop; the engine builds it
inside every ``_score_cluster`` call, once per gallery block. This bench
splits that build (``ops/ncc_direct.build_direct_cache``) on the device
(CUDA events, mean of ``reps`` after a warm-up):

* ``demean`` — edge crop, masked per-print demean, channel pad, transpose to
  channel-major;
* ``integrals`` — the two integral images (of p0 and p0^2);
* ``build`` — the whole build as the engine calls it;

and on the host clock ``print_plan`` (the kernel's per-block print plan),
at two sizes: ``bench.py``'s gallery (G = 300 prints of 38-46 px, C = 176)
and one 2048-print block of ``benchmarks/bench_10k.py``'s gallery (its
seeded prints generated on the device). The JAX bench's matmul integrals and
``pack_gallery_operands`` are TPU formulations with no counterpart here.

    python -m shoeprint_image_retrieval_torch.benchmarks.bench_cachebuild [--quick] [--device cuda|cpu]

Prints one JSON line. With ``--device cpu`` every time is the CPU's;
``--quick`` shrinks the shapes for that.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from .. import bench
from ..device import resolve_device
from ..ops import ncc_kernel
from ..ops.boxsum import EDGE_CROP, integral_image, masked_demean
from ..ops.ncc_direct import CHANNEL_BLOCK, build_direct_cache
from ..utils.tracing import device_ms
from . import bench_10k
from .bench_build import host_ms

BLOCK = 2048


def split(prints: torch.Tensor, valid: torch.Tensor, reps: int) -> dict:
    """The build's parts and the whole on one block of prints."""
    dev = prints.device
    g, c, hraw, wraw = prints.shape
    hb, wb = hraw - 2 * EDGE_CROP, wraw - 2 * EDGE_CROP
    c_pad = -(-c // CHANNEL_BLOCK) * CHANNEL_BLOCK

    def demean():
        p = prints[:, :, EDGE_CROP : EDGE_CROP + hb, EDGE_CROP : EDGE_CROP + wb]
        v = valid - 2 * EDGE_CROP
        p0 = masked_demean(p, v[:, 0], v[:, 1])
        return F.pad(p0, (0, 0, 0, 0, 0, c_pad - c)).transpose(0, 1).contiguous()

    p0 = demean()

    def integrals():
        return integral_image(p0).contiguous(), integral_image(p0 * p0).contiguous()

    cache = build_direct_cache(prints, valid)
    out = {"prints": g, "channels": c, "canvas": [hb, wb],
           "cache_bytes": sum(t.numel() * t.element_size() for t in cache),
           "demean_ms": device_ms(demean, reps, dev),
           "integrals_ms": device_ms(integrals, reps, dev),
           "build_ms": device_ms(lambda: build_direct_cache(prints, valid), reps, dev)}
    gvalid = (valid - 2 * EDGE_CROP).cpu().numpy()
    out["print_plan_ms"] = None if dev.type != "cuda" else host_ms(
        lambda: ncc_kernel.print_plan(gvalid, ncc_kernel.kernel_tile().positions), reps)
    return out


@torch.inference_mode()
def run(block: int = BLOCK, reps: int = 3, quick: bool = False,
        device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    w = bench.make_workload(quick, q=1)
    out = {"metric": "cache_build_ms",
           "bench": split(torch.from_numpy(w["gal"]).to(dev),
                          torch.from_numpy(w["g_sizes"]).to(dev), reps)}
    c, hi = w["gal"].shape[1], w["gal"].shape[-1]
    sizes = bench_10k.block_sizes(0, block, hi - 8, hi)
    prints = bench_10k.generate_block(0, sizes, c, hi, dev)
    out["block"] = split(prints, torch.from_numpy(sizes).to(dev), reps)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m shoeprint_image_retrieval_torch.benchmarks.bench_cachebuild")
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(block=32 if args.quick else BLOCK, quick=args.quick, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""Feature-extraction throughput: images per second in both CLAHE configurations.

The port of ``benchmarks/bench_extract.py``. It measures the batched masked
backbone extraction the engine runs per cluster (``engine._extract``):

* ``device`` (``tpu.clahe_host = false``): CLAHE (``ops/clahe``) ->
  normalise -> truncated EfficientNetV2_M, all on the device;
* ``host`` (the default): the native C++ CLAHE on the host
  (``data/native_ingest.clahe_batch``, bit-exact against cv2 and against
  the device CLAHE), then normalise -> backbone on the device. Its images/s
  count the two one after another, the worst case: the engine's streamed
  path overlaps them.

Inputs are seeded random uint8 canvases with valid sizes up to 64 px short
of the canvas; weights are the seeded init. Device times come from CUDA
events (mean over ``steps`` calls after a warm-up), host CLAHE from the
host clock. ``--bf16`` binds ``tpu.precision = "bfloat16"`` on the model
(``models/layers.set_conv_precision``): its convs on bf16 operands with f32
accumulation on a card, f32 on the CPU (``conv_route`` says which ran).

    python -m shoeprint_image_retrieval_torch.benchmarks.bench_extract \
        [--batch 32] [--steps 6] [--canvas 704] [--block 6] [--bf16] [--quick] \
        [--device cuda|cpu]

Prints one JSON line. With ``--device cpu`` every time is the CPU's, not a
device rate; ``--quick`` shrinks the shapes for that.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data import native_ingest
from ..device import resolve_device
from ..models.layers import conv_route, set_conv_precision
from ..models.registry import get_backbone
from ..models.weights import build_model
from ..ops.clahe import clahe_batched_dynamic
from ..ops.preprocess import normalize_batch
from ..utils.tracing import device_ms

MODEL = "EfficientNetV2_M"
CLIP, GRID = 2.0, (8, 8)
QUICK = {"batch": 2, "steps": 2, "canvas": 128, "block": 4}


def make_batch(batch: int, canvas: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(batch, canvas, canvas) uint8 and (batch, 2) int32 valid sizes in
    [canvas - 64, canvas]."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (batch, canvas, canvas), np.uint8)
    lo = max(1, canvas - 64)
    valid = np.stack([rng.integers(lo, canvas + 1, batch),
                      rng.integers(lo, canvas + 1, batch)], 1).astype(np.int32)
    return u8, valid


@torch.inference_mode()
def run(batch: int = 32, steps: int = 6, canvas: int = 704, block: int = 6,
        device: str = "cuda", bf16: bool = False) -> dict:
    dev = resolve_device(device)
    spec = get_backbone(MODEL)
    model = build_model(MODEL, block, None, dev)
    precision = "bfloat16" if bf16 else "float32"
    set_conv_precision(model, precision)
    u8, valid = make_batch(batch, canvas)
    u8d, vd = torch.from_numpy(u8).to(dev), torch.from_numpy(valid).to(dev)

    def clahe_step():
        return clahe_batched_dynamic(u8d, vd, CLIP, GRID)

    def device_step():
        x = normalize_batch(clahe_step(), vd, spec.mean, spec.std)
        return model(x, vd)[0].sum()

    def backbone_step():
        return model(normalize_batch(u8d, vd, spec.mean, spec.std), vd)[0].sum()

    clahe_ms = device_ms(clahe_step, steps, dev)
    device_step_ms = device_ms(device_step, steps, dev)
    backbone_ms = device_ms(backbone_step, steps, dev)

    imgs = [u8[i, : valid[i, 0], : valid[i, 1]] for i in range(batch)]
    native_ingest.clahe_batch(imgs, CLIP, GRID, 8)  # warm-up (and the library's build)
    t0 = time.perf_counter()
    for _ in range(steps):
        native_ingest.clahe_batch(imgs, CLIP, GRID, 8)
    host_clahe_ms = (time.perf_counter() - t0) * 1e3 / steps
    return {
        "metric": "extraction_images_per_sec",
        "device_clahe": batch / (device_step_ms * 1e-3),
        "host_clahe": batch / ((backbone_ms + host_clahe_ms) * 1e-3),
        "unit": "images/s",
        "device_step_ms": device_step_ms,
        "device_clahe_ms": clahe_ms,
        "backbone_ms": backbone_ms,
        "host_clahe_ms": host_clahe_ms,
        "canvas": canvas, "batch": batch, "block": block, "steps": steps,
        "precision": precision, "conv_route": conv_route(precision, dev),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.benchmarks.bench_extract")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--canvas", type=int, default=704)
    ap.add_argument("--block", type=int, default=6)
    ap.add_argument("--bf16", action="store_true",
                    help="tpu.precision = \"bfloat16\": the convs on bf16 operands")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    shape = QUICK if args.quick else {"batch": args.batch, "steps": args.steps,
                                      "canvas": args.canvas, "block": args.block}
    print(json.dumps(run(**shape, device=args.device, bf16=args.bf16)))


if __name__ == "__main__":
    main()

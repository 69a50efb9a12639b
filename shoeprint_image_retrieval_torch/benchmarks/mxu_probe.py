"""Matrix-unit rate probe: delivered FLOP/s by precision and shape.

The port of ``benchmarks/mxu_probe.py``:

* :func:`probe_kernel` is the analogue of ``probe_pallas``: the hand-written
  kernel ``ops/mma_probe.py`` (``csrc/mma_probe.cu``) in each precision
  (FP32 FMA, 3xTF32 and bf16 on the tensor cores) at the JAX default shape
  (512 x 1156 x 128, 48 products a step, 100 steps) and at the NCC main
  path's row count (n = 1400 variant rows, k = 34 * 34 = 1156 taps).
* :func:`probe_matmul` is the analogue of ``probe_xla``: ``torch.matmul`` at
  4096^3 in f32 (TF32 off) and in bf16.

    python -m shoeprint_image_retrieval_torch.benchmarks.mxu_probe [--device cuda|cpu] [--quick]

Prints one line per measurement and, last, one JSON line with every result
and the device it ran on. Times on the card come from CUDA events. With
``--device cpu`` the kernel's plain version runs and every time is the
CPU's, not a device rate; ``--quick`` shrinks the shapes for that.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops.mma_probe import PRECISIONS, mma_probe, probe_flop
from ..utils.tracing import device_ms

# name -> (n, k, lanes, y_iters, grid)
SHAPES = {
    "jax_default": (512, 1156, 128, 48, 100),
    "ncc_rows": (1400, 1156, 128, 48, 100),
}
QUICK_SHAPES = {"quick": (24, 37, 16, 3, 2)}


def probe_inputs(n: int, k: int, lanes: int, precision: str, device: torch.device):
    """a (n, k) and b (k, lanes) from seeded normals (the JAX probe's seeds
    0 and 1), in the precision's input dtype."""
    dtype = PRECISIONS[precision][1]
    a = np.random.default_rng(0).normal(size=(n, k)).astype(np.float32)
    b = np.random.default_rng(1).normal(size=(k, lanes)).astype(np.float32)
    return (torch.from_numpy(a).to(device=device, dtype=dtype),
            torch.from_numpy(b).to(device=device, dtype=dtype))


def probe_kernel(shapes: dict = SHAPES, device: str | torch.device = "cuda",
                 reps: int = 3) -> list[dict]:
    """The probe kernel's delivered rate for every (shape, precision)."""
    dev = resolve_device(device)
    results = []
    for shape, (n, k, lanes, y_iters, grid) in shapes.items():
        for precision in PRECISIONS:
            a, b = probe_inputs(n, k, lanes, precision, dev)
            ms = device_ms(lambda: mma_probe(a, b, y_iters, grid, precision), reps, dev)
            tflops = probe_flop(n, k, lanes, y_iters, grid) / (ms * 1e-3) / 1e12
            print(f"kernel {precision:10s} {n}x{k}x{lanes} x{y_iters} x{grid}: "
                  f"{tflops:.1f} TFLOP/s ({ms:.3f} ms, {dev.type})", flush=True)
            results.append({"shape": shape, "precision": precision, "n": n, "k": k,
                            "lanes": lanes, "y_iters": y_iters, "grid": grid,
                            "ms": ms, "tflops": tflops})
    return results


def probe_matmul(m: int = 4096, k: int = 4096, n: int = 4096, length: int = 10,
                 device: str | torch.device = "cuda") -> dict:
    """``torch.matmul`` (m, k) @ (k, n) in f32 with TF32 off and in bf16:
    TFLOP/s over ``length`` calls after one warm-up."""
    dev = resolve_device(device)
    results = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        a = torch.from_numpy(np.random.default_rng(0).normal(size=(m, k)).astype(np.float32))
        b = torch.from_numpy(np.random.default_rng(1).normal(size=(k, n)).astype(np.float32))
        a, b = a.to(device=dev, dtype=dtype), b.to(device=dev, dtype=dtype)
        ms = device_ms(lambda: torch.matmul(a, b), length, dev)
        tflops = 2.0 * m * k * n / (ms * 1e-3) / 1e12
        print(f"matmul {name:10s} {m}x{k}x{n}: {tflops:.1f} TFLOP/s ({ms:.3f} ms, {dev.type})",
              flush=True)
        results[name] = {"ms": ms, "tflops": tflops}
    return results


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.benchmarks.mxu_probe")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true", help="small shapes (for the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    matmul = probe_matmul(*((256,) * 3 if args.quick else ()), device=dev)
    kernel = probe_kernel(QUICK_SHAPES if args.quick else SHAPES, device=dev)
    result = {"device": name, "kernel": kernel, "matmul": matmul}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

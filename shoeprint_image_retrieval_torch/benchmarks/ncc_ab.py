"""The NCC kernel's calls timed from one checkout, for A/B runs between commits.

    python shoeprint_image_retrieval_torch/benchmarks/ncc_ab.py TREE LABEL [--data DIR]

Run by path, so that ``TREE``'s copy of the package (a checkout root, for
example an unpacked ``git archive`` of an earlier commit, or ``.``) is the
one imported. In one process on the card it times, through ``TREE``'s own
``kernel_probe.probe_call`` (CUDA events, one warm-up call before each
call's reps):

* the fixture's cluster-0 call, built from a seed by this file's
  ``cases.py`` (loaded by path, so every tree gets the same operands): C =
  80, 120 prints on 84 x 68 maps, 375 rows on a 47 x 39 kernel canvas, and
  the same call at VGG16's C = 256 and DenseNet-201's 128, and at 5 probes
  (125 rows), where the split patch fits twice with a 2-deep ring, in the
  kernel's own layout and with the float patch forced (3 stages), in the
  order auto, float, float, auto;
* the main path's PB = 56 call (``bench.py``'s workload through ``TREE``'s
  ``kernel_probe.stack_inputs``) in the 3xTF32 and bf16 legs;
* every NCC kernel call of the fixture's pipeline runs (``TREE``'s
  ``chip_smoke.run_pipeline`` with its ``timed_launches``): EfficientNetV2_M
  twice (the first is the warm-up), then VGG16, DenseNet-201 and
  EfficientNet-B7 as ``chip_smoke``'s ``families`` phase plans them, on
  the synthetic fixture in ``--data`` (generated there if missing; in a
  temporary directory without ``--data``).

Prints one JSON line: each call's ms, its launch geometry and a hash of its
scores (equal hashes are bit-identical scores), each pipeline call's C,
canvas and ms, and each run's S-lines and score hashes.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

# (model, start_block, end_block, skip_blocks): the fixture's own backbone,
# then chip_smoke's families
PIPELINES = (
    ("EfficientNetV2_M", 6, 4, [5]),
    ("VGG16", 24, 17, [18, 19, 20, 21, 22, 23]),
    ("DenseNet_201", 8, 6, [7]),
    ("EfficientNet_B7", 6, 4, [5]),
)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _digest(array) -> str:
    return hashlib.sha256(array.tobytes()).hexdigest()[:16]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="ncc_ab.py")
    ap.add_argument("tree", type=Path, help="checkout root whose package is timed")
    ap.add_argument("label")
    ap.add_argument("--data", type=Path, default=None,
                    help="the synthetic fixture's directory (generated there if missing)")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch

    from shoeprint_image_retrieval_torch import bench
    from shoeprint_image_retrieval_torch.benchmarks import kernel_probe
    from shoeprint_image_retrieval_torch.device import resolve_device

    cases = _load("ncc_ab_cases", Path(__file__).resolve().parent / "cases.py")
    smoke = _load("ncc_ab_chip_smoke", tree / "chip_smoke.py")
    dev = resolve_device("cuda")

    def timed(inputs, reps=3, **kwargs):
        calls = [kernel_probe.probe_call(inputs, dev, warm=i == 0, keep=True, **kwargs)
                 for i in range(reps)]
        return {"ms": [call["ms"] for call in calls], "geometry": calls[0]["geometry"],
                "scores": _digest(calls[0]["out"].cpu().numpy())}

    def fixture_call(channels, probes=None):
        case = cases.CASES["fixture_c0"]
        if probes:
            case = case._replace(probe_hw=case.probe_hw[:probes])
        gal, g_sizes, qmaps, q_sizes, _ = cases.case_arrays(case, channels=channels)
        return kernel_probe.stack_inputs(gal, g_sizes, qmaps, q_sizes, dev)

    t0 = time.perf_counter()
    out = {"label": args.label, "tree": str(tree), "device": torch.cuda.get_device_name(dev),
           "calls": {}, "pipelines": {}}
    for c in (80, 256, 128):
        out["calls"][f"fixture_c0 C={c}"] = timed(fixture_call(c), reps=3 if c == 80 else 2)
    inputs = fixture_call(80, probes=5)
    for i, patch in enumerate(("auto", "float", "float", "auto")):
        out["calls"][f"fixture_c0 5 probes {patch} {i}"] = timed(inputs, patch=patch)
    w = bench.make_workload(False, q=56)
    inputs = kernel_probe.stack_inputs(w["gal"], w["g_sizes"], bench.draw_probe_maps(w),
                                       w["q_sizes"], dev)
    for precision in ("f32_3xtf32", "bf16"):
        out["calls"][f"main PB=56 {precision}"] = timed(inputs, precision=precision)
    del inputs
    torch.cuda.empty_cache()

    with contextlib.ExitStack() as stack:
        data = args.data or Path(stack.enter_context(tempfile.TemporaryDirectory()))
        if not (data / "Gallery").is_dir():
            from scripts.make_synthetic_impress import generate

            with contextlib.redirect_stdout(sys.stderr):  # stdout holds the result alone
                generate(data)
        _pipelines(smoke, data, out["pipelines"])
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return out


def _pipelines(smoke, data: Path, out: dict) -> None:
    """Every NCC kernel call of :data:`PIPELINES` on the fixture in ``data``
    (the first model run twice: a warm-up), into ``out``."""
    import numpy as np

    base = smoke.fixture_config(data)
    for i, (model, start, end, skip) in enumerate((PIPELINES[0], *PIPELINES)):
        cfg = copy.deepcopy(base)
        cfg["model"].update(type=model, start_block=start, end_block=end, skip_blocks=skip)
        with smoke.timed_launches() as calls:
            outputs, s_lines, _ = smoke.run_pipeline(cfg, "auto")
        out[model if i else f"{model} warm-up"] = {
            "calls": [{k: call[k] for k in ("channels", "rows", "prints", "canvas", "kernel_hw",
                                            "ms")} for call in calls],
            "scores": [_digest(np.ascontiguousarray(o.scores)) for o in outputs],
            "s_lines": s_lines}


if __name__ == "__main__":
    main()

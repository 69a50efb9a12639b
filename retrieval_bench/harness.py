"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Everything that belongs to one cell, configuration, gallery-state mode or
metric is a file of its own, found by name: ``workloads/<cell>.toml``,
``configs/<config>.toml``, ``drivers/<mode>.py``, ``metrics/<metric>.py``.
Which metrics a cell prints comes from ``BENCHMARK.json``: with
``--trace 0`` its end-to-end metrics, with ``--trace 1`` its per-layer ones
(each where its ``workloads`` list names the cell, or everywhere without
one).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
import tomllib
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "shoeprint_image_retrieval_tpu")


@dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``)."""

    setup_s: float
    window_s: float
    batch_seconds: list[float]
    marks: int
    stage_delta: dict[str, float]
    images_extracted: int
    backbone_flop: float
    ncc_flop: float
    ncc_bound_s: float
    trace: dict | None = None


def load_file(path: Path, name: str):
    """Import the module at ``path`` under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(cell: str) -> tuple[dict, Path]:
    """(cell, configuration file) of ``cell``."""
    with (HERE / "workloads" / f"{cell}.toml").open("rb") as fh:
        spec = tomllib.load(fh)
    return spec, HERE / "configs" / f"{spec['config']}.toml"


def metrics_for(bench: dict, cell: str, kind: str) -> list[dict]:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))


def host_counters() -> dict[str, float]:
    """This process's CPU seconds, page faults and context switches, and the
    whole host's CPU seconds by state (``/proc/stat``, where there is one):
    what the window's host time went to."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"utime_s": ru.ru_utime, "stime_s": ru.ru_stime, "minflt": ru.ru_minflt,
           "majflt": ru.ru_majflt, "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw}
    try:
        fields = Path("/proc/stat").read_text().splitlines()[0].split()[1:9]
    except (OSError, IndexError):
        return out
    tick = os.sysconf("SC_CLK_TCK")
    for name, v in zip(("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal"),
                       fields):
        out[f"host_{name}_s"] = int(v) / tick
    return out


def header_sizes(directory: Path) -> dict[str, tuple[int, int]]:
    from PIL import Image

    out = {}
    for p in sorted(directory.iterdir()):
        with Image.open(p) as im:
            out[p.name] = im.size
    return out


def work_model(config: dict, plan, traffic_files: dict) -> dict:
    """Per mark, its correlation's needed FLOP and bytes against the whole
    gallery and its backbone FLOP; per print, its backbone FLOP; from the
    images' header sizes and the program's (scale, block)."""
    import numpy as np

    from . import flops
    from .reference import backbones

    net = backbones.network(config["model"]["type"], plan.block)
    c = backbones.channels(net)
    crop = config["dataset"]["crop"]
    comp = config["comparison"]
    rots, scales = comp["rotations"] or [], comp["scales"] or []

    def feat(wh):
        return backbones.out_size(net, flops.ingest_hw(wh, crop, plan.scale))

    g_hw = {f: flops.ingest_hw(wh, crop, plan.scale) for f, wh in traffic_files["Gallery"].items()}
    gvalid = np.asarray([backbones.out_size(net, hw) for hw in g_hw.values()]) - 2 * flops.EDGE
    marks = {}
    for f, wh in traffic_files["Query"].items():
        rows = flops.variant_windows(feat(wh), len(rots), scales)
        marks[f] = {"flop": flops.needed_flop(rows, gvalid, c),
                    "bytes": flops.correlation_bytes(rows, gvalid, c),
                    "backbone": backbones.conv_flop(net, flops.ingest_hw(wh, crop, plan.scale))}
    gallery_backbone = sum(backbones.conv_flop(net, hw) for hw in g_hw.values())
    return {"marks": marks, "gallery_backbone": gallery_backbone}


def run_cell(args, t_start: float) -> int:
    """Run ``args.workload`` once; print the result line; the exit code.
    ``args.device`` other than ``cuda`` (the CPU tests' tiny cells) skips
    the look for a card."""
    import numpy as np
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec, cfg_path = cell_files(args.workload)
    traffic_spec, check_spec = spec["traffic"], spec["check"]
    cuda = args.device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < int(spec["chips"])):
        print(f"retrieval_bench: the cell needs {spec['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    from . import check, flops, traffic, weights
    from . import trace as tracing

    device = torch.device(args.device)
    setup_marks = {"imports": time.perf_counter() - t_start}
    dataset = traffic.dataset(traffic_spec, args.seed, workers=args.workers)
    setup_marks["dataset"] = time.perf_counter() - t_start
    config = load_config(cfg_path)
    config["dataset"]["dir"] = str(dataset) + os.sep
    model_type, top_block = config["model"]["type"], int(config["model"]["start_block"])
    state = weights.make(model_type, top_block, args.seed, device)
    with tempfile.TemporaryDirectory(prefix="retrieval_bench_") as wdir:
        weights.save(state, Path(wdir), model_type)
        drv_mod = load_file(HERE / "drivers" / f"{spec['mode']}.py",
                            f"retrieval_bench.drivers.{spec['mode']}")
        driver = drv_mod.Driver(Pipeline, config, wdir, args.device, traffic_spec)
        setup_marks["pipeline"] = time.perf_counter() - t_start
        for _ in range(int(traffic_spec.get("warm_batches", 1))):
            driver.step()
        setup_marks["warm"] = time.perf_counter() - t_start
        plan = driver.plan()
        files = {sub: header_sizes(dataset / sub) for sub in ("Query", "Gallery")}
        work = work_model(config, plan, files)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        batches, seconds, cache_s = [], [], []
        stage0 = driver.stage_seconds()
        host0 = host_counters()
        with tracing.record(bool(args.trace), device) as traced:
            t0 = time.perf_counter()
            while True:
                tb = time.perf_counter()
                batches.append(driver.step())
                te = time.perf_counter()
                seconds.append(te - tb)
                cache_s.append(driver.stage_seconds().get("cache", 0.0))
                if te - t0 >= args.seconds:
                    break
            window_s = time.perf_counter() - t0
        host1 = host_counters()
        stage1 = driver.stage_seconds()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        driver.close()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        print(f"retrieval_bench: loaded {found} in the benchmark's process", file=sys.stderr)
        return 4

    marks = sum(len(b.files) for b in batches)
    per_mark = work["marks"]
    ncc_flop = sum(per_mark[f]["flop"] for b in batches for f in b.files)
    ncc_bound = sum(flops.bound_seconds(sum(per_mark[f]["flop"] for f in b.files),
                                        sum(per_mark[f]["bytes"] for f in b.files))
                    for b in batches)
    backbone = sum(per_mark[f]["backbone"] for b in batches for f in b.files) + sum(
        work["gallery_backbone"] for b in batches if b.extracted_prints)
    run = Run(setup_s=setup_s, window_s=window_s,
              batch_seconds=seconds, marks=marks,
              stage_delta={k: stage1.get(k, 0.0) - stage0.get(k, 0.0) for k in stage1},
              images_extracted=sum(b.extracted_marks + b.extracted_prints for b in batches),
              backbone_flop=backbone, ncc_flop=ncc_flop, ncc_bound_s=ncc_bound,
              trace=traced or None)
    failed = sum(int(not np.all(np.isfinite(b.scores[i]))) for b in batches
                 for i in range(len(b.files)))

    # the comparison with the plain reference, once the program is gone
    t_ref = time.perf_counter()
    gallery_files = sorted(files["Gallery"])
    plan_bad, ref_scale, ref_block = check.plan_mismatch(
        plan, [wh for sub in files.values() for wh in sub.values()], config)
    picked = check.sample(batches, args.seed, int(check_spec["marks"]), int(check_spec["prints"]),
                          int(check_spec["top"]))
    ref = check.Reference(dataset, config, state, ref_scale, ref_block, torch.float64, device)
    limits = {"plan": 0, "rank": 0, "nonfinite": 0, "score_gap": float(check_spec["score_gap"])}

    def judged(candidate=None):
        numbers = dict(check.judge(picked, gallery_files, ref, candidate), plan=plan_bad)
        return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}

    checks = judged()
    program_checks = None
    if args.control:
        # the control in the program's place, judged as the program is
        program_checks = checks
        with check.tf32(True):
            checks = judged(check.Reference(dataset, config, state, ref_scale, ref_block,
                                            torch.float32, device))
    ref_s = time.perf_counter() - t_ref
    correct = failed == 0 and marks > 0 and all(v["value"] <= v["limit"] for v in checks.values())

    kind = "per_layer" if args.trace else "end_to_end"
    values = {}
    for m in metrics_for(bench, args.workload, kind):
        reader = load_file(HERE / "metrics" / f"{m['name']}.py",
                           f"retrieval_bench.metrics.{m['name']}")
        v = reader.read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else args.device,
           "kind": torch.cuda.get_device_name(0) if cuda else args.device, "count": 1,
           "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": marks, "failed": failed, "metrics": values,
            "device": dev}
    if run.trace is not None:
        summary = run.trace["summary"]
        dev["busy_s"] = summary["busy_ms"] / 1e3
        dev["window_s"] = summary["window_ms"] / 1e3
        line["breakdown"] = {
            "device_ops": [[o["name"], o["ms"] / 1e3] for o in summary["top_ops"][:10]],
            "idle_gaps": [[g["host_op"] or "", g["ms"] / 1e3] for g in summary["idle_gaps"][:10]],
        }
    line["run"] = {"window_s": window_s, "batches": len(batches), "reference_s": ref_s,
                   "setup_marks_s": setup_marks, "stages": run.stage_delta,
                   "cache_s_per_batch": list(np.diff([stage0.get("cache", 0.0)] + cache_s)),
                   "host": {k: host1[k] - host0[k] for k in host0 if k in host1}}
    if program_checks is not None:
        line["run"]["program_checks"] = program_checks
    line["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

"""The port's measurement entry points run end to end on the CPU.

``bench`` and ``benchmarks/bench_10k`` at their ``--quick`` sizes with
``--device cpu``: each prints one JSON line on stdout under the JAX bench's
metric name and keys, and bench_10k passes its own checks (device ranks
equal host ranks, the oracle subsample, planted matches at rank 1). The
probe benchmark prints its rates and one JSON line.
"""

import json
from pathlib import Path

import pytest

from shoeprint_image_retrieval_torch import bench
from shoeprint_image_retrieval_torch.benchmarks import bench_10k, mxu_probe

REPO = Path(__file__).resolve().parents[1]
# the keys of the JAX 10k bench's JSON line (benchmarks/bench_10k.py)
KEYS_10K = {"metric", "value", "unit", "gallery", "block", "variants", "per_block_cache_gb",
            "rank_pull_bytes", "host_path_pull_bytes"}


def _one_json_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("flags,metric,keys", [
    ([], "probes_per_sec_engine_path", {"engine", "kernel"}),
    (["--kernel"], "probes_per_sec_full_gallery_ncc", set()),
])
def test_bench_quick_on_cpu(capsys, flags, metric, keys):
    bench.main(["--quick", "--device", "cpu", *flags])
    out = _one_json_line(capsys)
    assert f'"{metric}"' in (REPO / "bench.py").read_text()  # the JAX bench's name
    assert out["metric"] == metric and out["unit"] == "probes/s" and out["device"] == "cpu"
    assert out["value"] > 0 and keys <= set(out)
    assert abs(out["vs_baseline"] - out["value"] / 100.0) <= 1e-4  # value / 100 probes/s


@pytest.mark.parametrize("flags,metric,variants", [
    ([], "probes_per_sec_10k_gallery_streamed", 1),
    (["--sweep"], "probes_per_sec_10k_gallery_full_sweep", 25),
])
def test_bench_10k_quick_on_cpu(capsys, flags, metric, variants):
    bench_10k.main(["--quick", "--device", "cpu", *flags])
    out = _one_json_line(capsys)
    assert f'"{metric}"' in (REPO / "benchmarks" / "bench_10k.py").read_text()
    assert KEYS_10K <= set(out) and out["metric"] == metric
    assert (out["gallery"], out["block"], out["blocks"], out["variants"]) == (64, 16, 4, variants)
    assert out["rank_pull_bytes"] == 2 * 4 and out["host_path_pull_bytes"] == 2 * 64 * 4
    assert out["oracle_err"] < bench_10k.ORACLE_TOL
    assert out["kernel_launches"] == 0  # the CPU runs the plain scorer


def test_bench_10k_blocks_regenerate_identically():
    """The oracle check regenerates block 0: the same seed gives the same
    maps, zero outside each print's valid size, and prints height-sorted."""
    import torch

    sizes = bench_10k.block_sizes(0, 5, 18, 24)
    assert sizes.shape == (5, 2) and (sizes[:-1, 0] >= sizes[1:, 0]).all()
    cpu = torch.device("cpu")
    a = bench_10k.generate_block(0, sizes, 3, 24, cpu)
    assert torch.equal(a, bench_10k.generate_block(0, sizes, 3, 24, cpu))
    assert not torch.equal(a, bench_10k.generate_block(1, sizes, 3, 24, cpu))
    for i, (h, w) in enumerate(sizes):
        assert a[i, :, h:].abs().sum() == 0 and a[i, :, :, w:].abs().sum() == 0
        assert (a[i, :, :h, :w] != 0).all()


def test_mxu_probe_quick_on_cpu(capsys):
    result = mxu_probe.main(["--quick", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(result))
    assert [(r["precision"], r["shape"]) for r in result["kernel"]] == [
        ("f32", "quick"), ("f32_3xtf32", "quick"), ("bf16", "quick")]
    assert set(result["matmul"]) == {"f32", "bf16"} and result["device"] == "cpu"

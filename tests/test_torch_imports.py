"""The port stands alone: no JAX, nothing of the JAX package.

The test process has already imported JAX (``tests/conftest.py``), so the
check runs in a fresh interpreter that refuses ``jax*`` and
``shoeprint_image_retrieval_tpu*`` imports through a ``sys.meta_path``
finder, then imports every module of the port and ``chip_smoke.py``.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "shoeprint_image_retrieval_torch"

BLOCKED_IMPORTS = r"""
import importlib, json, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root == "jax" or root.startswith("jax") or root == "shoeprint_image_retrieval_tpu":
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import shoeprint_image_retrieval_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "shoeprint_image_retrieval_tpu"))
assert not leaked, leaked
print(json.dumps(names))
"""

# modules added with the measurement path: the probe kernel's wrapper, the
# benchmarks, on-device ranks and the oracle copy
MEASUREMENT_MODULES = {
    "shoeprint_image_retrieval_torch.ops.mma_probe",
    "shoeprint_image_retrieval_torch.ops.topk",
    "shoeprint_image_retrieval_torch.retrieval.oracle",
    "shoeprint_image_retrieval_torch.bench",
    "shoeprint_image_retrieval_torch.benchmarks.mxu_probe",
    "shoeprint_image_retrieval_torch.benchmarks.bench_10k",
}
# modules added with the front end: device CLAHE, the parity harness and the
# extraction bench
FRONT_END_MODULES = {
    "shoeprint_image_retrieval_torch.ops.clahe",
    "shoeprint_image_retrieval_torch.retrieval.parity",
    "shoeprint_image_retrieval_torch.benchmarks.bench_extract",
}

# modules added with the other 12 backbones and the FFT backend
BACKBONE_FFT_MODULES = {
    "shoeprint_image_retrieval_torch.models.vgg",
    "shoeprint_image_retrieval_torch.models.densenet",
    "shoeprint_image_retrieval_torch.models.summary",
    "shoeprint_image_retrieval_torch.ops.fft",
    "shoeprint_image_retrieval_torch.ops.ncc",
}

# modules added with H100 sizing, fusion and pruned scoring
SIZING_PRUNING_MODULES = {
    "shoeprint_image_retrieval_torch.retrieval.pruned",
    "shoeprint_image_retrieval_torch.benchmarks.kernel_probe",
    "shoeprint_image_retrieval_torch.benchmarks.bench_build",
    "shoeprint_image_retrieval_torch.benchmarks.bench_cachebuild",
    "shoeprint_image_retrieval_torch.benchmarks.bench_fusion",
    "shoeprint_image_retrieval_torch.benchmarks.bench_pruned",
    "shoeprint_image_retrieval_torch.benchmarks.bench_autosize",
}

# modules added with the mesh (gallery sharding)
MESH_MODULES = {
    "shoeprint_image_retrieval_torch.parallel.mesh",
    "shoeprint_image_retrieval_torch.parallel.sharded",
    "shoeprint_image_retrieval_torch.benchmarks.bench_sharded",
    "shoeprint_image_retrieval_torch.dryrun",
}

# modules added with the visualisation script's port
SCRIPT_MODULES = {
    "shoeprint_image_retrieval_torch.scripts.summed_feature_maps",
}

# the visualisation module needs matplotlib to plot only: it imports, and its
# maps come out, with matplotlib refused (a CUDA host may not have it)
BLOCKED_MATPLOTLIB = r"""
import sys

import numpy as np

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
from shoeprint_image_retrieval_torch.scripts import summed_feature_maps as sfm

rng = np.random.default_rng(0)
q, p = (torch.from_numpy(rng.normal(size=(8, h, w)).astype(np.float32))
        for h, w in ((7, 6), (9, 8)))
corr, summed, score = sfm.channel_maps(q, p)
assert corr.shape == (8, 9, 8) and np.isfinite(score)
try:
    sfm.plot(corr, summed, score, "unused.png")
except ImportError as err:
    assert "matplotlib" in str(err)
else:
    raise AssertionError("plot ran without matplotlib")
assert not [m for m in sys.modules if m.split(".")[0] == "matplotlib"]
print("ok")
"""


def test_port_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert len(names) >= 25  # every module of the port was imported
    assert MEASUREMENT_MODULES <= names
    assert FRONT_END_MODULES <= names
    assert BACKBONE_FFT_MODULES <= names
    assert SIZING_PRUNING_MODULES <= names
    assert MESH_MODULES <= names
    assert SCRIPT_MODULES <= names


def test_summed_maps_module_imports_without_matplotlib():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_MATPLOTLIB], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|shoeprint_image_retrieval_tpu)\b", re.M)
    sources = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_chip_smoke_without_a_card_fails_and_prints_no_result(tmp_path):
    """On a host without CUDA (this one) the smoke script exits non-zero and
    prints no result line, from the repo and from a directory holding only
    the script."""
    import shutil

    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a CUDA device is present")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout

"""The port stands alone: no JAX, nothing of the JAX package.

The test process has already imported JAX (``tests/conftest.py``), so the
check runs in a fresh interpreter that refuses ``jax*`` and
``shoeprint_image_retrieval_tpu*`` imports through a ``sys.meta_path``
finder, then imports every module of the port and ``chip_smoke.py``.
"""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "shoeprint_image_retrieval_torch"

BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys

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
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every module of the port was imported


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

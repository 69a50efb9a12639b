"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names; the reference, every architecture's
file under ``reference/nets/`` with it, loads nothing of the program
either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from retrieval_bench import harness

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "retrieval_bench"
JAX = {"jax", "jaxlib", "flax", "shoeprint_image_retrieval_tpu"}
PROGRAM = "shoeprint_image_retrieval_torch"


def loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    mods = [f"retrieval_bench.{p.stem}" for p in HERE.glob("*.py") if p.stem != "__init__"]
    code = "\n".join(f"import {m}" for m in mods)
    code += ("\nimport shoeprint_image_retrieval_torch.retrieval.engine"
             "\nimport shoeprint_image_retrieval_torch.config")
    code += "".join(f"\nretrieval_bench.harness.load_file(__import__('pathlib').Path("
                    f"{str(p)!r}), 'retrieval_bench.{p.parent.name}.{p.stem}')"
                    for p in [*HERE.glob("metrics/*.py"), *HERE.glob("drivers/*.py")]
                    if p.stem != "__init__")
    assert not loaded_after(code) & JAX


def test_reference_loads_no_jax_and_no_program():
    mods = [f"retrieval_bench.reference.{p.stem}" for p in (HERE / "reference").glob("*.py")]
    got = loaded_after("\n".join(f"import {m}" for m in mods)
                       + "\nimport retrieval_bench.check, retrieval_bench.weights"
                       + "\nfor p in retrieval_bench.reference.backbones.NETS.glob('*.py'):"
                       + "\n    retrieval_bench.reference.backbones.architecture(p.stem)")
    assert not got & (JAX | {PROGRAM})


def test_no_source_names_jax_or_the_program_where_it_must_not():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.add(node.module.split(".")[0])
        assert not names & JAX, path
        if "reference" in path.parts or path.name in ("check.py", "weights.py", "flops.py"):
            assert PROGRAM not in names, path


def test_top_level_names_compared_whole():
    fake = dict.fromkeys(["shoeprint_image_retrieval_torch.ops", "jaxtyping", "os"])
    assert harness.forbidden_modules(fake) == []
    fake["jax.numpy"] = None
    fake["shoeprint_image_retrieval_tpu"] = None
    assert harness.forbidden_modules(fake) == ["jax", "shoeprint_image_retrieval_tpu"]


def test_benchmark_json_command_runs_the_harness():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "-m", "retrieval_bench.run"]

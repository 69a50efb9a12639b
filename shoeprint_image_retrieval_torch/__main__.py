"""Run shoeprint image retrieval with the PyTorch/CUDA port.

    python -m shoeprint_image_retrieval_torch [run.toml] [--device cuda|cpu]
    python -m shoeprint_image_retrieval_torch --parity [run.toml] [--device cuda|cpu]

Reads ``run.toml`` (or the given path), iterates size clusters and prints one
``S1 .. S20`` line per cluster with global denominators, as ``run.py`` does
for the JAX package. Runs on CUDA unless ``--device cpu`` is given. With
``--parity`` it runs the pipeline and the reference-semantics oracle on the
same dataset instead (``retrieval/parity.py``) and exits 1 on any rank
mismatch.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .config import load_config
from .metrics import cmp_all
from .retrieval.engine import Pipeline
from .retrieval.parity import run_parity

_SYNTHETIC = "SyntheticImpress"


def _ensure_dataset(config: dict) -> None:
    """Generate the synthetic Impress fixture the shipped configs point at
    when it is missing; any other missing dataset is a user error."""
    d = Path(config["dataset"]["dir"])
    if d.is_dir():
        return
    if _SYNTHETIC in d.parts:
        print(f"Dataset {d} not found - generating the synthetic Impress fixture "
              "(scripts/make_synthetic_impress.py)...")
        from scripts.make_synthetic_impress import generate

        generate(d)
        return
    raise SystemExit(
        f"Dataset directory {d} does not exist. Point [dataset].dir at a "
        "reference-layout dataset (Gallery/ + Query/)."
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch")
    parser.add_argument("config", nargs="?", default="run.toml")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--weights-dir", default="weights")
    parser.add_argument("--parity", action="store_true",
                        help="hold the pipeline's ranks against the oracle's; exit 1 on a mismatch")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    _ensure_dataset(config)
    if args.parity:
        raise SystemExit(run_parity(config, args.weights_dir, args.device))
    pipeline = Pipeline(config, weights_dir=args.weights_dir, device=args.device)
    for out in pipeline.run():
        print("Calculating ranks:")
        cmp_all(
            out.ranks.tolist(),
            total_shoeprints=len(pipeline.dataset.gallery_files),
            total_shoemarks=len(pipeline.dataset.query_files),
        )


if __name__ == "__main__":
    main()

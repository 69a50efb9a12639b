"""The port's parity harness (``retrieval/parity.py``, ``--parity``) on the CPU.

The tiny Impress fixture and seeded weights of ``tests/test_torch_pipeline.py``:
the pipeline's ranks must equal the reference-semantics oracle's, through
the function and through the CLI.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from shoeprint_image_retrieval_torch.__main__ import main as torch_main
from shoeprint_image_retrieval_torch.config import load_config
from shoeprint_image_retrieval_torch.retrieval.parity import run_parity

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import RUN_TOML, START_BLOCK, _make_dataset  # noqa: E402
from torch_effnet_replica import replica_v2m  # noqa: E402


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parity")
    _make_dataset(root / "data", np.random.default_rng(11))
    model = replica_v2m(seed=0)
    model.features = model.features[:START_BLOCK]
    wdir = root / "weights"
    wdir.mkdir()
    np.savez(wdir / "EfficientNetV2_M.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
    cfg = root / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=root / "data", start=START_BLOCK))
    return cfg, wdir


def test_run_parity_ranks_identical(setup, capsys):
    cfg, wdir = setup
    assert run_parity(load_config(cfg), weights_dir=str(wdir), device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("PARITY OK") == 2 and "PARITY: ranks identical" in out


def test_parity_cli_exits_zero(setup, capsys):
    cfg, wdir = setup
    with pytest.raises(SystemExit) as done:
        torch_main([str(cfg), "--parity", "--device", "cpu", "--weights-dir", str(wdir)])
    assert done.value.code == 0
    assert "Oracle CMC:" in capsys.readouterr().out

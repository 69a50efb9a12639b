"""Eight more configurations of the whole slice: the port's Pipeline against the JAX one.

Rotations only, scales only, neither, ``variant_mode = "full"``, RGB images,
a mixed gray/RGB set, the FID-300 layout with ``label_table.csv`` and
``probe_batch = 0``, each on the half-size dataset of
``tests/test_torch_pipeline.py``'s model-family cases (7 prints, 4 queries)
through one seeded EfficientNetV2_M replica checkpoint. Plans, ranks and
S-lines must be identical and scores within 1e-5; the port runs on the CPU.
"""

import csv
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from shoeprint_image_retrieval_tpu.metrics import cmp_all as jcmp
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.metrics import cmp_all as tcmp
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline as TPipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import (  # noqa: E402
    RUN_TOML, START_BLOCK, _export, _jax_run, _make_dataset, _s_lines)
from torch_effnet_replica import replica_v2m  # noqa: E402

CASES = ["rotations_only", "scales_only", "neither", "variant_full", "rgb", "mixed_gray_rgb",
         "fid300", "probe_batch_0"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("reanchor_weights")
    replica = replica_v2m(seed=0)
    replica.features = replica.features[:START_BLOCK]
    _export(replica, wdir / "EfficientNetV2_M.npz")
    return wdir


def _as_rgb(path: Path) -> None:
    """Rewrite a gray PNG as an RGB one whose channels differ."""
    im = np.asarray(Image.open(path))
    Image.fromarray(np.stack([im, np.roll(im, 3, axis=1), 255 - im], axis=-1)).save(path)


def _dataset(root: Path, case: str) -> str:
    """The half-size dataset, changed as ``case`` asks -> the dataset type."""
    _make_dataset(root, np.random.default_rng(12), n_gallery=7, n_query=4, size=0.5)
    files = sorted((root / "Gallery").iterdir()) + sorted((root / "Query").iterdir())
    if case == "rgb":
        for f in files:
            _as_rgb(f)
    elif case == "mixed_gray_rgb":
        for i, f in enumerate(files):
            if i % 2:
                _as_rgb(f)
    elif case == "fid300":
        # numeric names; the queries reach their prints through the table only
        for f in sorted((root / "Gallery").iterdir()):
            f.rename(f.with_name(f"{int(f.name.split('_')[0]):05d}.png"))
        rows = []
        for qi, f in enumerate(sorted((root / "Query").iterdir())):
            rows.append((101 + qi, int(f.name.split("_")[0])))
            f.rename(f.with_name(f"{101 + qi:05d}.png"))
        with (root / "label_table.csv").open("w", newline="") as fh:
            csv.writer(fh).writerows(rows)
        return "FID-300"
    return "Impress"


def _config(tmp_path: Path, case: str) -> Path:
    data = tmp_path / "data"
    ds_type = _dataset(data, case)
    text = (RUN_TOML.format(dir=data, start=START_BLOCK)
            .replace("minimum_dim = 40", "minimum_dim = 20")
            .replace('type = "Impress"', f'type = "{ds_type}"'))
    if case in ("scales_only", "neither"):
        text = text.replace("rotations = [9, 180]", 'rotations = ""')
    if case in ("rotations_only", "neither"):
        text = text.replace("scales = [1.04]", 'scales = ""')
    if case == "variant_full":
        text += 'variant_mode = "full"\n'
    if case == "probe_batch_0":
        text = text.replace("probe_batch = 2", "probe_batch = 0")
    cfg = tmp_path / "run.toml"
    cfg.write_text(text)
    return cfg


@pytest.mark.parametrize("case", CASES)
def test_port_matches_jax_pipeline_reanchor(tmp_path, weights, case):
    cfg = _config(tmp_path, case)
    (tmp_path / "weights").symlink_to(weights, target_is_directory=True)
    jp, j_out, j_scores = _jax_run(cfg)
    tp = TPipeline(tload(cfg), weights_dir=str(weights), verbose=False, device="cpu")
    t_out = list(tp.run())
    assert len(t_out) == len(j_out) >= 1
    assert sum(o.n_queries for o in t_out) == 4
    assert [(p.files, p.scale, p.block) for p in tp.plans] == [
        (p.files, p.scale, p.block) for p in jp.plans]
    for t, j, js in zip(t_out, j_out, j_scores):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        assert t.matching_pairs == j.matching_pairs
        np.testing.assert_allclose(t.scores, js, atol=1e-5, rtol=0)
        assert np.isfinite(t.scores).all() and (t.scores >= 0).all()
    if case == "probe_batch_0":  # the CPU keeps the TPU engine's 56 (all 4 queries here)
        assert tp.probe_batches == [o.n_queries for o in t_out]
    n_g, n_q = len(jp.dataset.gallery_files), len(jp.dataset.query_files)
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        for j in j_out:
            jcmp(j.ranks.tolist(), n_g, n_q)
    with redirect_stdout(got):
        for t in t_out:
            tcmp(t.ranks.tolist(), n_g, n_q)
    assert _s_lines(got.getvalue()) == _s_lines(want.getvalue()) != []

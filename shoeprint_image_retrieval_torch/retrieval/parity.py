"""Real-data parity harness: ``python -m shoeprint_image_retrieval_torch --parity``.

Runs the port's :class:`~.engine.Pipeline` and the reference-semantics
oracle (:mod:`.oracle`) on the same dataset and compares the ranks cluster
by cluster (the JAX package's ``retrieval/parity.py`` and ``run.py
--parity``). With real data and real weights (``weights/{model}.npz``):

    python -m shoeprint_image_retrieval_torch --parity run.toml

The oracle side is independent of the production path: PIL ingest
(``data.loader.load_one``), cv2's CLAHE per image as the reference applies
it (network.py:108-111, 197-208), extraction at each image's own shape with
batch 1 (no padding, no masking, reference network.py:210-244) and the
NumPy/SciPy FFT correlation of ``oracle.score_matrix`` with per-query
argsort ranks (reference similarity.py:26-108, 357-386). Only the backbone
and its weights are shared.

Exit status: 0 when every cluster's ranks match, 1 otherwise; both CMC
lines print either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import load_one
from ..metrics import cmp_all
from ..ops.preprocess import normalize_batch
from . import oracle


def _oracle_clahe(img: np.ndarray, clip_limit: float, tile_grid) -> np.ndarray:
    """cv2 CLAHE as the reference applies it (network.py:197-208): gray
    directly, RGB through the LAB L channel."""
    import cv2

    op = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=tuple(tile_grid))
    if img.ndim == 2:
        return op.apply(img)
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    l_ch, a_ch, b_ch = cv2.split(lab)
    return cv2.cvtColor(cv2.merge((op.apply(l_ch), a_ch, b_ch)), cv2.COLOR_LAB2RGB)


@torch.inference_mode()
def oracle_cluster_ranks(pipe, plan) -> tuple[np.ndarray, list[int]]:
    """Reference-semantics ranks for one cluster: ``(ranks, matching_pairs)``.

    The reference's run.py:17-34 body: the query cluster and the whole
    gallery at the cluster's scale, each image equalised and extracted at
    its own shape, scored by the oracle's NCC sweep, ranked by descending
    argsort.
    """
    config = pipe.config
    crop = config["dataset"]["crop"]
    clip = config["model"]["clahe_clip_limit"]
    grid = config["model"]["clahe_tile_grid_size"]
    model = pipe._model_for_block(plan.block)
    dev = pipe.device

    def native_maps(path) -> np.ndarray:
        eq = _oracle_clahe(load_one(path, plan.scale, crop), clip, grid)
        hw = torch.tensor([eq.shape[:2]], dtype=torch.int32, device=dev)
        x = normalize_batch(torch.from_numpy(np.ascontiguousarray(eq))[None].to(dev), hw,
                            pipe.spec.mean, pipe.spec.std)
        y, v = model(x, hw)
        v = v.cpu().numpy()
        return y[0].cpu().numpy()[:, : int(v[0, 0]), : int(v[0, 1])]

    q_files = sorted(plan.files)
    marks = [native_maps(pipe.dataset.query_dir / f) for f in q_files]
    prints = [native_maps(pipe.dataset.gallery_dir / f) for f in pipe.dataset.gallery_files]
    scores = oracle.score_matrix(
        marks, prints, config["comparison"]["rotations"], config["comparison"]["scales"],
        config["tpu"]["variant_mode"],
    )
    pairs = pipe.dataset.matching_pairs(q_files)
    return oracle.rank_queries(scores, pairs), pairs


def run_parity(config: dict, weights_dir: str | None = "weights",
               device: str | torch.device = "cuda") -> int:
    """The port's pipeline against the oracle on one dataset; 0 = ranks identical."""
    from .engine import Pipeline

    pipe = Pipeline(config, weights_dir=weights_dir, device=device)
    got_all: list[int] = []
    want_all: list[int] = []
    failures = 0
    try:
        for i, plan in enumerate(pipe.plans):
            print(f"Cluster has {len(plan.files)} items.")
            got = np.asarray(pipe.run_cluster(plan).ranks)
            want, _ = oracle_cluster_ranks(pipe, plan)
            got_all += got.tolist()
            want_all += want.tolist()
            if got.tolist() == want.tolist():
                print(f"cluster {i}: PARITY OK ({len(got)} queries)")
            else:
                failures += 1
                bad = np.nonzero(got != want)[0]
                print(f"cluster {i}: PARITY MISMATCH at query idx {bad.tolist()}: "
                      f"pipeline={got[bad].tolist()} oracle={want[bad].tolist()}")
    finally:
        pipe.close()
    g_total = len(pipe.dataset.gallery_files)
    q_total = len(pipe.dataset.query_files)
    print("Pipeline CMC:")
    cmp_all(got_all, total_shoeprints=g_total, total_shoemarks=q_total)
    print("Oracle CMC:")
    cmp_all(want_all, total_shoeprints=g_total, total_shoemarks=q_total)
    print("PARITY: " + ("ranks identical" if failures == 0 else
                        f"{failures} cluster(s) mismatched"))
    return 0 if failures == 0 else 1

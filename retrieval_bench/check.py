"""The comparison that decides ``correct``: the program's answers from the
window against the plain reference (``reference/``), recomputed from the
dataset's images and the run's weights, which the benchmark made.

After the window, a sample drawn from the seed of the marks the window
ranked is judged:

* ``plan``: the program's (scale, block) for the cluster against the
  reference's Algorithm 1 over the same header sizes (0 = equal);
* ``rank``: marks whose reported rank is not the rank of their true match
  in the program's own score row (the ranks layer; exact);
* ``score_gap``: the widest |program - reference| over every sampled
  (mark, print) pair: the reference ingests, equalises, normalises and
  extracts each image alone at its own size in float64, sweeps the mark's
  variants and correlates them with each print. The prints of a mark are
  its true match, the program's best-scoring prints and prints drawn from
  the seed. This covers ingest, CLAHE, normalisation, the backbone, the
  variant sweep, the NCC kernel and the max over variants.

The control is the reference computed in float32 with TF32 on (the
precision below the configurations' float32), put in the program's place:
:func:`judge` takes its scores for the sampled pairs instead of the
program's, with the same limits, and it has to come out not correct.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from .reference import backbones, ingest, ncc


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's and cuBLAS's TF32 switches for the block."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


class Reference:
    """Per-image features and scores, cached by file, in one dtype."""

    def __init__(self, dataset: Path, config: dict, weights: dict, scale: float, block: int,
                 dtype: torch.dtype, device: torch.device):
        self.dataset, self.config, self.scale = Path(dataset), config, scale
        model = config["model"]
        self.net = backbones.network(model["type"], block)
        self.mean, self.std = backbones.normalisation(self.net)
        self.weights = {k: v.to(device=device, dtype=dtype) for k, v in weights.items()}
        self.dtype, self.device = dtype, device
        self._maps: dict[str, torch.Tensor] = {}

    def maps(self, sub: str, name: str) -> torch.Tensor:
        """(C, h, w) features of ``{sub}/{name}``."""
        key = f"{sub}/{name}"
        if key not in self._maps:
            m, d = self.config["model"], self.config["dataset"]
            img = ingest.load(self.dataset / sub / name, self.scale, d["crop"])
            img = ingest.clahe(img, m["clahe_clip_limit"], m["clahe_tile_grid_size"])
            x = ingest.normalise(img, self.mean, self.std, self.dtype, self.device)
            with torch.inference_mode():
                self._maps[key] = backbones.forward(self.net, self.weights, x)[0]
        return self._maps[key]

    def scores(self, mark: str, prints: Sequence[str]) -> np.ndarray:
        comp = self.config["comparison"]
        gmaps, valid = ncc.prepare_prints([self.maps("Gallery", p) for p in prints])
        qmaps = self.maps("Query", mark).double().cpu().numpy()
        with torch.inference_mode():
            return ncc.mark_scores(qmaps, gmaps, valid, comp["rotations"] or [],
                                   comp["scales"] or [])


def sample(batches, seed: int, n_marks: int, n_prints: int, n_top: int):
    """[(file, program row, program rank, true index, print indices)] for
    ``n_marks`` marks drawn from the seed out of every batch's rows; each
    mark's prints: its true match, the program's ``n_top`` best, and prints
    drawn from the seed up to ``n_prints``."""
    rows = [(f, b.scores[i], int(b.ranks[i]), int(b.true_index[i]))
            for b in batches for i, f in enumerate(b.files)]
    rng = np.random.default_rng([seed, 7])
    picked = rng.choice(len(rows), size=min(n_marks, len(rows)), replace=False)
    out = []
    for j in sorted(picked):
        f, row, rank, true = rows[j]
        chosen = [true] + [int(g) for g in np.argsort(-row, kind="stable")[: n_top + 1]
                           if g != true][:n_top]
        rest = np.setdiff1d(np.arange(len(row)), chosen)
        chosen += [int(g) for g in rng.choice(rest, size=min(len(rest), n_prints - len(chosen)),
                                              replace=False)]
        out.append((f, row, rank, true, chosen))
    return out


def judge(picked, gallery_files: Sequence[str], reference: Reference,
          candidate: Reference | None = None) -> dict:
    """The numbers of :func:`sample`'s marks against ``reference``. With
    ``candidate`` (the control), its scores of the sampled pairs take the
    program's place in ``score_gap``."""
    gap, rank_bad, nonfinite = 0.0, 0, 0
    for f, row, rank, true, prints in picked:
        if not np.all(np.isfinite(row)):
            nonfinite += 1
        if rank != ncc.rank_of(row, true):
            rank_bad += 1
        names = [gallery_files[g] for g in prints]
        got = (row[prints].astype(np.float64) if candidate is None
               else candidate.scores(f, names))
        gap = max(gap, float(np.max(np.abs(got - reference.scores(f, names)))))
    return {"score_gap": gap, "rank": rank_bad, "nonfinite": nonfinite}


def plan_mismatch(program_plan, sizes, config: dict) -> tuple[int, float, int]:
    """(1 if the program's (scale, block) differs from the reference's
    Algorithm 1 over every image's header (width, height), else 0; the
    reference's scale and block)."""
    scale, block = ingest.scale_and_block(sizes, config["dataset"]["crop"], config["model"])
    same = abs(program_plan.scale - scale) < 1e-12 and program_plan.block == block
    return (0 if same else 1), scale, block

"""CPU oracle: reference-exact scoring semantics in NumPy/scipy.

The port's own verbatim copy of ``shoeprint_image_retrieval_tpu/retrieval/
oracle.py`` (the port imports nothing of the JAX package). It is ground
truth, not the production path: ``benchmarks/bench_10k.py`` holds a
subsample of its device scores against it. It reproduces the reference's
scoring math formula for formula:

* :func:`normxcorr` — FFT normalized cross-correlation
  (reference similarity.py:26-72),
* :func:`pair_similarity` — 2 px edge crop, per-channel NCC, channel sum,
  max / C (reference similarity.py:75-108),
* :func:`apply_transform_sweep` — PIL rotate (NEAREST, same canvas, 0-fill)
  and resize (BICUBIC) variant generation including the reference's variant
  composition: originals + {originals ∪ rotations} × scales, in which
  rotated-but-unscaled variants are never scored (reference
  similarity.py:230-353); ``mode="full"`` adds the corrected cross product,
* :func:`score_matrix` / :func:`rank_queries` — max-over-variants score
  matrix and descending-argsort ranks (reference similarity.py:357-386).
"""

from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
from PIL import Image
from scipy.signal import convolve

VariantMode = Literal["reference", "full"]


def normxcorr(template: np.ndarray, image: np.ndarray, mode: str = "same") -> np.ndarray:
    """Normalized cross-correlation of one channel pair (reference formulas)."""
    t0 = template - np.mean(template)
    p0 = image - np.mean(image)
    ones = np.ones(t0.shape)
    num = convolve(p0, np.flip(t0), mode=mode)
    local_sq = convolve(p0 * p0, ones, mode=mode)
    local_sum = convolve(p0, ones, mode=mode)
    energy = local_sq - (local_sum * local_sum) / t0.size
    energy[energy < 0] = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        out = num / np.sqrt(energy * np.sum(t0 * t0))
    out[~np.isfinite(out)] = 0
    return out


def pair_similarity(mark: np.ndarray, print_: np.ndarray) -> float:
    """Similarity of one (query, gallery) pair of (C, H, W) feature maps."""
    mark = mark[:, 2:-2, 2:-2]
    print_ = print_[:, 2:-2, 2:-2]
    n_maps = mark.shape[0]
    summed = np.zeros(print_.shape[1:], dtype=np.float64)
    for ch in range(n_maps):
        summed += normxcorr(mark[ch], print_[ch], "same")
    return float(np.max(summed) / n_maps)


def _rotate_nearest(maps: np.ndarray, degrees: float) -> np.ndarray:
    """PIL ``Image.rotate(deg)`` per channel: NEAREST, same canvas, 0-fill."""
    out = [np.asarray(Image.fromarray(ch).rotate(degrees)) for ch in maps]
    return np.stack(out)


def _resize_bicubic(maps: np.ndarray, scale: float) -> np.ndarray:
    """PIL ``Image.resize((int(w*s), int(h*s)))`` per channel: BICUBIC default."""
    h, w = maps.shape[1:]
    size = (int(w * scale), int(h * scale))
    out = [np.asarray(Image.fromarray(ch).resize(size)) for ch in maps]
    return np.stack(out)


def apply_transform_sweep(
    mark: np.ndarray,
    rotations: Sequence[float] | None,
    scales: Sequence[float] | None,
    mode: VariantMode = "reference",
) -> list[np.ndarray]:
    """All transform variants of one query's (C, H, W) feature maps.

    ``"reference"`` reproduces the reference's composition (reference
    similarity.py:321-353): [orig] + [x for x in [orig] + rotations] x scales
    when both sweeps are set — rotated-but-unscaled variants are dropped.
    ``"full"`` scores the complete cross product.
    """
    rots = list(rotations) if rotations is not None else []
    scls = list(scales) if scales is not None else []
    rotated = [mark] + [_rotate_nearest(mark, r) for r in rots]

    if mode == "reference":
        if rots and scls:
            return [mark] + [_resize_bicubic(m, s) for m in rotated for s in scls]
        if rots:
            return rotated
        if scls:
            return [mark] + [_resize_bicubic(mark, s) for s in scls]
        return [mark]
    # full cross product: every rotation at every scale incl. scale 1
    out = list(rotated)
    out += [_resize_bicubic(m, s) for m in rotated for s in scls]
    return out


def score_matrix(
    marks: Sequence[np.ndarray],
    prints: Sequence[np.ndarray],
    rotations: Sequence[float] | None = None,
    scales: Sequence[float] | None = None,
    mode: VariantMode = "reference",
) -> np.ndarray:
    """(Q, G) max-over-variants similarity matrix (reference similarity.py:357-367)."""
    scores = np.zeros((len(marks), len(prints)), dtype=np.float32)
    for qi, mark in enumerate(marks):
        for variant in apply_transform_sweep(mark, rotations, scales, mode):
            for gi, print_ in enumerate(prints):
                s = pair_similarity(variant, print_)
                if s > scores[qi, gi]:
                    scores[qi, gi] = s
    return scores


def rank_queries(scores: np.ndarray, matching_pairs: Sequence[int]) -> np.ndarray:
    """1-based rank of each query's true match (reference similarity.py:378-386)."""
    ranks = np.empty(len(scores), dtype=np.int32)
    for qi, row in enumerate(scores):
        order = np.flip(np.argsort(row))
        ranks[qi] = int(np.where(order == matching_pairs[qi])[0][0]) + 1
    return ranks

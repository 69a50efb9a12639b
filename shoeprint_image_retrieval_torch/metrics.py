"""Ranking and cumulative-match (S-score) metrics.

Same semantics and output as ``shoeprint_image_retrieval_tpu/metrics.py``:

* the rank of the true match is its 1-based position in the descending
  argsort of the query's score row (reference similarity.py:378-386);
* ``S_p`` is the fraction of queries ranked within ``p * total_shoeprints /
  100`` (not rounded), over ``total_shoemarks`` queries;
* :func:`cmp_all` prints one ``S1 .. S20`` line, x100 at 2 decimals.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def ranks_from_scores(scores: np.ndarray, matching_pairs: Sequence[int]) -> np.ndarray:
    """``(n_queries, n_gallery)`` scores -> ``(n_queries,)`` int32 1-based ranks."""
    scores = np.asarray(scores)
    order = np.flip(np.argsort(scores, axis=1), axis=1)  # descending
    pairs = np.asarray(matching_pairs)
    hit = order == pairs[:, None]
    return (np.argmax(hit, axis=1) + 1).astype(np.int32)


def cmp(rankings: Sequence[int], p: int, total_shoeprints: int, total_shoemarks: int) -> float:
    """Fraction of queries ranked within the top ``p`` % of the gallery."""
    z = (p * total_shoeprints) / 100
    return sum(1 for rank in rankings if rank <= z) / total_shoemarks


def s_line(scores: dict[int, float]) -> str:
    return (
        f"S1:{scores[1]:.2f} S5:{scores[5]:.2f} S10:{scores[10]:.2f} "
        f"S15:{scores[15]:.2f} S20:{scores[20]:.2f}"
    )


def cmp_all(rankings: Sequence[int], total_shoeprints: int, total_shoemarks: int) -> dict[int, float]:
    """Print the S1/S5/S10/S15/S20 line and return ``{p: score_percent}``."""
    out = {
        p: cmp(rankings, p, total_shoeprints, total_shoemarks) * 100
        for p in (1, 5, 10, 15, 20)
    }
    print(s_line(out))
    return out

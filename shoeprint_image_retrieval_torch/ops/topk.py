"""On-device rank extraction and top-k.

The port of ``shoeprint_image_retrieval_tpu/ops/topk.py``. The host path
(:func:`~..metrics.ranks_from_scores`) pulls the whole (Q, G) score matrix
and argsorts it (reference similarity.py:378-386); at a 10k-print gallery
that is 40x more bytes over the host link than the ranks themselves.

* :func:`ranks_on_device` counts instead of sorting: the true match's rank
  is ``1 + #{scores strictly above it} + #{exact ties at a larger column
  index}``. That is numpy's ``np.flip(np.argsort(row))`` order whenever the
  sort is stable, so it equals ``metrics.ranks_from_scores`` whenever the
  true match's score is untied, and under ties wherever numpy's sort is
  stable (always at small G). Under exact ties at large G numpy's order is
  unspecified, and this deterministic convention is the documented one.
* :func:`topk_on_device` is ``torch.topk`` (the port of ``lax.top_k``, which
  is no Pallas kernel) for O(Q*k) pulls of the top of each ranking.
"""

from __future__ import annotations

import torch


def ranks_on_device(scores: torch.Tensor, matching_pairs: torch.Tensor) -> torch.Tensor:
    """Exact 1-based true-match ranks of a (Q, G) score matrix, computed on
    its device by counting -> (Q,) int32.

    ``matching_pairs`` (Q,) holds each query's true-match column.
    """
    pairs = matching_pairs.to(device=scores.device, dtype=torch.int64)
    s_true = torch.gather(scores, 1, pairs[:, None])  # (Q, 1)
    above = (scores > s_true).sum(dim=1)
    g_idx = torch.arange(scores.shape[1], device=scores.device)[None, :]
    tied_after = ((scores == s_true) & (g_idx > pairs[:, None])).sum(dim=1)
    return (1 + above + tied_after).to(torch.int32)


def topk_on_device(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k score rows: (values (Q, k), gallery columns (Q, k) int32).

    ``torch.topk`` does not promise an order among tied scores; use
    :func:`ranks_on_device` for exact ranks.
    """
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)

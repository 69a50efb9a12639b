"""Exact-preserving pruned scoring (rank-only mode, ``tpu.pruned_scoring``).

The port's own copy of ``shoeprint_image_retrieval_tpu/retrieval/pruned.py``:
the same three passes, bound, margin, tie convention and statistics.

CMC reads only each query's true-match rank, so scoring every (query, print)
pair at full channel depth is wasted on pairs that provably rank below the
true match. :func:`pruned_ranks`:

* **pass 0** — the exact full-depth true-match scores ``t_q``, batch-
  diagonal: each block of ``batch0`` queries is scored against its own
  matched prints only;
* **pass 1** — every pair on the ``k`` channels of highest gallery variance
  (:func:`channel_order`): ``(k * s_k + (C - k)) / C`` bounds the full
  score, each of the other ``C - k`` channels adding at most ~1 (per-channel
  NCC is bounded by 1 at full-overlap shifts; ``margin`` covers partial-
  overlap border shifts and float error between backends);
* **pass 2** — prints whose bound clears ``t_q - margin`` for some query
  are scored exactly; the rank counts exact scores above the true pair's
  plus ties at larger gallery indices (``ops/topk.ranks_on_device``'s
  convention).
  A pruned pair scores ``<= bound < t_q - margin``, so dropping it cannot
  move the true match's rank.

The maps may be NumPy arrays or tensors, on the host or the device; every
pass slices prints and channels with index arrays of the maps' own kind, so
a gallery resident on the card is never brought to the host (only the
``sample`` prints :func:`channel_order` reads).

One deliberate difference from the JAX module: pass 2 counts against its
own score of the true pair where the true match survives (it always does
unless pass 0 and pass 1 disagree by more than the margin), and against
pass 0's ``t_q`` only otherwise. On the card a pair's last bits can follow
the call it is scored in (the CUDA kernel sums each 64-row tile's taps over
its own tap rectangle, and pass 0's blocks of ``batch0`` queries tile their
rows otherwise than pass 2 does), so a print within that difference of the
true match could rank on the wrong side of it against ``t_q``. Pass 2
batches the queries as the full path does, so its true-pair score is the
full path's. Where scores do not depend on the call (the CPU, the JAX
package's tests) both references are the same number.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..metrics import ranks_from_scores

Maps = np.ndarray | torch.Tensor
ScoreFn = Callable[[Maps, np.ndarray, Maps, np.ndarray], np.ndarray]


def _take(maps: Maps, index: np.ndarray, dim: int) -> Maps:
    """``maps`` at ``index`` along ``dim``, a copy of the same kind on the
    same device."""
    if isinstance(maps, torch.Tensor):
        return maps.index_select(dim, torch.as_tensor(index, device=maps.device))
    return np.take(maps, index, axis=dim)


def channel_order(g_maps: Maps, sample: int = 64) -> np.ndarray:
    """Channels by descending variance over the first ``sample`` prints.

    Any fixed order leaves full-depth scores and ranks unchanged; the
    prefix pass is tighter with the high-energy channels first. Computed on
    the host in float32 from a copy of the sample, as the JAX package does.
    """
    est = g_maps[: min(sample, len(g_maps))]
    if isinstance(est, torch.Tensor):
        est = est.float().cpu().numpy()
    est = np.asarray(est, np.float32)
    return np.argsort(-est.var(axis=(0, 2, 3)), kind="stable").astype(np.int32)


def true_match_scores(score_fn: ScoreFn, q_maps: Maps, q_valid: np.ndarray, g_maps: Maps,
                      g_valid: np.ndarray, matching_pairs: Sequence[int],
                      batch0: int = 32) -> tuple[np.ndarray, int]:
    """Pass 0: each query's full-depth score against its true match ->
    ((Q,) float32, pairs scored). Each block of ``batch0`` queries is scored
    against its own matched prints only, queries and prints both padded to
    ``batch0`` by repeating the last one, so every call has one shape."""
    pairs = np.asarray(matching_pairs, np.int64)
    q_valid, g_valid = np.asarray(q_valid), np.asarray(g_valid)
    n_q = len(pairs)
    batch0 = min(batch0, n_q)
    t = np.empty(n_q, np.float32)
    scored = 0
    for lo in range(0, n_q, batch0):
        hi = min(lo + batch0, n_q)
        uniq, inv = np.unique(pairs[lo:hi], return_inverse=True)
        qsel = np.minimum(np.arange(lo, lo + batch0), n_q - 1)
        gsel = uniq[np.minimum(np.arange(batch0), len(uniq) - 1)]
        s0 = score_fn(_take(q_maps, qsel, 0), q_valid[qsel], _take(g_maps, gsel, 0),
                      g_valid[gsel])
        t[lo:hi] = np.asarray(s0)[np.arange(hi - lo), inv]
        scored += (hi - lo) * len(uniq)
    return t, scored


def pruned_ranks(
    score_fn: ScoreFn,
    q_maps: Maps,
    q_valid: np.ndarray,
    g_maps: Maps,
    g_valid: np.ndarray,
    matching_pairs: Sequence[int],
    *,
    k: int = 0,
    margin: float = 5e-3,
    batch0: int = 32,
) -> tuple[np.ndarray, dict]:
    """Exact true-match ranks through bound-pruned scoring.

    ``score_fn(q_maps, q_valid, g_maps, g_valid) -> (Q', G')`` host scores:
    the engine's full scoring path on slices of the inputs. ``k`` is the
    prefix depth (0 = ``C // 8``), ``margin`` the slack under the prune
    threshold, ``batch0`` the pass-0 query block.

    Returns ``(ranks, stats)``: int32 1-based ranks equal to
    :func:`~..metrics.ranks_from_scores` on the full matrix, and
    ``prune_rate`` (share of (q, g) pairs not scored in pass 2),
    ``survivors`` (prints scored in pass 2), ``pair_frac`` (pairs scored
    over all passes against the full ``Q * G``, pass 1 weighted by
    ``k / C``) and ``k``.
    """
    pairs = np.asarray(matching_pairs, np.int64)
    n_q, c = q_maps.shape[:2]
    n_g = len(g_maps)
    k = min(int(k) or max(1, c // 8), c)
    if n_q == 0:
        return np.zeros(0, np.int32), {"prune_rate": 0.0, "survivors": n_g,
                                       "pair_frac": 0.0, "k": k}
    if k >= c:
        # the prefix is every channel: pass 1 is the exact matrix
        scores = score_fn(q_maps, q_valid, g_maps, g_valid)
        return ranks_from_scores(scores, pairs), {"prune_rate": 0.0, "survivors": n_g,
                                                  "pair_frac": 1.0, "k": k}

    perm = channel_order(g_maps)
    q_valid = np.asarray(q_valid)
    g_valid = np.asarray(g_valid)
    t, pairs0 = true_match_scores(score_fn, q_maps, q_valid, g_maps, g_valid, pairs, batch0)

    # pass 1: the channel-prefix bound over every pair
    ck = perm[:k]
    s_k = np.asarray(score_fn(_take(q_maps, ck, 1), q_valid, _take(g_maps, ck, 1), g_valid),
                     np.float32)
    bound = (k * s_k + (c - k)) / c
    keep = bound + np.float32(margin) >= t[:, None]
    surv = np.nonzero(keep.any(axis=0))[0]

    # pass 2: the survivors exactly; rank by counting
    if len(surv):
        s2 = np.asarray(score_fn(q_maps, q_valid, _take(g_maps, surv, 0), g_valid[surv]),
                        np.float32)
        # each query's reference: pass 2's own score of its true pair where
        # the true match survived, else pass 0's
        at = np.minimum(np.searchsorted(surv, pairs), len(surv) - 1)
        ref = np.where(surv[at] == pairs, s2[np.arange(n_q), at], t)[:, None]
        not_self = surv[None, :] != pairs[:, None]
        above = ((s2 > ref) & not_self).sum(axis=1)
        # equal scores rank in descending gallery index: ties at g > true count
        tied = ((s2 == ref) & not_self & (surv[None, :] > pairs[:, None])).sum(axis=1)
        ranks = (1 + above + tied).astype(np.int32)
    else:  # everything pruned: every true match ranks first
        ranks = np.ones(n_q, np.int32)

    pair_frac = (pairs0 + n_q * n_g * (k / c) + n_q * len(surv)) / max(1, n_q * n_g)
    return ranks, {"prune_rate": float(1.0 - keep.mean()), "survivors": int(len(surv)),
                   "pair_frac": float(pair_frac), "k": k}

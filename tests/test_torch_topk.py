"""The port's on-device ranks and top-k against the JAX package's.

The cases of ``tests/test_topk.py``: random matrices, the floored-zero ties
of the score floor, a tied true match, blocked accumulation. Ranks must be
identical, ties included; top-k values identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_tpu.metrics import ranks_from_scores
from shoeprint_image_retrieval_tpu.ops import topk as jtopk
from shoeprint_image_retrieval_torch.ops import topk as ttopk


def _both(scores: np.ndarray, pairs: np.ndarray):
    want = np.asarray(jtopk.ranks_on_device(jnp.asarray(scores), jnp.asarray(pairs)))
    got = ttopk.ranks_on_device(torch.from_numpy(scores), torch.from_numpy(pairs)).numpy()
    assert got.dtype == np.int32
    return got, want


@pytest.mark.parametrize("q,g", [(1, 5), (7, 33), (16, 300), (5, 1024)])
def test_ranks_match_jax_on_random_matrices(q, g):
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(q, g)).astype(np.float32)
    pairs = rng.integers(0, g, q).astype(np.int32)
    got, want = _both(scores, pairs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ranks_from_scores(scores, pairs))


def test_ranks_match_jax_with_floored_zero_ties():
    rng = np.random.default_rng(1)
    scores = np.maximum(rng.normal(size=(6, 40)), 0.0).astype(np.float32)
    assert (scores == 0.0).sum() > 40
    for pairs in (np.argmax(scores, axis=1), np.argmin(scores, axis=1)):  # untied, tied at 0
        got, want = _both(scores, pairs.astype(np.int32))
        np.testing.assert_array_equal(got, want)


def test_ranks_match_jax_with_true_match_tied():
    scores = np.asarray([[0.5, 0.9, 0.9, 0.1],
                         [0.9, 0.5, 0.9, 0.9]], np.float32)
    for pairs in ([1, 0], [2, 2], [0, 3], [2, 0]):
        pairs = np.asarray(pairs, np.int32)
        got, want = _both(scores, pairs)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ranks_from_scores(scores, pairs))


def test_ranks_match_jax_with_many_ties_at_large_g():
    """Exact ties at a gallery size where numpy's sort order is not
    promised: both packages follow the same counting convention."""
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 5, size=(8, 5000)).astype(np.float32) / 4
    pairs = rng.integers(0, 5000, 8).astype(np.int32)
    got, want = _both(scores, pairs)
    np.testing.assert_array_equal(got, want)


def test_blocked_accumulation_then_device_ranks():
    rng = np.random.default_rng(2)
    q, g, blk = 4, 64, 16
    scores = rng.normal(size=(q, g)).astype(np.float32)
    pairs = rng.integers(0, g, q).astype(np.int32)
    buf = torch.zeros((q, g))
    for lo in range(0, g, blk):
        buf[:, lo : lo + blk] = torch.from_numpy(scores[:, lo : lo + blk])
    got = ttopk.ranks_on_device(buf, torch.from_numpy(pairs)).numpy()
    _, want = _both(scores, pairs)
    np.testing.assert_array_equal(got, want)
    assert got.nbytes == q * 4


def test_topk_values_match_jax():
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(3, 50)).astype(np.float32)
    jv, ji = jtopk.topk_on_device(jnp.asarray(scores), 5)
    tv, ti = ttopk.topk_on_device(torch.from_numpy(scores), 5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))  # no ties here
    assert ti.dtype == torch.int32

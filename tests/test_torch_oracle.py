"""The port's copy of the CPU oracle against the JAX package's oracle.

The port keeps its own copy (it imports nothing of the JAX package); on the
same seeded inputs every function must give identical results.
"""

import numpy as np
import pytest

from shoeprint_image_retrieval_tpu.retrieval import oracle as joracle
from shoeprint_image_retrieval_torch.retrieval import oracle as toracle


def _maps(rng, n, c, lo, hi):
    return [rng.normal(size=(c, int(rng.integers(lo, hi)), int(rng.integers(lo, hi))))
            .astype(np.float32) for _ in range(n)]


def test_normxcorr_and_pair_similarity_identical():
    rng = np.random.default_rng(0)
    marks, prints = _maps(rng, 3, 4, 9, 14), _maps(rng, 4, 4, 12, 20)
    marks[1][2] = 0.0  # a flat channel: zero energy -> 0
    for m in marks:
        for p in prints:
            assert toracle.pair_similarity(m, p) == joracle.pair_similarity(m, p)
            np.testing.assert_array_equal(toracle.normxcorr(m[0], p[0]),
                                          joracle.normxcorr(m[0], p[0]))


@pytest.mark.parametrize("mode", ["reference", "full"])
def test_score_matrix_identical(mode):
    rng = np.random.default_rng(1)
    marks, prints = _maps(rng, 2, 3, 10, 14), _maps(rng, 3, 3, 14, 18)
    kw = dict(rotations=[9, 180], scales=[1.04], mode=mode)
    want = joracle.score_matrix(marks, prints, **kw)
    got = toracle.score_matrix(marks, prints, **kw)
    np.testing.assert_array_equal(got, want)
    variants_t = toracle.apply_transform_sweep(marks[0], [9], [1.04], mode)
    variants_j = joracle.apply_transform_sweep(marks[0], [9], [1.04], mode)
    assert len(variants_t) == len(variants_j)
    for vt, vj in zip(variants_t, variants_j):
        np.testing.assert_array_equal(vt, vj)


def test_rank_queries_identical():
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(6, 30)).astype(np.float32)
    scores[2, 7] = scores[2, 3]  # a tie
    pairs = rng.integers(0, 30, 6)
    np.testing.assert_array_equal(toracle.rank_queries(scores, pairs),
                                  joracle.rank_queries(scores, pairs))

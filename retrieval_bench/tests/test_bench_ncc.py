"""The reference's scores against a window-by-window float64 sum, on prints
with ReLU-silent stretches: a window that holds one value scores 0."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from retrieval_bench.reference import ncc


def brute_score(template: np.ndarray, prt: np.ndarray) -> float:
    """Each output position's window of the cropped, demeaned print, zero
    beyond it, against the cropped, demeaned template: two-pass sums; a
    window of one value scores 0."""
    t = torch.as_tensor(template[:, 2:-2, 2:-2], dtype=torch.float64)
    p = torch.as_tensor(prt[:, 2:-2, 2:-2], dtype=torch.float64)
    t0 = t - t.mean(dim=(1, 2), keepdim=True)
    p = p - p.mean(dim=(1, 2), keepdim=True)
    c, th, tw = t.shape
    _, hv, wv = p.shape
    win = F.unfold(F.pad(p, (tw // 2, (tw - 1) // 2, th // 2, (th - 1) // 2))[:, None], (th, tw))
    d = win - win.mean(dim=1, keepdim=True)
    term = (t0.reshape(c, -1, 1) * d).sum(1) / torch.sqrt(
        (d * d).sum(1) * (t0 * t0).sum(dim=(1, 2))[:, None])
    term = torch.where((win.amax(1) == win.amin(1)) | ~torch.isfinite(term), 0.0, term)
    return float(term.sum(0).max()) / c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_against_window_sums_with_silent_stretches(seed):
    rng = np.random.default_rng(seed)
    prt = np.maximum(rng.standard_normal((6, 30, 26)), 0) * rng.uniform(0.1, 3, (6, 1, 1))
    prt[:, :16] = 0
    prt[2] = 0                                    # a channel silent everywhere
    mark = np.maximum(rng.standard_normal((6, 16, 14)), 0)
    g, valid = ncc.prepare_prints([torch.as_tensor(prt)])
    got = float(ncc.pair_scores(mark, g, valid)[0])
    assert abs(got - brute_score(mark, prt)) < 1e-12


def test_constant_windows_found_exactly():
    x = torch.zeros(1, 1, 6, 7, dtype=torch.float64)
    x[0, 0, :3] = -0.1                            # not zero, and zero beyond the edge
    x[0, 0, 5, 6] = 1.0
    got = ncc.constant_windows(x, 3, 3)[0, 0]
    padded = F.pad(x, (1, 1, 1, 1))[0, 0]
    want = torch.tensor([[bool(padded[y:y + 3, c:c + 3].unique().numel() == 1)
                          for c in range(7)] for y in range(6)])
    assert torch.equal(got, want)
    assert got[1, 3] and not got[0, 3] and got[4, 2] and not got[4, 5]

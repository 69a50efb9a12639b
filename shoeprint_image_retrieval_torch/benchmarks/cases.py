"""Named scoring calls for the NCC kernel's measurements, built from a seed.

NumPy only, with no import from the package, so that a measurement can load
this file by path beside an older checkout of the package
(``benchmarks/ncc_ab.py``). ``kernel_probe.case_inputs`` turns the arrays
into the engine's operands.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Case(NamedTuple):
    """A scoring call built from a seed: ``prints`` prints of ``channels``
    channels, raw valid sizes drawn in ``print_h`` x ``print_w`` (inclusive)
    on a ``print_canvas``, and one probe of each size in ``probe_hw`` on a
    ``probe_canvas``, cut from a drawn print plus noise, so every probe has a
    true match."""

    channels: int
    prints: int
    print_h: tuple[int, int]
    print_w: tuple[int, int]
    print_canvas: tuple[int, int]
    probe_hw: tuple[tuple[int, int], ...]
    probe_canvas: tuple[int, int]


# fixture_c0: the synthetic fixture's cluster 0 (benchmarks/synthetic_impress.toml,
# EfficientNetV2_M block 4, stride 8, scale 1.0): its 15 queries' map sizes and
# the range of its 120 prints' as the port's planner and models/summary give
# them, on the canvases extraction pads them to (multiples of 8). The 48 x 40
# probe canvas makes a 51 x 43 template canvas (x 1.08), so a 47 x 39 kernel
# canvas over 84 x 68 cropped prints: the call the families' stride-8 clusters
# make too, at VGG16's C = 256, DenseNet-201's 128 and EfficientNet-B7's 80.
CASES = {
    "fixture_c0": Case(
        channels=80, prints=120, print_h=(72, 86), print_w=(59, 70), print_canvas=(88, 72),
        probe_hw=((40, 33), (44, 29), (46, 29), (36, 27), (39, 32), (42, 35), (41, 32), (37, 30),
                  (41, 34), (45, 32), (44, 32), (39, 32), (37, 33), (35, 30), (39, 29)),
        probe_canvas=(48, 40)),
}
QUICK_CASE = {"channels": 8, "prints": 6, "probes": 3}  # --quick: the canvases kept


def case_arrays(case: str | Case, quick: bool = False, channels: int | None = None,
                seed: int = 0) -> tuple[np.ndarray, ...]:
    """(gal (G, C, H, W), g_sizes (G, 2), qmaps (Q, C, hc, wc), q_sizes (Q, 2),
    truth (Q,)) of a :class:`Case` or of the named :data:`CASES` call: the
    prints height-sorted as the engine's cache sorts them, and each probe's
    true print. With ``quick``, :data:`QUICK_CASE`'s channels, prints and
    probes on the same canvases; ``channels`` overrides C."""
    if isinstance(case, str):
        case = CASES[case]
    g = QUICK_CASE["prints"] if quick else case.prints
    c = channels or (QUICK_CASE["channels"] if quick else case.channels)
    q_sizes = np.asarray(case.probe_hw[:QUICK_CASE["probes"]] if quick else case.probe_hw,
                         np.int32)
    rng = np.random.default_rng(seed)
    g_sizes = np.stack([rng.integers(case.print_h[0], case.print_h[1] + 1, g),
                        rng.integers(case.print_w[0], case.print_w[1] + 1, g)], 1).astype(np.int32)
    g_sizes = g_sizes[np.argsort(-g_sizes[:, 0], kind="stable")]
    gal = np.zeros((g, c, *case.print_canvas), np.float32)
    for i, (h, w) in enumerate(g_sizes):
        gal[i, :, :h, :w] = rng.normal(size=(c, h, w))
    truth = rng.integers(0, g, size=len(q_sizes))
    qmaps = np.zeros((len(q_sizes), c, *case.probe_canvas), np.float32)
    for i, (h, w) in enumerate(q_sizes):
        gh, gw = g_sizes[truth[i]]
        y0, x0 = rng.integers(0, gh - h + 1), rng.integers(0, gw - w + 1)
        qmaps[i, :, :h, :w] = gal[truth[i], :, y0:y0 + h, x0:x0 + w] + 0.5 * rng.normal(
            size=(c, h, w))
    return gal, g_sizes, qmaps, q_sizes, truth

"""The one traffic generator: a gallery of prints and a set of crime-scene
marks, written as an Impress-layout dataset, from a cell's parameters.

:func:`tread_print` and :func:`degrade` are frozen copies of
``scripts/make_synthetic_impress.py``'s: laboratory-style gray shoeprints
(banded tread, blob texture, elliptical sole) and noisy, occluded crops.
Extended here:

* every size is drawn from the cell's ``layout_seed`` and so is the same
  for every run seed: each print's (h, w), each mark's source print and the
  share of the print's sides it keeps. The work of a run (extraction and
  correlation FLOP) is therefore the same for every seed; the run's
  ``--seed`` draws the pixels (tread, texture, crop offset, degradation);
* prints are made in parallel over the host's cores, each from its own
  generator (``[seed, index]``), so the output does not depend on how the
  work is split;
* a dataset is kept under ``retrieval_bench/_cache/<key>/`` keyed by its
  parameters and seed, published by an atomic rename, and only the two
  newest are kept.

Layout (the reference's Impress convention): ``Dataset/Gallery/{gid}_1.jpg``
and ``Dataset/Query/{gid}_q{n}.jpg``, whose true match is print ``gid``.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np
from PIL import Image

CACHE = Path(__file__).resolve().parent / "_cache" / "datasets"
KEEP = 2  # datasets kept in the cache
JPEG_QUALITY = 92


def tread_print(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A shoeprint-like grayscale image: banded tread + blob noise + border."""
    # open grids: the same values as the original's dense np.mgrid, made
    # without the two (h, w) arrays
    y, x = (g.astype(np.float32) for g in np.ogrid[0:h, 0:w])
    img = np.zeros((h, w), np.float32)
    # tread bands at a random orientation/frequency mix
    for _ in range(int(rng.integers(2, 5))):
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(0.02, 0.09)
        phase = rng.uniform(0, 2 * np.pi)
        img += rng.uniform(0.4, 1.0) * np.sin(
            2 * np.pi * freq * (np.cos(theta) * x + np.sin(theta) * y) + phase
        )
    # blob texture: smoothed uniform noise (separable box blurs)
    noise = rng.uniform(-1, 1, size=(h, w)).astype(np.float32)
    for _ in range(3):
        noise = (
            np.roll(noise, 1, 0) + np.roll(noise, -1, 0)
            + np.roll(noise, 1, 1) + np.roll(noise, -1, 1) + 4 * noise
        ) / 8.0
    img += 1.5 * noise
    # elliptical sole mask
    cy, cx = h / 2, w / 2
    mask = ((y - cy) / (0.48 * h)) ** 2 + ((x - cx) / (0.45 * w)) ** 2 <= 1.0
    img = np.where(mask, img, img.min())
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return (img * 255).astype(np.uint8)


def degrade(rng: np.random.Generator, crop: np.ndarray) -> np.ndarray:
    """Crime-scene degradation: noise + random occlusion strips."""
    out = crop.astype(np.int32)
    out += rng.integers(-25, 26, size=out.shape)
    for _ in range(int(rng.integers(1, 4))):
        if rng.random() < 0.5:
            r0 = int(rng.integers(0, out.shape[0]))
            out[r0 : r0 + int(rng.integers(3, 12))] = int(rng.integers(0, 255))
        else:
            c0 = int(rng.integers(0, out.shape[1]))
            out[:, c0 : c0 + int(rng.integers(3, 12))] = int(rng.integers(0, 255))
    return np.clip(out, 0, 255).astype(np.uint8)


@dataclass(frozen=True)
class Layout:
    """Sizes fixed by ``layout_seed``: print (h, w) by gallery index, and
    per mark its source index and kept (h, w) share."""

    print_hw: list[tuple[int, int]]
    marks: list[tuple[int, float, float]]  # (source index, share of h, share of w)


def layout(traffic: dict) -> Layout:
    rng = np.random.default_rng(int(traffic["layout_seed"]))
    h_lo, h_hi = traffic["print_h"]
    w_lo, w_hi = traffic["print_w"]
    n = int(traffic["gallery"])
    hs = rng.integers(h_lo, h_hi, size=n)
    ws = rng.integers(w_lo, w_hi, size=n)
    lo, hi = traffic["mark_share"]
    src = rng.choice(n, size=int(traffic["marks"]), replace=False)
    fh = rng.uniform(lo, hi, size=len(src))
    fw = rng.uniform(lo, hi, size=len(src))
    return Layout([(int(h), int(w)) for h, w in zip(hs, ws)],
                  [(int(s), float(a), float(b)) for s, a, b in zip(src, fh, fw)])


def _make_print(args) -> None:
    """One print and the marks cut from it (a worker's task)."""
    root, seed, index, hw, marks = args
    rng = np.random.default_rng([seed, 0, index])
    img = tread_print(rng, *hw)
    gid = index + 1
    Image.fromarray(img).save(Path(root) / "Gallery" / f"{gid}_1.jpg", quality=JPEG_QUALITY)
    for qi, fh, fw in marks:
        mrng = np.random.default_rng([seed, 1, qi])
        ch, cw = int(hw[0] * fh), int(hw[1] * fw)
        y0 = int(mrng.integers(0, hw[0] - ch + 1))
        x0 = int(mrng.integers(0, hw[1] - cw + 1))
        crop = degrade(mrng, img[y0 : y0 + ch, x0 : x0 + cw])
        Image.fromarray(crop).save(Path(root) / "Query" / f"{gid}_q{qi}.jpg", quality=JPEG_QUALITY)


def dataset_key(traffic: dict, seed: int) -> str:
    fields = {k: traffic[k] for k in ("gallery", "print_h", "print_w", "marks", "mark_share",
                                      "layout_seed")}
    blob = json.dumps([fields, int(seed), JPEG_QUALITY], sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def generate(root: Path, traffic: dict, seed: int, workers: int) -> None:
    """Write the dataset of ``traffic`` and ``seed`` under ``root``."""
    lay = layout(traffic)
    by_source: dict[int, list] = {}
    for qi, (src, fh, fw) in enumerate(lay.marks):
        by_source.setdefault(src, []).append((qi, fh, fw))
    (root / "Gallery").mkdir(parents=True)
    (root / "Query").mkdir(parents=True)
    tasks = [(str(root), int(seed), i, hw, by_source.get(i, []))
             for i, hw in enumerate(lay.print_hw)]
    if workers <= 1:
        for t in tasks:
            _make_print(t)
        return
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(workers)
    try:
        for _ in pool.imap_unordered(_make_print, tasks, chunksize=8):
            pass
        pool.close()
    finally:
        pool.terminate()
        pool.join()


def dataset(traffic: dict, seed: int, workers: int | None = None,
            cache: Path | None = None) -> Path:
    """The dataset directory (``.../Dataset``) for ``traffic`` and ``seed``,
    made if the cache (default :data:`CACHE`) lacks it; the cache keeps the
    :data:`KEEP` newest."""
    cache = Path(cache or CACHE)
    cache.mkdir(parents=True, exist_ok=True)
    ignore = cache / ".gitignore"
    if not ignore.exists():
        ignore.write_text("*\n")
    final = cache / dataset_key(traffic, seed)
    if not (final / "Dataset").is_dir():
        tmp = cache / f"{final.name}.partial"
        shutil.rmtree(tmp, ignore_errors=True)
        generate(tmp / "Dataset", traffic, seed, workers or max(1, os.cpu_count() or 1))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
    os.utime(final)
    kept = sorted((p for p in cache.iterdir() if p.is_dir() and not p.name.endswith(".partial")),
                  key=lambda p: p.stat().st_mtime, reverse=True)
    for old in kept[KEEP:]:
        shutil.rmtree(old, ignore_errors=True)
    return final / "Dataset"


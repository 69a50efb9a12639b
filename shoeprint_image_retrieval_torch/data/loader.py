"""Host image ingest: decode, crop, Lanczos resize, canvas packing.

Per-image semantics are the reference's (reference dataloader.py:212-237):
crop ``floor(h*crop[0])`` / ``floor(w*crop[1])`` pixels from each edge, then
resize to ``(int(w*scale), int(h*scale))`` with PIL LANCZOS. Images are
zero-padded onto one uint8 canvas per batch; the valid sizes travel beside
it so masked extraction (``models/layers.py``) can treat the padding as the
conv's own zero padding.

:func:`load_images` serves a file set from the first of three tiers that
can take all of it (the JAX package's ``data/loader.py``), each bit-exact
against PIL's :func:`load_one`:

* ``native``: decode, crop and resize in one native call
  (:func:`~.native_ingest.ingest_files`; 8-bit gray JPEG/PNG, where the
  library was built with the codecs and its decode matched Pillow's);
* ``pil+native``: PIL decodes on a thread pool, the native library crops and
  resizes (mode ``L`` images only);
* ``pil``: PIL throughout.
"""

from __future__ import annotations

import math
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np
from PIL import Image

from . import native_ingest


def load_one(path: Path, scale: float, crop: Sequence[float]) -> np.ndarray:
    """Decode + crop + LANCZOS-resize one image to uint8."""
    try:
        with Image.open(path) as im:
            crop_h = math.floor(im.height * crop[0])
            crop_w = math.floor(im.width * crop[1])
            im = im.crop((crop_w, crop_h, im.width - crop_w, im.height - crop_h))
            new_w = int(im.width * scale)
            new_h = int(im.height * scale)
            im = im.resize((new_w, new_h), Image.Resampling.LANCZOS)
            return np.asarray(im)
    except (OSError, ValueError) as exc:
        raise RuntimeError(f"failed to ingest image {path}: {exc}") from exc


def _decode_gray(path: Path) -> np.ndarray | None:
    """The pixels of a mode-``L`` image, else ``None`` (other modes take
    the PIL tier: PIL resizes palette and bilevel images by other rules)."""
    try:
        with Image.open(path) as im:
            return np.asarray(im) if im.mode == "L" else None
    except (OSError, ValueError) as exc:
        raise RuntimeError(f"failed to ingest image {path}: {exc}") from exc


def load_images(
    directory: Path | str,
    files: Sequence[str],
    scale: float,
    crop: Sequence[float],
    n_threads: int = 8,
    tiers: Counter | None = None,
) -> list[np.ndarray]:
    """Ingest ``files`` in order through the first tier that takes them all;
    the tier's name is counted in ``tiers`` when one is given."""
    directory = Path(directory)

    def plan(h: int, w: int) -> tuple[tuple[int, int], tuple[int, int]]:
        """(crop_h, crop_w), (out_h, out_w) from the source (h, w)."""
        ch, cw = math.floor(h * crop[0]), math.floor(w * crop[1])
        return (ch, cw), (int((h - 2 * ch) * scale), int((w - 2 * cw) * scale))

    def served(tier: str, images: list[np.ndarray]) -> list[np.ndarray]:
        if tiers is not None:
            tiers[tier] += 1
        return images

    if native_ingest.decode_available():
        hdr = []
        for f in files:
            with Image.open(directory / f) as im:
                hdr.append((im.height, im.width))
        plans = [plan(h, w) for h, w in hdr]
        out = native_ingest.ingest_files([directory / f for f in files], hdr,
                                         [p[0] for p in plans], [p[1] for p in plans], n_threads)
        if out is not None:
            return served("native", out)

    with ThreadPoolExecutor(max_workers=max(1, n_threads)) as pool:
        decoded = list(pool.map(lambda f: _decode_gray(directory / f), files))
    if all(d is not None for d in decoded):
        plans = [plan(*d.shape) for d in decoded]
        return served("pil+native", native_ingest.crop_resize_batch(
            decoded, [p[0] for p in plans], [p[1] for p in plans], n_threads))

    with ThreadPoolExecutor(max_workers=max(1, n_threads)) as pool:
        return served("pil", list(pool.map(lambda f: load_one(directory / f, scale, crop), files)))


def canvas_bucket(hw_list: Sequence[tuple[int, int]], round_to: int = 64) -> tuple[int, int]:
    """The canvas for a set of (h, w) sizes: max per side, rounded up to
    ``round_to`` (the JAX package's shape-bucket rule, kept so both packages
    extract on the same canvases; the streamed path derives it from image
    headers with this same function)."""
    return (
        -(-max(h for h, _ in hw_list) // round_to) * round_to,
        -(-max(w for _, w in hw_list) // round_to) * round_to,
    )


def pack_canvas(
    images: Sequence[np.ndarray],
    canvas_hw: tuple[int, int] | None = None,
    round_to: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad images onto one canvas -> (batch u8, valid (B, 2) int32)."""
    if canvas_hw is None:
        canvas_hw = canvas_bucket([im.shape[:2] for im in images], round_to)
    extra = images[0].shape[2:]  # () for gray, (3,) for RGB
    batch = np.zeros((len(images), *canvas_hw, *extra), np.uint8)
    valid = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        batch[i, : im.shape[0], : im.shape[1]] = im
        valid[i] = im.shape[:2]
    return batch, valid

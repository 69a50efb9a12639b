"""Host image ingest: decode, crop, Lanczos resize, canvas packing.

Per-image semantics are the reference's (reference dataloader.py:212-237):
crop ``floor(h*crop[0])`` / ``floor(w*crop[1])`` pixels from each edge, then
resize to ``(int(w*scale), int(h*scale))`` with PIL LANCZOS. Images decode
on a thread pool (PIL releases the GIL) and are zero-padded onto one uint8
canvas per batch; the valid sizes travel beside it so masked extraction
(``models/layers.py``) can treat the padding as the conv's own zero padding.

The JAX package's loader also has a native C++ crop/resize tier that is
bit-exact against PIL; this port decodes and resizes with PIL only, which
gives the same pixels.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np
from PIL import Image


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


def load_images(
    directory: Path | str,
    files: Sequence[str],
    scale: float,
    crop: Sequence[float],
    n_threads: int = 8,
) -> list[np.ndarray]:
    """Parallel ingest preserving ``files`` order."""
    directory = Path(directory)
    with ThreadPoolExecutor(max_workers=max(1, n_threads)) as pool:
        return list(pool.map(lambda f: load_one(directory / f, scale, crop), files))


def canvas_bucket(hw_list: Sequence[tuple[int, int]], round_to: int = 64) -> tuple[int, int]:
    """The canvas for a set of (h, w) sizes: max per side, rounded up to
    ``round_to`` (the JAX package's shape-bucket rule, kept so both packages
    extract on the same canvases)."""
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

"""Plain ingest: decode, crop, resize, CLAHE and normalise one image.

The reference pipeline's per-image semantics (reference dataloader.py and
network.py): crop ``floor(h * crop[0])`` / ``floor(w * crop[1])`` pixels off
each edge, resize to ``(int(w * scale), int(h * scale))`` with PIL's
LANCZOS, equalise with OpenCV's CLAHE, scale to [0, 1], repeat a gray image
to three channels and normalise by the model's mean and std. Also the
reference's choice of (scale, block) for a set of image sizes, its
"Algorithm 1" (reference dataloader.py:366-464), for one cluster.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Sequence

import cv2
import numpy as np
import torch
from PIL import Image


def load(path: Path, scale: float, crop: Sequence[float]) -> np.ndarray:
    """Decode + crop + LANCZOS resize -> uint8 (H, W)."""
    with Image.open(path) as im:
        ch, cw = math.floor(im.height * crop[0]), math.floor(im.width * crop[1])
        im = im.crop((cw, ch, im.width - cw, im.height - ch))
        im = im.resize((int(im.width * scale), int(im.height * scale)), Image.Resampling.LANCZOS)
        return np.asarray(im)


def clahe(img: np.ndarray, clip: float, grid: Sequence[int]) -> np.ndarray:
    return cv2.createCLAHE(clipLimit=clip, tileGridSize=tuple(int(g) for g in grid)).apply(img)


def normalise(img: np.ndarray, mean, std, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """uint8 gray (H, W) -> (1, 3, H, W) in ``dtype``."""
    x = torch.as_tensor(img, device=device).to(dtype) / 255.0
    x = x[None, None].expand(1, 3, *x.shape)
    m = torch.tensor(mean, dtype=dtype, device=device)[None, :, None, None]
    s = torch.tensor(std, dtype=dtype, device=device)[None, :, None, None]
    return (x - m) / s


def _extremes(sizes: Sequence[tuple[int, int]], crop: Sequence[float]) -> tuple[int, int]:
    """(largest, smallest) side over crop-adjusted (width, height) sizes."""
    largest, smallest = 0, 2**31 - 1
    for w, h in sizes:
        h -= math.floor(h * crop[0] * 2)
        w -= math.floor(w * crop[1] * 2)
        largest = max(largest, w, h)
        smallest = min(smallest, w, h)
    return largest, smallest


def scale_and_block(sizes: Sequence[tuple[int, int]], crop: Sequence[float],
                    model: dict) -> tuple[float, int]:
    """Algorithm 1 over every (width, height) of a one-cluster run."""
    largest, smallest = _extremes(sizes, crop)
    minimum, block = model["minimum_dim"], model["start_block"]
    end, skip = model["end_block"], set(model["skip_blocks"])
    while True:
        if smallest < minimum:
            if block > end:
                block -= 1
                while block in skip:
                    block -= 1
                minimum = int(minimum / 2)
                continue
            return 1.0, block
        if largest > model["maximum_dim"]:
            scale = model["maximum_dim"] / largest
            if smallest * scale < minimum:
                if block > end:
                    block -= 1
                    while block in skip and block != end:
                        block -= 1
                else:
                    scale = minimum / smallest
            return scale, block
        return 1.0, block

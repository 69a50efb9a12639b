"""Gallery feature cache: per-(model, block, scale) features, RAM + disk.

The reference re-extracts the whole gallery for every cluster (reference
run.py:23-24). Here features for each (model, block, scale) are kept after
the first extraction and, with ``tpu.cache_dir`` set, spilled as ``.npz`` so
a warm start reloads instead of re-running the backbone.

Keys fingerprint the gallery file list (and, with ``gallery_dir``, each
file's size and mtime) plus the feature-affecting settings. They also carry
the framework: the JAX package may share ``cache_dir`` (the shipped configs
point both packages at one directory), and its seeded init gives other
features than this port's, so the two must never serve each other's maps.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Sequence

import numpy as np

FRAMEWORK = "torch"


class GalleryFeatureCache:
    def __init__(self, cache_dir: str | Path | None = None):
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._ram: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    @staticmethod
    def key(
        model_type: str,
        block: int,
        scale: float,
        gallery_files: Sequence[str],
        *,
        gallery_dir: str | Path | None = None,
        params: object = None,
    ) -> str:
        h = hashlib.sha256()
        for f in gallery_files:
            h.update(f.encode())
            if gallery_dir is not None:
                st = (Path(gallery_dir) / f).stat()
                h.update(f":{st.st_size}:{st.st_mtime_ns}".encode())
            h.update(b"\n")
        h.update(repr((FRAMEWORK, params)).encode())
        listing = h.hexdigest()[:12]
        return f"{FRAMEWORK}_{model_type}_b{block}_s{scale:.6f}_{listing}"

    def get(self, key: str) -> tuple[np.ndarray, np.ndarray] | None:
        if key in self._ram:
            return self._ram[key]
        if self.cache_dir:
            path = self.cache_dir / f"{key}.npz"
            if path.exists():
                with np.load(path) as z:
                    entry = (z["maps"], z["valid"])
                self._ram[key] = entry
                return entry
        return None

    def put(self, key: str, maps: np.ndarray, valid: np.ndarray) -> None:
        maps = np.asarray(maps)
        valid = np.asarray(valid)
        self._ram[key] = (maps, valid)
        if self.cache_dir:
            tmp = self.cache_dir / f"{key}.tmp.npz"  # np.savez keeps the .npz suffix
            np.savez(tmp, maps=maps, valid=valid)
            tmp.rename(self.cache_dir / f"{key}.npz")  # atomic publish

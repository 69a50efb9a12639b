"""Gallery feature cache: per-(model, block, scale) features, RAM + disk.

The reference re-extracts the whole gallery for every cluster (reference
run.py:23-24). Here features for each (model, block, scale) are kept after
the first extraction and, with ``tpu.cache_dir`` set, spilled as ``.npz`` so
a warm start reloads instead of re-running the backbone.

Maps that extraction left on the pipeline's device are kept in RAM as that
tensor, so a standing gallery's later clusters score from the device
without a copy; the tensors kept take at most the budget the engine passes
(``engine._device_maps_budget``), and past it the oldest go to the host.
Maps on the host, a disk copy and what a disk hit loads are NumPy arrays.

Keys fingerprint the gallery file list (and, with ``gallery_dir``, each
file's size and mtime) plus the feature-affecting settings. They also carry
the framework: the JAX package may share ``cache_dir`` (the shipped configs
point both packages at one directory), and its seeded init gives other
features than this port's, so the two must never serve each other's maps.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

FRAMEWORK = "torch"


class GalleryFeatureCache:
    def __init__(self, cache_dir: str | Path | None = None):
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        # insertion order is age: the oldest device entry leaves first
        self._ram: dict[str, tuple[np.ndarray | torch.Tensor, np.ndarray]] = {}
        # a lookahead thread may put while the calling thread gets
        self._lock = threading.Lock()

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

    def get(self, key: str) -> tuple[np.ndarray | torch.Tensor, np.ndarray] | None:
        with self._lock:
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

    def device_bytes(self) -> int:
        """Bytes of the maps kept as device tensors."""
        return sum(m.nbytes for m, _ in self._ram.values() if isinstance(m, torch.Tensor))

    def put(self, key: str, maps: np.ndarray | torch.Tensor, valid: np.ndarray,
            device_budget: int = 0) -> None:
        """Keep ``maps`` (a NumPy array, or a tensor on the pipeline's
        device) and ``valid`` under ``key``. A tensor is kept as it is while
        the tensors kept, this one included, take at most ``device_budget``
        bytes; past it the oldest are moved to the host as NumPy copies
        until they fit (this one too where it alone does not). The disk
        copy is written from the host."""
        valid = np.asarray(valid)
        with self._lock:
            self._ram.pop(key, None)
            self._ram[key] = (maps, valid)
            for k in list(self._ram):
                if self.device_bytes() <= device_budget:
                    break
                m, v = self._ram[k]
                if isinstance(m, torch.Tensor):
                    self._ram[k] = (m.cpu().numpy(), v)
            host = self._ram[key][0]
        if self.cache_dir:
            if isinstance(host, torch.Tensor):
                host = host.cpu().numpy()
            tmp = self.cache_dir / f"{key}.tmp.npz"  # np.savez keeps the .npz suffix
            np.savez(tmp, maps=host, valid=valid)
            tmp.rename(self.cache_dir / f"{key}.npz")  # atomic publish

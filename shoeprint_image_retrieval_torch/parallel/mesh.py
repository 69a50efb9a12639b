"""The device mesh and the gallery axis's padding.

The port of ``shoeprint_image_retrieval_tpu/parallel/mesh.py``. The JAX
engine is one process that shards the gallery over the local devices it
sees (a 1-D ``jax.sharding.Mesh``, axis :data:`GALLERY_AXIS`). Here the mesh
is the same thing within one process: an ordered tuple of torch devices.
Each device scores every probe variant against its shard of the gallery,
and the score rows are copied to the :attr:`Mesh.primary` device (the JAX
``all_gather``), as single-host multi-GPU retrieval shards an index.

Devices may repeat. ``[cuda:0] * 4`` runs four shards on one card, and
``[cpu] * 8`` runs eight on the CPU: the counterpart of the JAX suite's
eight virtual CPU devices. The sharded code, and on a card the NCC kernel
on each shard, then run where only one device exists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

GALLERY_AXIS = "gallery"
# the valid size (after the edge crop) of a pad print: zero content there
# gives zero window energy, so the print scores exactly 0
PAD_VALID = 8


def normal_device(dev: str | torch.device) -> torch.device:
    """``dev`` with its index: ``cuda`` is the current CUDA device."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the gallery's shard ``i`` lives on ``devices[i]``."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """Where score rows are gathered and ranks are made."""
        return self.devices[0]

    def distinct(self) -> tuple[torch.device, ...]:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def visible_devices(device_type: str = "cuda") -> list[torch.device]:
    """Every visible CUDA device for ``"cuda"``; the CPU alone for ``"cpu"``."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def build_mesh(n_devices: int = 0, devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (0 = all of them).

    Without ``devices``: ``cuda:0 .. cuda:n-1`` where a card is visible,
    else the CPU alone. ``devices`` may repeat a device.
    """
    if devices is None:
        devices = visible_devices("cuda" if torch.cuda.is_available() else "cpu")
    pool = [normal_device(d) for d in devices]
    n = n_devices or len(pool)
    if not 0 < n <= len(pool):
        raise ValueError(f"a mesh of {n} devices from a list of {len(pool)}")
    return Mesh(tuple(pool[:n]))


def pad_gallery_cache(cache, n_shards: int):
    """Pad a gallery cache's gallery axis to a multiple of ``n_shards``.

    Works for both cache layouts (``ops/ncc.GalleryCache`` and
    ``ops/ncc_direct.DirectGalleryCache``): every channel-major field holds
    the gallery on axis 1, ``valid_hw`` on axis 0. Pad prints are zero with
    a valid size of :data:`PAD_VALID`, so their NCC scores are exactly 0
    (zero local energy gives a zero ratio, the reference's convention,
    similarity.py:65-71) and never outrank a real print. Returns (padded
    cache, the gallery's own size).
    """
    g = cache.valid_hw.shape[0]
    extra = -(-g // n_shards) * n_shards - g
    if not extra:
        return cache, g

    def pad_field(name: str, a: torch.Tensor) -> torch.Tensor:
        if name == "valid_hw":
            return torch.cat([a, a.new_full((extra, 2), PAD_VALID)])
        # F.pad's pairs run from the last axis: zeros after axis 1
        return F.pad(a, [0, 0] * (a.ndim - 2) + [0, extra])

    return type(cache)(**{k: pad_field(k, v) for k, v in cache._asdict().items()}), g

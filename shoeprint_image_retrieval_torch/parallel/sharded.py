"""Gallery-sharded NCC scoring over a mesh of devices, in one process.

The port of ``shoeprint_image_retrieval_tpu/parallel/sharded.py``. The JAX
package runs each shard's scoring inside one ``shard_map`` program and
gathers the score rows with one tiled ``all_gather``. Here each shard's
work is issued on its own device: its cache lies there, and the probe
stack, the window tables and the NCC kernel's row plan are copied there
once per distinct device (``.to`` a tensor's own device is no copy, so a
mesh that repeats one device holds one stack). The host issues every
shard before it waits for any, so shards on distinct cards overlap. Each
shard's rows are then copied to :attr:`~.mesh.Mesh.primary` and
concatenated in mesh order, which is the tiled ``all_gather``'s order, and
the pad columns are sliced off.

The engine scores through these on every mesh, one device being a mesh of
one. Each (variant, print) score is computed on one device: on a card by
the NCC kernel (``ops/ncc_kernel.score_ncc``, either leg) once per shard,
or by its plain version. A pair's
last bits follow its call's tile plan (up to ~6e-8 between calls on the
H100), so sharded scores agree with unsharded ones to float tolerance and
their ranks exactly.

Not carried over: ``make_sharded_direct_scorer`` (JAX's list of variant
groups; the packed scorer takes the same templates as a packed stack), and,
having no meaning here, the JAX memos of jitted programs
(``_fft_scorer_impls``, ``_packed_scorer_impls``: nothing is compiled per
shape), ``interpret`` (the Pallas interpreter: on the CPU the plain version
runs), ``use_epi`` (the TPU energy epilogue), ``class_canvas_hw`` and
``kernel_hw`` (the TPU operand packing: the kernel reads each shard's cache
as it is) and ``channel_block`` (the FFT backend's block is fixed).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.boxsum import EDGE_CROP
from ..ops.ncc import GalleryCache, score_templates
from ..ops.ncc_direct import (
    DirectGalleryCache,
    PackedVariants,
    VariantLayout,
    score_direct,
)
from ..ops.ncc_kernel import (
    PrintPlan,
    RowPlan,
    host_row_hw,
    kernel_tile,
    print_plan,
    row_plan,
    score_ncc,
)
from ..utils.tracing import span
from .mesh import PAD_VALID, Mesh, pad_gallery_cache


def shard_cache(cache, mesh: Mesh):
    """Pad a gallery cache to a multiple of the mesh and split it: shard
    ``i`` is the contiguous slice ``i`` of the padded gallery axis, on
    ``mesh.devices[i]``. Both cache layouts. -> (shards, gallery size)."""
    padded, g_true = pad_gallery_cache(cache, mesh.size)
    k = padded.valid_hw.shape[0] // mesh.size

    def part(name: str, a: torch.Tensor, i: int) -> torch.Tensor:
        a = a[i * k : (i + 1) * k] if name == "valid_hw" else a[:, i * k : (i + 1) * k]
        return a.to(mesh.devices[i]).contiguous()

    shards = [type(cache)(**{name: part(name, a, i) for name, a in padded._asdict().items()})
              for i in range(mesh.size)]
    return shards, g_true


def shard_valid(valid: np.ndarray, n: int) -> list[np.ndarray]:
    """Pre-crop valid sizes (G, 2) split into ``n`` shards of ``ceil(G /
    n)`` prints, the last filled with pad prints' (int32, on the host): the
    valid sizes :func:`build_sharded_cache` gives its shards."""
    g = len(valid)
    k = -(-g // n)
    padded = np.full((k * n, 2), PAD_VALID + 2 * EDGE_CROP, np.int32)
    padded[:g] = valid
    return [padded[i * k : (i + 1) * k] for i in range(n)]


def build_sharded_cache(build: Callable, maps: torch.Tensor, valid: np.ndarray, mesh: Mesh,
                        index: torch.Tensor | None = None):
    """The shards :func:`shard_cache` makes of ``build(maps, valid)``, each
    built on its own device from its own slice of the block: no unsharded
    cache is made beside the sharded one.

    ``maps`` (G, C, H, W) wherever they lie (host or a device), or with
    ``index`` the block is ``maps[index]`` (a height-sorted block); ``valid``
    (G, 2) pre-crop valid sizes on the host. A shard short of its size is
    filled with zero prints of valid size :data:`~.mesh.PAD_VALID` after the
    crop, which score exactly 0. -> (shards, gallery size).

    Each shard's slice is the span ``gather`` (the host gather of maps at
    rest on the host; only the enqueue of maps on a device), its move to
    the shard's device and the pad the span ``copy``: inside the engine's
    ``cache`` stage, ``cache.gather`` and ``cache.copy``
    (``utils/tracing.span``).
    """
    g = len(valid)
    k = -(-g // mesh.size)
    shards = []
    for i, (dev, v) in enumerate(zip(mesh.devices, shard_valid(valid, mesh.size))):
        lo, hi = min(i * k, g), min((i + 1) * k, g)
        with span("gather"):
            part = maps[lo:hi] if index is None else maps.index_select(0, index[lo:hi])
        with span("copy"):
            part = part.to(dev).float()
            if hi - lo < k:
                part = torch.cat([part, part.new_zeros((k - (hi - lo), *part.shape[1:]))])
        shards.append(build(part, torch.as_tensor(v, device=dev)))
    return shards, g


def _replicas(t: torch.Tensor | None, mesh: Mesh) -> dict:
    """``t`` on each distinct device of the mesh, copied once a device."""
    return {dev: None if t is None else t.to(dev, non_blocking=True) for dev in mesh.distinct()}


def _gather(parts: Sequence[torch.Tensor], mesh: Mesh, g_true: int | None) -> torch.Tensor:
    """Each shard's (N, G/n) rows on the primary device, in mesh order, the
    pad columns sliced off: the JAX tiled ``all_gather``."""
    rows = torch.cat([p.to(mesh.primary, non_blocking=True) for p in parts], dim=1)
    return rows if g_true is None else rows[:, :g_true]


def make_sharded_scorer(mesh: Mesh, shards: Sequence[GalleryCache], *, true_channels: int,
                        g_true: int | None = None):
    """(templates, template valid sizes) -> (V, G) FFT scores over the mesh
    (``ops/ncc.score_templates`` on each shard)."""

    def score(templates: torch.Tensor, tvalid) -> torch.Tensor:
        tvalid = tvalid.cpu().numpy() if isinstance(tvalid, torch.Tensor) else np.asarray(tvalid)
        per_dev = _replicas(templates, mesh)
        parts = [score_templates(s, per_dev[dev], tvalid, true_channels=true_channels)
                 for s, dev in zip(shards, mesh.devices)]
        return _gather(parts, mesh, g_true)

    return score


def make_sharded_packed_builder(mesh: Mesh, build_kernels: Callable,
                                class_counts: Sequence[int], pb: int):
    """Probe-sharded build of a batch's class-major variant stack.

    Each device builds ``pb / n`` probes' variants (``build_kernels`` of
    their slices of the batch's inputs: class-major rows over those probes);
    the global stack is rebuilt on the primary device class by class, each
    class the shards' segments of it in mesh order, which is the probe
    order. ``pb`` must divide by the mesh size: the engine rounds its batch
    down to a multiple and keeps the replicated build when ``pb`` is smaller
    than the mesh. -> ``build(maps, valid, rot_idx, rot_ok, wv, wh,
    scale_hw, windows)`` -> :class:`PackedVariants` on the primary device.
    """
    n = mesh.size
    if pb % n:
        raise ValueError(f"probe batch {pb} not divisible by mesh size {n}: the per-class "
                         "gather would reassemble misaligned probe rows")
    pb_local = pb // n

    def build(*inputs: torch.Tensor) -> PackedVariants:
        *tables, windows = inputs
        parts = [build_kernels(*(t[i * pb_local : (i + 1) * pb_local].to(dev, non_blocking=True)
                                 for t in tables))
                 for i, dev in enumerate(mesh.devices)]
        segs, off = [], 0
        for cnt in class_counts:
            rows = pb_local * cnt
            segs += [p[off : off + rows].to(mesh.primary, non_blocking=True) for p in parts]
            off += rows
        return PackedVariants(torch.cat(segs), windows)

    return build


def make_sharded_packed_scorer(
    mesh: Mesh,
    shards: Sequence[DirectGalleryCache],
    *,
    true_channels: int,
    layout: VariantLayout,
    g_true: int | None = None,
    use_kernel: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    prints: Sequence[PrintPlan] | None = None,
):
    """(packed, slot_hw, slot_map[, rows]) -> (N, G) scores over the mesh.

    Each shard is scored where it lies: with ``use_kernel`` by
    ``ops/ncc_kernel.score_ncc`` (on a card the NCC kernel, the leg of
    ``compute_dtype``, launched once per shard on that shard's device; on
    the CPU its plain version), else by the plain ``score_direct``. The
    kernel's tile plan: ``prints``, each shard's :func:`print_plan` (the
    engine makes them from :func:`shard_valid`'s host sizes; made here from
    the shards' valid sizes if not given, which waits for the device), and
    ``rows``, the batch's :func:`row_plan` on any device (made here from
    host copies of the window tables if not given), its table copied once
    to each distinct device.
    """
    on_card = use_kernel and shards[0].p0.device.type == "cuda"
    tile = kernel_tile() if on_card else None
    if on_card and prints is None:
        prints = [print_plan(s.valid_hw.cpu().numpy(), tile.positions) for s in shards]

    def score(packed: PackedVariants, slot_hw: torch.Tensor | None = None,
              slot_map: torch.Tensor | None = None, rows: RowPlan | None = None) -> torch.Tensor:
        kern = _replicas(packed.kernels.contiguous(), mesh)
        win, shw, smap = (_replicas(t, mesh) for t in (packed.window_hw, slot_hw, slot_map))
        if on_card:
            if rows is None:
                host = [None if t is None else t.cpu().numpy()
                        for t in (packed.window_hw, slot_hw, slot_map)]
                rows = row_plan(host_row_hw(host[0], layout, *host[1:]),
                                packed.kernels.shape[-2:], tile.rows, mesh.primary)
            plans = {dev: rows._replace(table=t) for dev, t in _replicas(rows.table, mesh).items()}
        parts = []
        for i, (s, dev) in enumerate(zip(shards, mesh.devices)):
            pk = PackedVariants(kern[dev], win[dev])
            if use_kernel:
                plan = (plans[dev], prints[i]) if on_card else None
                parts.append(score_ncc(s, pk, layout, true_channels, shw[dev], smap[dev],
                                       plan=plan, compute_dtype=compute_dtype))
            else:
                parts.append(score_direct(s, pk, layout, true_channels, shw[dev], smap[dev],
                                          compute_dtype=compute_dtype))
        return _gather(parts, mesh, g_true)

    return score


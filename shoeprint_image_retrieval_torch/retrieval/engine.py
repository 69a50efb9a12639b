"""The retrieval pipeline on one device, cluster at a time.

The port of the single-device main path of ``shoeprint_image_retrieval_tpu/
retrieval/engine.py`` (reference run.py:17-34 + similarity.py:129-375):

* host ingest through the loader's tiers (``data/loader.py``: native decode
  + crop/resize, PIL decode + native crop/resize, or PIL) and native CLAHE
  (``data/native_ingest``); where the native CLAHE cannot take a set exactly
  (``tpu.clahe_host = false``, non-uint8 images, images smaller than the tile
  grid) CLAHE runs on the device inside the extraction step (``ops/clahe``);
* normalisation and masked batched extraction through the truncated
  backbone (``ops/preprocess.py``, ``models/``), streamed where the host
  CLAHE applies: a worker thread ingests chunk i+1 while the device extracts
  chunk i (:meth:`Pipeline._extract_streamed`);
* with ``tpu.pipeline_clusters``, cluster k+1's ingest and extraction on a
  lookahead thread while cluster k scores; with ``tpu.prewarm`` on a card,
  the NCC kernel's build on a thread from the moment the pipeline is made;
  with ``tpu.profile_dir``, one ``torch.profiler`` trace per cluster, every
  thread's ranges in it;
* extracted maps kept on the device wherever they fit a share of its free
  memory (:func:`_device_maps_budget`), and kept there for later clusters
  by the gallery feature cache (``retrieval/gallery.py``), so a standing
  gallery is scored from the card without a copy (``Pipeline.maps_at_rest``
  says where each scoring call found them);
* the gallery cache: demeaned prints + integral images of the
  height-sorted gallery, built per block of ``tpu.gallery_block`` prints
  (``ops/ncc_direct.build_direct_cache``; 0 = the largest block that fits
  the card's free memory, one block on the CPU);
* per probe batch, a class-major variant stack (PIL-exact rotation gathers
  and bicubic scale matrices, ``ops/warp.py``) scored by the fused NCC
  kernel (``ops/ncc_kernel.score_ncc``); max over variants floored at 0;
* host ranks and the S-line (``metrics.py``), or with
  ``tpu.rank_on_device`` the scores left on the device and ranked there
  (:class:`DeviceScores`, ``ops/topk.py``);
* with ``tpu.ncc_backend = "fft"``, the reference's FFT correlation instead
  of the direct cache and kernel: one FFT cache per gallery block and each
  probe's unfolded variant stack (``ops/ncc.py``,
  :meth:`Pipeline._score_cluster_fft`);
* with ``tpu.fusion_blocks``, each cluster scored once per listed block at
  its planned scale and the matrices summed; with ``tpu.pruned_scoring``,
  exact ranks from a channel-prefix bound (``retrieval/pruned.py``);
* with ``tpu.precision = "bfloat16"``, the backbone convs on bf16 operands
  (``models/layers.conv_route``, bound on the models the pipeline builds)
  and the direct scorer's correlation on operands rounded to bf16 (the NCC
  kernel's bf16 leg on a card); with ``tpu.cache_dtype = "bfloat16"``, the
  gallery maps at rest on the host held in bf16 and widened on the device a
  gallery block at a time;
* with ``tpu.mesh_shape`` (0 = every visible CUDA device, one on the CPU),
  the gallery sharded over a mesh of devices in this one process
  (``parallel/``; :class:`Pipeline`'s ``mesh_devices`` names them, repeats
  allowed): extraction chunks split over the devices, one backbone replica
  per distinct device; each gallery block's cache built shard by shard on
  the shards' devices, each probe batch's stack built probe-sharded where
  the batch divides by the mesh, every shard scored on its device and the
  rows gathered to the first. One device is a mesh of one: the same path.

Not carried over (ROADMAP.md, 'Not carried over'): the TPU sizing helpers.
"""

from __future__ import annotations

import copy
import math
import os
import threading
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from functools import partial
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch
from PIL import Image

from ..config import check_supported
from ..data import native_ingest
from ..data.discovery import Dataset, parse_image_id
from ..data.loader import canvas_bucket, load_images, pack_canvas
from ..data.planner import PlannerConfig, plan_clusters, read_header_sizes
from ..device import free_bytes, resolve_device
from ..metrics import ranks_from_scores
from ..models.layers import conv_route, set_conv_precision
from ..models.registry import get_backbone
from ..models.weights import build_model
from ..ops.boxsum import EDGE_CROP
from ..ops.clahe import clahe_batched_dynamic, lab_u8_to_rgb, rgb_to_lab_u8
from ..ops.ncc import build_gallery_cache
from ..ops.ncc_direct import (
    PackedVariants,
    VariantLayout,
    build_direct_cache,
    fold_template,
)
from ..ops.ncc_kernel import (
    AUTO_BLOCK_MARGIN_BYTES,
    auto_gallery_block,
    auto_probe_rows,
    equal_blocks,
    gallery_block_bytes_per_print,
    host_row_hw,
    kernel_tile,
    print_plan,
    probe_row_bytes,
    row_plan,
)
from ..ops.preprocess import normalize_batch
from ..ops.topk import ranks_on_device
from ..ops.warp import pil_resize_size, resample_weights, rotate_index_map
from ..parallel.mesh import Mesh, build_mesh, normal_device, visible_devices
from ..parallel.sharded import (
    build_sharded_cache,
    make_sharded_packed_builder,
    make_sharded_packed_scorer,
    make_sharded_scorer,
    shard_valid,
)
from ..utils.tracing import profile_trace, span, stage_timer
from .gallery import GalleryFeatureCache
from .pruned import pruned_ranks

# Probes per scoring call when tpu.probe_batch is 0 on the CPU: 56 probes x
# 25 variants = 1400 variant rows, the TPU engine's main-path depth. On a
# card the rows come from ops/ncc_kernel.auto_probe_rows.
DEFAULT_PROBE_BATCH = 56
# With more than one gallery block, every probe batch's variant stack is
# built once and kept across blocks while all of them take less than this
# (the JAX engine's cap, engine.py:1292-1311); above it they are rebuilt
# per block.
PREBUILD_BYTES = 6e9
# chunks the streamed extraction prepares ahead of the device (host memory
# holds about this many chunks)
STREAM_LOOKAHEAD = 2
# On a mesh of more than one device, the free memory the sizing solves
# within shrinks by this much more on the tightest device (the JAX engine's
# mesh_extra: the sharded caches and the stack's copies beside it)
MESH_EXTRA_BYTES = int(2.5e9)


# The share of a card's free memory that extracted feature maps may keep
# there: the direct cache built from them holds three arrays of their size
# (p0 and two integral images), so with maps at a quarter the whole
# gallery's cache still fits in one block beside them
DEVICE_MAPS_SHARE = 0.25


def _device_maps_budget(dev: torch.device) -> int:
    """Bytes of extracted feature maps that may rest on ``dev``.

    Under it a set's maps stay on the device from extraction into scoring,
    and the gallery feature cache keeps them there for later clusters (its
    device entries in all stay under it); above it (galleries too large for
    the card) each chunk's maps go to host memory, pinned on a card, and the
    scorer moves them back a gallery block at a time. On a card the budget
    is :data:`DEVICE_MAPS_SHARE` of its free memory (``device.free_bytes``)
    as read at the call: extraction reads it at a set's first chunk. On the
    CPU it is 2 GB (the JAX engine's ``_device_maps_budget``), and maps over
    it are at rest on the host as NumPy arrays (the JAX engine's host
    arrays), which is what ``tpu.cache_dtype`` reads. ``SIR_DEVICE_MAPS_MAX``
    overrides it on both.
    """
    if "SIR_DEVICE_MAPS_MAX" in os.environ:
        return int(os.environ["SIR_DEVICE_MAPS_MAX"])
    if dev.type == "cuda":
        return int(free_bytes(dev) * DEVICE_MAPS_SHARE)
    return int(2e9)


def _pad_chunk(batch: np.ndarray, valid: np.ndarray, bs: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad a short last chunk to ``bs`` images (zeros, valid 1 x 1), so every
    chunk of a set runs at one batch shape and picks the same convolution
    algorithms."""
    pad = bs - len(batch)
    if not pad:
        return batch, valid
    return (np.concatenate([batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)]),
            np.concatenate([valid, np.ones((pad, 2), valid.dtype)]))


@dataclass
class DeviceScores:
    """A cluster's (Q, G) scores left on the device (``tpu.rank_on_device``).

    ``buf`` keeps the gallery columns in the engine's height-sorted order;
    :meth:`ranks` counts on the device (``ops/topk.ranks_on_device``), so
    only Q int32s reach the host. Tie convention: under an exact tie with
    the true match's score, tied columns count in height-sorted column
    order, not the original gallery order (the JAX engine's behaviour,
    its ``DeviceScores``); untied scores rank as ``metrics.ranks_from_scores``.
    """

    buf: torch.Tensor       # (Q, G) f32 on the device, height-sorted columns
    inv_order: np.ndarray   # original gallery index -> sorted column

    def ranks(self, matching_pairs: Sequence[int]) -> np.ndarray:
        sorted_pairs = torch.as_tensor(self.inv_order[np.asarray(matching_pairs)],
                                       device=self.buf.device)
        return ranks_on_device(self.buf, sorted_pairs).cpu().numpy()

    def materialize(self) -> np.ndarray:
        """The full matrix in the original gallery order (the host path's
        un-permutation)."""
        return self.buf.cpu().numpy()[:, self.inv_order]


@dataclass
class ClusterOutput:
    ranks: np.ndarray
    matching_pairs: list[int]
    n_queries: int
    block: int
    scale: float
    # (Q, G) max-over-variant scores in the original gallery order (with
    # tpu.fusion_blocks their sum over the blocks), or with tpu.rank_on_device
    # the DeviceScores they stay in (materialize() pulls them); None with
    # tpu.pruned_scoring, which ranks without a score matrix
    scores: np.ndarray | DeviceScores | None


@dataclass
class VariantPlan:
    """Host-planned, PIL-exact transform tables for a cluster's probes."""

    rot_idx: np.ndarray    # (Q, 1+R, hc*wc) int32 flat gather maps
    rot_ok: np.ndarray     # (Q, 1+R, hc, wc) bool
    wv: np.ndarray         # (Q, max(1,S), tc0, hc) f32 vertical resample
    wh: np.ndarray         # (Q, max(1,S), tc1, wc) f32 horizontal resample
    scale_hw: np.ndarray   # (Q, max(1,S), 2) int32 scaled sizes
    template_canvas: tuple[int, int]
    n_rot: int
    n_scl: int


def variant_plan(
    q_valid: np.ndarray,
    feat_canvas: tuple[int, int],
    rotations: Sequence[float],
    scales: Sequence[float],
) -> VariantPlan:
    """PIL-exact rotation maps and bicubic resample matrices for every probe
    (the JAX engine's ``_variant_plan_impl``)."""
    rots, scls = list(rotations), list(scales)
    hc, wc = feat_canvas
    # the template canvas must hold the largest scaled variant
    smax = max([1.0] + scls)
    tc = (max(hc, int(hc * smax)), max(wc, int(wc * smax)))
    n_q = len(q_valid)
    rot_idx = np.zeros((n_q, 1 + len(rots), hc * wc), np.int32)
    rot_ok = np.zeros((n_q, 1 + len(rots), hc, wc), bool)
    wv = np.zeros((n_q, max(1, len(scls)), tc[0], hc), np.float32)
    wh = np.zeros((n_q, max(1, len(scls)), tc[1], wc), np.float32)
    scale_hw = np.zeros((n_q, max(1, len(scls)), 2), np.int32)
    for qi, (h, w) in enumerate(np.asarray(q_valid)):
        h, w = int(h), int(w)
        for ri, deg in enumerate([0.0] + rots):
            idx, ok = rotate_index_map((h, w), deg, canvas_hw=(hc, wc))
            rot_idx[qi, ri] = idx.reshape(-1)
            rot_ok[qi, ri] = ok
        for si, s in enumerate(scls):
            oh, ow = pil_resize_size((h, w), s)
            wv[qi, si] = resample_weights(h, oh, canvas_in=hc, canvas_out=tc[0])
            wh[qi, si] = resample_weights(w, ow, canvas_in=wc, canvas_out=tc[1])
            scale_hw[qi, si] = (oh, ow)
    return VariantPlan(rot_idx, rot_ok, wv, wh, scale_hw, tc, len(rots), len(scls))


def variant_classes(mode: str, n_rot: int, n_scl: int) -> tuple[bool, tuple[int, ...]]:
    """(include rotations unscaled, class counts) of the class-major layout.

    Class 0 holds the unscaled variants: in ``"reference"`` mode the original
    alone (the reference never scores rotated-but-unscaled variants,
    similarity.py:321-353), in ``"full"`` mode (or with rotations but no
    scales) the original plus every rotation. Class ``1+si`` holds scale
    ``si`` of the original and every rotation.
    """
    include_rots_unscaled = bool(mode == "full" or (n_rot and not n_scl))
    b0 = 1 + n_rot if include_rots_unscaled else 1
    return include_rots_unscaled, tuple([b0] + [1 + n_rot] * n_scl)


def rotate_maps(maps: torch.Tensor, rot_idx: torch.Tensor, rot_ok: torch.Tensor) -> torch.Tensor:
    """(pb, C, hc, wc) maps -> (pb, 1+R, C, hc, wc) PIL-exact NEAREST rotations
    (one gather per probe; the 0-fill where ``rot_ok`` is False)."""
    pb, c, hc, wc = maps.shape
    r1 = rot_idx.shape[1]
    flat = maps.reshape(pb, 1, c, hc * wc).expand(pb, r1, c, hc * wc)
    idx = rot_idx.long()[:, :, None, :].expand(pb, r1, c, hc * wc)
    rot = torch.gather(flat, 3, idx).reshape(pb, r1, c, hc, wc)
    return torch.where(rot_ok[:, :, None], rot, torch.zeros((), device=rot.device))


def variant_maps(
    maps: torch.Tensor,
    rot_idx: torch.Tensor,
    rot_ok: torch.Tensor,
    wv: torch.Tensor,
    wh: torch.Tensor,
    *,
    include_rots_unscaled: bool,
    n_scl: int,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The raw variant maps of a probe batch, by class.

    ``maps`` (pb, C, hc, wc) and the per-probe plan rows of
    :class:`VariantPlan` on the same device -> (the unscaled class
    (pb, b0, C, hc, wc), one (pb, 1+R, C, tc0, tc1) stack per scale).
    Rotation is a gather, scaling two batched matrix products (vertical,
    then horizontal).
    """
    rot = rotate_maps(maps, rot_idx, rot_ok)
    base = rot if include_rots_unscaled else rot[:, :1]
    scaled = []
    for si in range(n_scl):
        vert = torch.einsum("poh,prchw->prcow", wv[:, si], rot)
        scaled.append(torch.einsum("pqw,prcow->prcoq", wh[:, si], vert))
    return base, scaled


def build_kernels(
    maps: torch.Tensor,
    valid: torch.Tensor,
    rot_idx: torch.Tensor,
    rot_ok: torch.Tensor,
    wv: torch.Tensor,
    wh: torch.Tensor,
    scale_hw: torch.Tensor,
    *,
    kernel_hw: tuple[int, int],
    include_rots_unscaled: bool,
    n_scl: int,
) -> torch.Tensor:
    """Class-major folded variant rows (N, C, hk, wk) for a probe batch:
    :func:`variant_maps`, each class folded by :func:`fold_template`."""
    pb, c, hc, wc = maps.shape
    base, scaled = variant_maps(maps, rot_idx, rot_ok, wv, wh,
                                include_rots_unscaled=include_rots_unscaled, n_scl=n_scl)
    b0 = base.shape[1]
    kerns = [fold_template(
        base.reshape(pb * b0, c, hc, wc), valid.repeat_interleave(b0, dim=0), kernel_hw
    )]
    for si, sc in enumerate(scaled):
        r1 = sc.shape[1]
        kerns.append(fold_template(
            sc.reshape(pb * r1, c, *sc.shape[-2:]),
            scale_hw[:, si].repeat_interleave(r1, dim=0), kernel_hw,
        ))
    return torch.cat(kerns)


def regroup_max(scores: torch.Tensor, layout: VariantLayout) -> torch.Tensor:
    """Class-major (N, G) scores -> (pb, G) max over each probe's variants.

    Floored at 0: the reference's max accumulator starts at zeros and only
    overwrites on ``>`` (reference similarity.py:355-367), so every score is
    ``max(best_variant, 0.0)``.
    """
    parts, off = [], 0
    for cnt in layout.class_counts:
        parts.append(scores[off : off + layout.pb * cnt].reshape(layout.pb, cnt, -1))
        off += layout.pb * cnt
    return torch.clamp(torch.cat(parts, dim=1).amax(dim=1), min=0.0)


def batch_windows(q_valid: np.ndarray, scale_hw: np.ndarray, n_scl: int):
    """Per-batch window dedup: every group's post-crop window (class-major,
    ``ci * pb + p``), the distinct windows and each group's index into them
    (engine.py:1164-1185 of the JAX package)."""
    wins = [q_valid - 2 * EDGE_CROP]
    for si in range(n_scl):
        wins.append(scale_hw[:, si] - 2 * EDGE_CROP)
    wins = np.concatenate(wins).astype(np.int32)
    uniq, inv = np.unique(wins, axis=0, return_inverse=True)
    return wins, uniq.astype(np.int32), inv.reshape(-1).astype(np.int64)


class Pipeline:
    """End-to-end retrieval for one config (the reference's run.py loop).

    ``device`` is ``"cuda"`` (default) or ``"cpu"``. On CUDA the NCC scorer is
    the hand-written kernel unless ``tpu.ncc_backend = "direct"`` asks for its
    plain PyTorch version; on the CPU it is always the plain version.
    ``"fft"`` scores through FFTs on either device.

    ``mesh_devices`` lists the devices ``tpu.mesh_shape`` takes its mesh
    from, in order, repeats allowed (``["cpu"] * 8``, ``["cuda:0"] * 4``):
    the port's stand-in for XLA's forced host device count. Its first must
    be ``device``. By default: ``device``, then every other visible CUDA
    device on a card; ``device`` alone on the CPU.

    What each run took is counted on the object: ``stage_seconds`` and
    ``lookahead_seconds`` (below), ``ingest_tiers`` (the loader tier that
    served each file set), ``clahe_routes`` (``host`` or ``device``, once per
    cluster whose features were extracted), ``gallery_blocks_scored`` and
    ``cache_bytes`` (each scored block's scoring cache, direct or FFT),
    ``probe_batches`` (the probes per call of each direct scoring call),
    ``prune_stats`` (``pruned_ranks``' statistics, once per pruned cluster)
    and ``conv_routes`` (once per extracted set, on whichever thread:
    ``"{precision}:{route}"``, the models' bound ``tpu.precision`` and the
    conv arithmetic that served it, ``models/layers.conv_route``) and
    ``mesh_runs`` (``"extract:{n}"`` per set extracted over a mesh of n >
    1, ``"score:{n}"`` / ``"fft:{n}"`` per cluster scored over one) and
    ``maps_at_rest`` (``"device"`` or ``"host"``, once per scoring call,
    direct or FFT: where the gallery maps lay when the ``cache`` stage read
    them; on the CPU, where the two are one memory, a tensor counts as
    ``device`` and a NumPy array as ``host``).

    Stage seconds are kept per thread. The calling thread's stages go into
    ``stage_seconds``; each ends with a device-wide synchronise, so a stage
    holds its own device time. With ``tpu.pipeline_clusters`` the next
    cluster's ingest and extraction run on the lookahead thread while this
    one scores; its stages, under the same names, go into
    ``lookahead_seconds``, are timed on the host clock without a device
    synchronise (each extraction chunk's pull of its valid sizes waits for
    that chunk's work) and overlap the calling thread's ``score`` and
    ``cache``. Both threads issue to the device's default stream, so their
    device work is serialised in the order it was issued.
    ``lookahead_seconds`` is that thread's host-clock time, not a share of
    the device's.

    Both sinks also hold child spans (``utils/tracing.span``), host clock,
    no synchronise, under dotted names inside their stage's seconds:
    ``cache.gather`` and ``cache.copy`` (each gallery block's host gather
    from the maps at rest and its copy to the card), and
    ``extract-query.ingest-wait`` / ``extract-gallery.ingest-wait`` (the
    extracting thread's wait for the stream worker's next chunk).
    ``stage_seconds`` holds the calling thread's ``lookahead-wait`` stage
    besides (host clock, no synchronise): its wait for the lookahead's
    features, the part of the lookahead the scoring did not hide.
    """

    def __init__(self, config: dict, weights_dir: str | None = "weights",
                 verbose: bool = True, device: str | torch.device = "cuda",
                 mesh_devices: Sequence[str | torch.device] | None = None):
        check_supported(config)
        self.config = config
        self.verbose = verbose
        self.device = resolve_device(device)
        home = normal_device(self.device)
        if mesh_devices is None:
            self._mesh_pool = [home] + [d for d in visible_devices(home.type) if d != home]
        else:
            self._mesh_pool = [normal_device(d) for d in mesh_devices]
            if not self._mesh_pool or self._mesh_pool[0] != home:
                raise ValueError(f"mesh_devices must start with the pipeline's device {home}, "
                                 f"not {self._mesh_pool[:1]}")
        self._replicas: dict[tuple[int, torch.device], torch.nn.Module] = {}
        self.dataset = Dataset(config["dataset"]["dir"], config["dataset"]["type"])
        if verbose:
            print(self.dataset.summary())
        model_cfg = config["model"]
        self.spec = get_backbone(model_cfg["type"])
        self.weights_dir = weights_dir
        self._models: dict[int, torch.nn.Module] = {}
        self.stage_seconds: dict[str, float] = {}
        self.lookahead_seconds: dict[str, float] = {}
        self.ingest_tiers: Counter = Counter()
        self.clahe_routes: Counter = Counter()
        self.conv_routes: Counter = Counter()
        self.gallery_blocks_scored = 0  # gallery blocks scored, over all clusters
        self.cache_bytes: list[int] = []  # each scored gallery block's scoring cache
        self.probe_batches: list[int] = []  # probes per call, each direct scoring call
        self.prune_stats: list[dict] = []  # pruned_ranks' stats, each pruned cluster
        self.mesh_runs: Counter = Counter()
        self.maps_at_rest: Counter = Counter()
        self._mode_cache: dict[str, str] = {}
        self._la_pool: ThreadPoolExecutor | None = None
        self._lookahead = None  # (plan, future of its features)
        self._prewarm: threading.Thread | None = None
        self._prewarm_error: BaseException | None = None
        tpu = config["tpu"]
        if (tpu["prewarm"] and self.device.type == "cuda"
                and tpu["ncc_backend"] not in ("direct", "fft")):
            # the only thing the port compiles is its kernels, at first use
            # (ops/build.py): build the NCC kernel while ingest and
            # extraction run; the first scoring call joins this thread. One
            # library holds both legs, so this builds the one tpu.precision
            # takes
            self._prewarm = threading.Thread(target=self._prewarm_build, daemon=True,
                                             name="shoeprint-prewarm")
            self._prewarm.start()
        self._gcache_params = (
            tuple(config["dataset"]["crop"]),
            model_cfg["clahe_clip_limit"],
            tuple(model_cfg["clahe_tile_grid_size"]),
            config["tpu"]["precision"],
        )
        self.gallery_cache = GalleryFeatureCache(config["tpu"]["cache_dir"] or None)
        planner_cfg = PlannerConfig(
            minimum_dim=model_cfg["minimum_dim"],
            maximum_dim=model_cfg["maximum_dim"],
            start_block=model_cfg["start_block"],
            end_block=model_cfg["end_block"],
            skip_blocks=tuple(model_cfg["skip_blocks"]),
            cluster_tolerance=config["dataset"]["cluster_minimise_tolerance"],
        )
        q_sizes = read_header_sizes(self.dataset.query_dir, self.dataset.query_files)
        g_sizes = read_header_sizes(self.dataset.gallery_dir, self.dataset.gallery_files)
        # header (width, height) per file: the streamed path derives each
        # set's canvas from these without decoding a pixel
        self._q_hdr = dict(zip(self.dataset.query_files, q_sizes))
        self._g_hdr = dict(zip(self.dataset.gallery_files, g_sizes))
        self.plans = plan_clusters(
            q_sizes, self.dataset.query_files, g_sizes, config["dataset"]["crop"],
            config["dataset"]["n_clusters"], planner_cfg,
        )
        if verbose:
            print(f"{len(self.plans)} clusters of image sizes found.")

    # ------------------------------------------------------------------
    def _stage(self, name: str):
        return stage_timer(name, self.verbose, self.stage_seconds, self.device)

    def _prewarm_build(self) -> None:
        """Build the NCC kernel (``tpu.prewarm``); a failure is kept and
        raised by the first scoring call (:meth:`_join_prewarm`)."""
        try:
            kernel_tile()
        except Exception as exc:  # noqa: BLE001 — re-raised on the scoring thread
            self._prewarm_error = exc

    def _join_prewarm(self) -> None:
        """Wait for the prewarm build and raise what it raised."""
        if self._prewarm is None:
            return
        self._prewarm.join()
        self._prewarm = None
        err, self._prewarm_error = self._prewarm_error, None
        if err is not None:
            raise RuntimeError("the NCC kernel's build (tpu.prewarm) failed") from err

    def _model_for_block(self, block: int) -> torch.nn.Module:
        """The truncated backbone for ``block``, built once, with
        ``tpu.precision`` bound on its conv modules: the binding lives on the
        model objects, so the lookahead thread that runs them sees it too
        (as the JAX engine binds it per pipeline inside its extraction
        step)."""
        if block not in self._models:
            model = build_model(self.config["model"]["type"], block, self.weights_dir,
                                self.device)
            set_conv_precision(model, self.config["tpu"]["precision"])
            self._models[block] = model
        return self._models[block]

    def _replica(self, model: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
        """``model`` on ``dev``: itself on the pipeline's device (the mesh
        pool's first, indexed once in ``__init__``: no thread's current
        device is read here), else a copy made once, ``tpu.precision`` bound
        on it as on the original."""
        if dev == self._mesh_pool[0]:
            return model
        key = (id(model), dev)
        if key not in self._replicas:
            replica = copy.deepcopy(model).to(dev)
            set_conv_precision(replica, model.conv_precision)
            self._replicas[key] = replica
        return self._replicas[key]

    def _mesh_size(self) -> int:
        """``tpu.mesh_shape`` (0 = every device of the pool) clamped to the
        pool, as the JAX engine clamps to ``jax.devices()``."""
        n = len(self._mesh_pool)
        return min(int(self.config["tpu"]["mesh_shape"]) or n, n)

    def _mesh(self) -> Mesh:
        """The mesh of :meth:`_mesh_size` devices: one device is a mesh of
        one, and runs the same path."""
        return build_mesh(self._mesh_size(), self._mesh_pool)

    def _count_mesh_run(self, kind: str, mesh: Mesh) -> None:
        """One run of ``kind`` in ``mesh_runs``, where the mesh holds more
        than one device."""
        if mesh.size > 1:
            self.mesh_runs[f"{kind}:{mesh.size}"] += 1

    def _free_bytes(self, mesh: Mesh) -> int:
        """Free bytes the sizing solves within: the pipeline device's, or on
        a mesh of more than one the tightest device's less
        :data:`MESH_EXTRA_BYTES`."""
        if mesh.size == 1:
            return free_bytes(self.device)
        return min(free_bytes(d) for d in mesh.distinct()) - MESH_EXTRA_BYTES

    def _host_clahe(self, images: Sequence[np.ndarray]) -> list[np.ndarray] | None:
        """Equalise on the host with the native C++ CLAHE (bit-exact vs cv2),
        or ``None`` where it cannot take the set exactly and the device CLAHE
        must: ``tpu.clahe_host = false``, non-uint8 images, images smaller
        than the tile grid (there the native reflect-101 extension clamps
        where cv2 reflects again; the device CLAHE clamps as well).

        Each image is equalised per its own mode (gray CLAHE for 2-D, LAB-L
        CLAHE for RGB); in a mixed set the gray results are expanded to
        3-channel repeats so the set packs onto one canvas (the reference's
        gray transform repeats channels after CLAHE, network.py:55-71).
        """
        if not self.config["tpu"]["clahe_host"]:
            return None
        gray_i = [i for i, im in enumerate(images) if im.ndim == 2 and im.dtype == np.uint8]
        rgb_i = [i for i, im in enumerate(images)
                 if im.ndim == 3 and im.shape[2] == 3 and im.dtype == np.uint8]
        mcfg = self.config["model"]
        tx, ty = mcfg["clahe_tile_grid_size"]  # cv2 order: (width, height)
        if len(gray_i) + len(rgb_i) != len(images) or not all(
            im.shape[0] >= ty and im.shape[1] >= tx for im in images
        ):
            return None
        out: list = [None] * len(images)
        for idx in (gray_i, rgb_i):
            if idx:
                eq = native_ingest.clahe_batch(
                    [images[i] for i in idx], mcfg["clahe_clip_limit"],
                    tuple(mcfg["clahe_tile_grid_size"]),
                    n_threads=self.config["dataset"]["n_processes"],
                )
                for i, e in zip(idx, eq):
                    out[i] = e
        if gray_i and rgb_i:
            for i in gray_i:
                out[i] = np.repeat(out[i][:, :, None], 3, axis=2)
        return out

    def _device_clahe(self, u8: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """CLAHE of a padded batch on its device (``ops/clahe``): gray
        directly, RGB on the L channel of cv2's LAB (the JAX engine's
        extraction step with ``device_clahe``)."""
        mcfg = self.config["model"]
        clip, grid = mcfg["clahe_clip_limit"], tuple(mcfg["clahe_tile_grid_size"])
        if u8.ndim == 3:
            return clahe_batched_dynamic(u8, valid, clip, grid)
        lab = rgb_to_lab_u8(u8)
        l_eq = clahe_batched_dynamic(lab[..., 0].contiguous(), valid, clip, grid)
        return lab_u8_to_rgb(torch.cat([l_eq[..., None], lab[..., 1:]], dim=-1))

    def _to_host(self, y: torch.Tensor) -> torch.Tensor:
        """A copy of ``y`` in host memory, pinned on a card."""
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=self.device.type == "cuda")
        host.copy_(y)
        return host

    def _extraction_batch(self) -> int:
        """Images a chunk: ``tpu.extraction_batch``, rounded up to a multiple
        of the mesh, so each device takes an equal part."""
        bs = max(1, int(self.config["tpu"]["extraction_batch"]))
        n = self._mesh_size()
        return -(-bs // n) * n

    @torch.inference_mode()
    def _run_extraction(self, model: torch.nn.Module, chunks: Iterable, n_images: int,
                        device_clahe: bool):
        """Extract ``chunks`` of ``(u8 batch, valid, images in it)`` (host
        arrays or tensors, each padded to the set's batch) -> (maps (B, C, Hf,
        Wf), valid (B, 2) int32 numpy).

        The host pulls each chunk's valid sizes one chunk late, so the next
        chunk is issued before it waits; the pull waits for that chunk's
        work, which bounds how far the host runs ahead. The set's maps stay
        on the device when all of them fit :func:`_device_maps_budget`,
        else each chunk's go to the host: pinned tensors on a card, NumPy
        arrays on the CPU, which tells them from maps kept on the device.

        Data-parallel over the mesh (the JAX engine's chunk sharded over its
        mesh): each chunk is split into equal parts, part i extracted on the
        mesh's device i by that device's replica of ``model``, and the
        parts' maps gathered to the pipeline's device before the rule above
        applies. On a mesh of one the chunk is one part.
        """
        dev = self.device
        mesh = self._mesh()
        # the mesh's devices are indexed (the pool's): "cuda" is not equal
        # to "cuda:0"
        devices = mesh.devices
        models = {d: self._replica(model, d) for d in mesh.distinct()}
        self._count_mesh_run("extract", mesh)
        outs, vouts, pending = [], [], []
        keep_device = None
        self.conv_routes[f"{model.conv_precision}:{conv_route(model.conv_precision, dev)}"] += 1

        def drain(limit: int) -> None:
            while len(pending) > limit:
                y, vy, n = pending.pop(0)
                vouts.append(vy[:n].cpu().numpy().astype(np.int32))
                if keep_device:
                    outs.append(y[:n])
                else:
                    host = self._to_host(y[:n])
                    outs.append(host if dev.type == "cuda" else host.numpy())

        def extract_part(d: torch.device, batch, valid):
            u8 = torch.as_tensor(batch).to(d, non_blocking=True)
            v = torch.as_tensor(valid).to(d, non_blocking=True)
            if device_clahe:
                u8 = self._device_clahe(u8, v)
            return models[d](normalize_batch(u8, v, self.spec.mean, self.spec.std), v)

        for batch, valid, n in chunks:
            k = len(batch) // len(devices)
            parts = [extract_part(d, batch[i * k : (i + 1) * k], valid[i * k : (i + 1) * k])
                     for i, d in enumerate(devices)]
            if len(parts) == 1:
                y, vy = parts[0]
            else:
                y, vy = (torch.cat([p[j].to(dev, non_blocking=True) for p in parts])
                         for j in (0, 1))
            if keep_device is None:
                per_img = y[0].numel() * y.element_size()
                keep_device = per_img * n_images <= _device_maps_budget(dev)
            pending.append((y, vy, n))
            drain(1)
        drain(0)
        if len(outs) == 1:
            maps = outs[0]
        else:
            maps = np.concatenate(outs) if isinstance(outs[0], np.ndarray) else torch.cat(outs)
        return maps, np.concatenate(vouts)

    def _extract(self, model: torch.nn.Module, images: Sequence[np.ndarray],
                 canvas_hw: tuple[int, int] | None = None, device_clahe: bool = False):
        """Batched masked extraction of decoded images -> (maps (B, C, Hf,
        Wf), valid (B, 2) int32 numpy); ``device_clahe`` equalises each
        chunk on the device first.

        A mixed gray/RGB list (which only the device CLAHE sees: the host
        CLAHE unifies a mixed set onto 3 channels) extracts as two uniform
        sub-batches on one shared canvas, each with its own mode's CLAHE,
        and the maps are stitched back in input order.
        """
        if len({im.ndim for im in images}) > 1:
            canvas = canvas_bucket([im.shape[:2] for im in images])
            maps: list = [None] * len(images)
            valids: list = [None] * len(images)
            for want in (2, 3):
                idx = [i for i, im in enumerate(images) if im.ndim == want]
                m, v = self._extract(model, [images[i] for i in idx], canvas, device_clahe)
                for j, i in enumerate(idx):
                    maps[i], valids[i] = m[j], v[j]
            stack = np.stack if isinstance(maps[0], np.ndarray) else torch.stack
            return stack(maps), np.stack(valids)
        batch_u8, valid = pack_canvas(images, canvas_hw)
        bs = self._extraction_batch()
        chunks = (_pad_chunk(batch_u8[i : i + bs], valid[i : i + bs], bs)
                  + (min(bs, len(images) - i),) for i in range(0, len(images), bs))
        return self._run_extraction(model, chunks, len(images), device_clahe)

    # ------------------------------------------------------------------
    @staticmethod
    def _ingest_out_hw(hdr_wh: tuple[int, int], crop, scale: float) -> tuple[int, int]:
        """Post-ingest (h, w) from a header's (width, height): the loader's
        crop and resize arithmetic, so canvases are known before decoding."""
        w, h = hdr_wh
        ch, cw = math.floor(h * crop[0]), math.floor(w * crop[1])
        return int((h - 2 * ch) * scale), int((w - 2 * cw) * scale)

    def _file_mode(self, directory, f: str) -> str:
        """One file's PIL mode from its header, memoised."""
        key = str(Path(directory) / f)
        mode = self._mode_cache.get(key)
        if mode is None:
            with Image.open(key) as im:
                mode = im.mode
            self._mode_cache[key] = mode
        return mode

    def _stream_applicable(self, directory, files: Sequence[str], hdr: dict,
                           scale: float) -> bool:
        """True when the streamed extraction can serve this file set: host
        CLAHE on, every file an 8-bit gray or RGB mode (from its header: one
        odd file mid-stream must not fail the stream) and every image at
        least one pixel per CLAHE tile after crop and resize. Mixed L/RGB
        sets stream: :meth:`_host_clahe` unifies them."""
        if not self.config["tpu"]["clahe_host"] or not files:
            return False
        if any(self._file_mode(directory, f) not in ("L", "RGB") for f in files):
            return False
        crop = self.config["dataset"]["crop"]
        tx, ty = self.config["model"]["clahe_tile_grid_size"]
        return all(oh >= ty and ow >= tx for oh, ow in
                   (self._ingest_out_hw(hdr[f], crop, scale) for f in files))

    def _extract_streamed(self, model: torch.nn.Module, directory, files: Sequence[str],
                          scale: float, hdr: dict):
        """Ingest and extraction overlapped: one worker thread loads, host-
        CLAHEs and packs chunk i+1 (and the next) onto the header-derived
        canvas, in pinned memory on a card, while the device extracts chunk
        i. Returns what :meth:`_extract` returns for the same images, which
        it equals: the same canvas, chunks and batch shape. The extracting
        thread's wait for each chunk is the span ``ingest-wait``.
        """
        crop = self.config["dataset"]["crop"]
        n_threads = self.config["dataset"]["n_processes"]
        canvas = canvas_bucket([self._ingest_out_hw(hdr[f], crop, scale) for f in files])
        bs = self._extraction_batch()
        # a mixed L/RGB set: every chunk on the 3-channel canvas, or an
        # all-gray chunk would extract as gray
        force_rgb = len({self._file_mode(directory, f) for f in files}) > 1
        pin = self.device.type == "cuda"

        def prep(chunk_files):
            imgs = load_images(directory, chunk_files, scale, crop, n_threads, self.ingest_tiers)
            eq = self._host_clahe(imgs)
            if eq is None:
                raise RuntimeError("streamed ingest: the host CLAHE cannot take the chunk "
                                   f"starting at {chunk_files[0]} (unexpected image mode?)")
            if force_rgb:
                eq = [e if e.ndim == 3 else np.repeat(e[:, :, None], 3, axis=2) for e in eq]
            batch, valid = (torch.from_numpy(a) for a in _pad_chunk(*pack_canvas(eq, canvas), bs))
            if pin:
                batch, valid = batch.pin_memory(), valid.pin_memory()
            return batch, valid, len(chunk_files)

        chunks = [files[i : i + bs] for i in range(0, len(files), bs)]
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="shoeprint-stream") as pool:
            def prepared():
                futs: list = []
                for ci in range(len(chunks)):
                    while len(futs) < min(STREAM_LOOKAHEAD, len(chunks) - ci):
                        futs.append(pool.submit(prep, chunks[ci + len(futs)]))
                    with span("ingest-wait"):
                        chunk = futs.pop(0).result()
                    yield chunk

            return self._run_extraction(model, prepared(), len(files), False)

    def _variant_plan(self, q_valid: np.ndarray, feat_canvas: tuple[int, int]) -> VariantPlan:
        comp = self.config["comparison"]
        return variant_plan(q_valid, feat_canvas, comp["rotations"] or [], comp["scales"] or [])

    def _gallery_block(self, g_total: int, bytes_per_print: int, stack_bytes: int,
                       kept_stacks: int) -> int:
        """Prints per gallery block: ``tpu.gallery_block`` when it is set;
        for 0, on the CPU one block, on a card the largest block that fits
        its free memory (:meth:`_free_bytes`,
        :func:`~..ops.ncc_kernel.auto_gallery_block`) evened out into equal
        blocks (:func:`~..ops.ncc_kernel.equal_blocks`), so no short tail
        block is scored alone. Rounded up to a multiple of the mesh, so
        every block shards evenly."""
        mesh = self._mesh()
        gb = int(self.config["tpu"]["gallery_block"])
        if gb > 0:
            gb = min(gb, g_total)
        elif self.device.type != "cuda":
            gb = g_total
        else:
            gb = equal_blocks(g_total, auto_gallery_block(
                g_total, bytes_per_print, self._free_bytes(mesh), stack_bytes, kept_stacks))
        return -(-gb // mesh.size) * mesh.size

    def _probe_batch_and_block(self, n_q: int, g_total: int, true_c: int,
                               feat_hw: tuple[int, int], raw_hw: tuple[int, int],
                               plan: VariantPlan, n_var: int,
                               tile_rows: int | None) -> tuple[int, int]:
        """(probes per scoring call, prints per gallery block) for a cluster of
        ``n_q`` probes on ``feat_hw`` canvases against ``g_total`` prints of
        ``raw_hw`` maps, ``n_var`` variants a probe; ``tile_rows`` is the
        kernel's tile, ``None`` for the plain scorer.

        ``tpu.probe_batch`` when set, 56 for 0 on the CPU. For 0 on a card,
        in the JAX engine's order: the rows that fit the card for a block of
        up to 1024 prints (:func:`~..ops.ncc_kernel.auto_probe_rows`), the
        gallery block for that batch (:meth:`_gallery_block`), then the rows
        that fit beside that block's cache, cut into equal batches.

        On a mesh of more than one device (the JAX engine's rules): free
        memory is the tightest device's less :data:`MESH_EXTRA_BYTES`, the
        block is rounded up to a multiple of the mesh and the batch down to
        one where it holds at least one probe a device (the probe-sharded
        build); a smaller batch keeps its size and the replicated build.
        """
        mesh = self._mesh()
        kernel_hw = (plan.template_canvas[0] - 2 * EDGE_CROP,
                     plan.template_canvas[1] - 2 * EDGE_CROP)
        pb_cfg = int(self.config["tpu"]["probe_batch"])
        auto = pb_cfg == 0 and self.device.type == "cuda"
        plain_hw = None if tile_rows else (raw_hw[0] - 2 * EDGE_CROP, raw_hw[1] - 2 * EDGE_CROP)

        def rows(prints: int, room: int) -> int:
            row_bytes = probe_row_bytes(true_c, feat_hw, plan.template_canvas, kernel_hw,
                                        plan.n_rot, plan.n_scl, n_var, prints, plain_hw)
            return auto_probe_rows(row_bytes, room, tile_rows or 1)

        if auto:
            pb = rows(min(g_total, 1024), self._free_bytes(mesh) - AUTO_BLOCK_MARGIN_BYTES) // n_var
        else:
            pb = pb_cfg or DEFAULT_PROBE_BATCH
        pb = max(1, min(n_q, pb))
        stack_bytes = pb * n_var * true_c * kernel_hw[0] * kernel_hw[1] * 4
        gb = self._gallery_block(
            g_total, gallery_block_bytes_per_print(true_c, *raw_hw, pb * n_var), stack_bytes,
            min(-(-n_q // pb), max(1, int(PREBUILD_BYTES // stack_bytes))))
        if auto:
            # beside the block's cache and, with more than one block, the
            # stacks kept across blocks; then evened out, so the last batch
            # (padded to the batch's shape) repeats as few probes as can be.
            # A call's last tile may then be part-full (205 probes x 25
            # variants = 80 tiles and 5 rows): whole tiles would need a
            # multiple of 64 probes a batch at 25 variants, and at the
            # fewest calls the equal batch already runs the fewest tiles (a
            # larger batch only pads the last call with repeated probes)
            room = (self._free_bytes(mesh) - AUTO_BLOCK_MARGIN_BYTES
                    - gb * gallery_block_bytes_per_print(true_c, *raw_hw, 0)
                    - (int(PREBUILD_BYTES) if gb < g_total else 0))
            pb = equal_blocks(n_q, max(1, min(n_q, rows(gb, room) // n_var)))
        if pb >= mesh.size:
            pb = pb // mesh.size * mesh.size
        return pb, gb

    def _score_cluster(
        self,
        q_maps: torch.Tensor,
        q_valid: np.ndarray,
        g_maps: torch.Tensor | np.ndarray,
        g_valid: np.ndarray,
    ) -> np.ndarray | DeviceScores:
        """(Q, G) max-over-variant score matrix for one cluster.

        The gallery is height-sorted and scored in blocks of
        :meth:`_gallery_block` prints, one direct cache per block, each
        block's maps moved to the device as it is scored (``g_maps`` may lie
        on the host or the device); score columns are written into place
        and un-permuted on return. Probes go in batches of ``probe_batch``,
        the tail batch repeating its last probe so every batch has the same
        shapes. With ``tpu.rank_on_device`` the scores stay on the device
        and a :class:`DeviceScores` is returned. ``tpu.ncc_backend = "fft"``
        goes to :meth:`_score_cluster_fft`, which scores in f32 whatever
        ``tpu.precision`` says, as the JAX engine's does.

        ``tpu.precision = "bfloat16"``: the scorer (the kernel's bf16 leg, or
        the plain scorer) correlates operands rounded to bf16. Gallery maps
        at rest in bf16 (:meth:`_maps_at_rest`) cross to the device in bf16
        and are widened there; the cache is f32. The kernel reads f32
        operands in both legs, so the memory models of
        :meth:`_probe_batch_and_block` hold for every precision.

        Over the mesh (:meth:`_mesh`; one device is a mesh of one): each
        block's cache is built shard by shard on the shards' devices from
        the height-sorted block (``parallel/sharded.build_sharded_cache``);
        on a mesh of more than one, each probe batch's stack is built
        probe-sharded when the batch divides by the mesh, else on the
        pipeline's device; every shard is scored on its device (the kernel
        launched once a shard) and the rows gathered to the pipeline's
        device, where ``regroup_max`` and the device ranks run. Fusion and
        pruned scoring call this, so they shard with it.
        """
        if self.config["tpu"]["ncc_backend"] == "fft":
            return self._score_cluster_fft(q_maps, q_valid, g_maps, g_valid)
        self._count_maps_at_rest(g_maps)
        dev = self.device
        compute_dtype = (torch.bfloat16 if self.config["tpu"]["precision"] == "bfloat16"
                         else torch.float32)

        def on_dev(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, device=dev)

        q_maps = torch.as_tensor(q_maps).to(dev)
        n_q, true_c, hc, wc = q_maps.shape
        plan = self._variant_plan(q_valid, (hc, wc))
        kernel_hw = (plan.template_canvas[0] - 2 * EDGE_CROP,
                     plan.template_canvas[1] - 2 * EDGE_CROP)
        include_rots_unscaled, class_counts = variant_classes(
            self.config["tpu"]["variant_mode"], plan.n_rot, plan.n_scl
        )
        # ops/ncc_kernel.score_ncc takes the plain version itself for CPU tensors
        use_kernel = self.config["tpu"]["ncc_backend"] != "direct"
        # the kernel's tile plan is made on the host: its rows' half once per
        # probe batch, its prints' half once per gallery block
        tile = None
        if use_kernel and dev.type == "cuda":
            self._join_prewarm()
            tile = kernel_tile()
        rank_dev = bool(self.config["tpu"]["rank_on_device"])
        q_valid = np.asarray(q_valid)
        g_valid = np.asarray(g_valid)
        g_maps = torch.as_tensor(g_maps)
        g_total = len(g_valid)
        mesh = self._mesh()
        self._count_mesh_run("score", mesh)

        pb, gb = self._probe_batch_and_block(
            n_q, g_total, true_c, (hc, wc), tuple(g_maps.shape[2:]), plan, sum(class_counts),
            None if tile is None else tile.rows)
        self.probe_batches.append(pb)
        layout = VariantLayout(class_counts, pb)
        starts = list(range(0, n_q, pb))
        stack_bytes = layout.n_variants * true_c * kernel_hw[0] * kernel_hw[1] * 4
        n_blocks = -(-g_total // gb)
        prebuild = n_blocks > 1 and len(starts) * stack_bytes < PREBUILD_BYTES
        order = np.argsort(-g_valid[:, 0], kind="stable")
        order_g = torch.as_tensor(order, device=g_maps.device)
        tables = [on_dev(a) for a in (q_valid, plan.rot_idx, plan.rot_ok, plan.wv,
                                      plan.wh, plan.scale_hw)]
        build_fn = partial(build_kernels, kernel_hw=kernel_hw,
                           include_rots_unscaled=include_rots_unscaled, n_scl=plan.n_scl)
        # probe-sharded stack builds where the batch divides by a mesh of
        # more than one
        sharded_build = (make_sharded_packed_builder(mesh, build_fn, class_counts, pb)
                         if mesh.size > 1 and pb % mesh.size == 0 else None)

        def variant_batch(lo: int):
            take = np.minimum(np.arange(lo, lo + pb), n_q - 1)
            take_d = on_dev(take)
            inputs = [q_maps.index_select(0, take_d), *[t.index_select(0, take_d) for t in tables]]
            wins, uniq, inv = batch_windows(q_valid[take], plan.scale_hw[take], plan.n_scl)
            if sharded_build is None:
                packed = PackedVariants(build_fn(*inputs), on_dev(wins))
            else:
                packed = sharded_build(*inputs, on_dev(wins))
            rows = None if tile is None else row_plan(
                host_row_hw(wins, layout, uniq, inv), kernel_hw, tile.rows, dev)
            return packed, on_dev(uniq), on_dev(inv), rows

        with torch.inference_mode():
            if rank_dev:
                buf = torch.zeros((n_q, g_total), dtype=torch.float32, device=dev)
            else:
                out = np.zeros((n_q, g_total), np.float32)
            stacks = {}
            if prebuild:
                with self._stage("score"):
                    stacks = {lo: variant_batch(lo) for lo in starts}
            for b_lo in range(0, g_total, gb):
                b_hi = min(b_lo + gb, g_total)
                blk_valid = g_valid[order[b_lo:b_hi]]
                with self._stage("cache"):
                    shards, _ = build_sharded_cache(build_direct_cache, g_maps, blk_valid,
                                                    mesh, order_g[b_lo:b_hi])
                    prints = None if tile is None else [
                        print_plan(v - 2 * EDGE_CROP, tile.positions)
                        for v in shard_valid(blk_valid, mesh.size)]
                    scorer = make_sharded_packed_scorer(
                        mesh, shards, true_channels=true_c, layout=layout, g_true=b_hi - b_lo,
                        use_kernel=use_kernel, compute_dtype=compute_dtype, prints=prints)
                with self._stage("score"):
                    for lo in starts:
                        packed, uniq, inv, rows = stacks[lo] if prebuild else variant_batch(lo)
                        scores = scorer(packed, uniq, inv, rows)
                        n_take = min(pb, n_q - lo)
                        rows = regroup_max(scores, layout)[:n_take]
                        if rank_dev:
                            buf[lo : lo + n_take, b_lo:b_hi] = rows
                        else:
                            out[lo : lo + n_take, b_lo:b_hi] = rows.cpu().numpy()
                        if self.verbose and b_hi == g_total:
                            print(f"  scored {lo + n_take}/{n_q} queries")
                self.cache_bytes.append(sum(t.numel() * t.element_size()
                                            for shard in shards for t in shard))
                # the scorer holds the shards: let both go before the next block
                del shards, scorer
                self.gallery_blocks_scored += 1
        inv_order = np.argsort(order)
        if rank_dev:
            return DeviceScores(buf, inv_order)
        return out[:, inv_order]

    def _score_cluster_fft(
        self,
        q_maps: torch.Tensor,
        q_valid: np.ndarray,
        g_maps: torch.Tensor | np.ndarray,
        g_valid: np.ndarray,
    ) -> np.ndarray:
        """(Q, G) scores through the FFT backend (``ops/ncc.py``), one probe
        at a time, as the JAX engine's ``_score_cluster_fft`` runs it.

        Per probe, the unfolded variant stack (rotation gathers, scale
        products, padded to the template canvas) is scored against one FFT
        cache per gallery block: ``tpu.gallery_block`` prints, 0 = the whole
        gallery in one block; a short tail block is padded with empty prints
        to the block's shape. The gallery keeps its original order; the max
        over variants is floored at 0. ``rank_on_device`` does not apply.
        The block is rounded up to a multiple of the mesh; each block's FFT
        cache is built shard by shard and scored through ``parallel/sharded.
        make_sharded_scorer``.
        """
        self._count_maps_at_rest(g_maps)
        dev = self.device
        q_maps = torch.as_tensor(q_maps).to(dev)
        n_q, true_c, hc, wc = q_maps.shape
        plan = self._variant_plan(q_valid, (hc, wc))
        tc = plan.template_canvas
        kernel_hw = (tc[0] - 2 * EDGE_CROP, tc[1] - 2 * EDGE_CROP)
        include_rots_unscaled, _ = variant_classes(
            self.config["tpu"]["variant_mode"], plan.n_rot, plan.n_scl
        )
        b0 = 1 + plan.n_rot if include_rots_unscaled else 1
        q_valid = np.asarray(q_valid)
        g_valid = np.asarray(g_valid)
        g_maps = torch.as_tensor(g_maps)
        g_total = len(g_valid)
        gb = min(int(self.config["tpu"]["gallery_block"]) or g_total, g_total)
        mesh = self._mesh()
        self._count_mesh_run("fft", mesh)
        gb = -(-gb // mesh.size) * mesh.size
        tables = [torch.as_tensor(a, device=dev) for a in (plan.rot_idx, plan.rot_ok,
                                                             plan.wv, plan.wh)]
        # each probe's variants' valid sizes, in the stack's order
        t_valid = [np.concatenate([np.tile(q_valid[qi], (b0, 1))]
                                  + [np.tile(plan.scale_hw[qi, si], (1 + plan.n_rot, 1))
                                     for si in range(plan.n_scl)])
                   for qi in range(n_q)]

        def templates(qi: int) -> torch.Tensor:
            base, scaled = variant_maps(
                q_maps[qi : qi + 1], *[t[qi : qi + 1] for t in tables],
                include_rots_unscaled=include_rots_unscaled, n_scl=plan.n_scl)
            base = torch.nn.functional.pad(base[0], (0, tc[1] - wc, 0, tc[0] - hc))
            return torch.cat([base] + [s[0] for s in scaled])

        out = np.zeros((n_q, g_total), np.float32)
        with torch.inference_mode():
            for b_lo in range(0, g_total, gb):
                b_hi = min(b_lo + gb, g_total)
                with self._stage("cache"):
                    shards, _ = build_sharded_cache(
                        lambda m, v: build_gallery_cache(m, v, kernel_hw)[0],
                        g_maps[b_lo:b_hi], g_valid[b_lo:b_hi], mesh)
                    score_block = make_sharded_scorer(mesh, shards, true_channels=true_c,
                                                      g_true=b_hi - b_lo)
                with self._stage("score"):
                    rows = torch.empty((n_q, gb), dtype=torch.float32, device=dev)
                    for qi in range(n_q):
                        scores = score_block(templates(qi), t_valid[qi])
                        rows[qi, : scores.shape[1]] = torch.clamp(scores.amax(dim=0), min=0.0)
                        if self.verbose and (qi + 1) % 10 == 0 and b_hi == g_total:
                            print(f"  scored {qi + 1}/{n_q} queries")
                    out[:, b_lo:b_hi] = rows[:, : b_hi - b_lo].cpu().numpy()
                self.cache_bytes.append(sum(c.nbytes() for c in shards))
                del shards, score_block
                self.gallery_blocks_scored += 1
        return out

    def _cluster_features(self, plan, next_plan=None):
        """Ingest + extract one cluster: (q_maps, q_valid, g_maps, g_valid,
        q_files).

        With ``tpu.pipeline_clusters`` (the default) ``next_plan``'s features
        start on the lookahead thread before this returns, so they are made
        while this cluster scores; the next call takes them. Off, clusters
        run one after another. Features are the same either way: the same
        code on the same inputs.
        """
        la, self._lookahead = self._lookahead, None
        if la is not None:
            # this thread's wait: the part of the lookahead the scoring did
            # not hide (one made for another plan is let finish first)
            with stage_timer("lookahead-wait", False, self.stage_seconds):
                made = la[1].result()
        if la is not None and la[0] is plan:
            out = made
        else:
            out = self._cluster_features_impl(plan)
        if next_plan is not None and self.config["tpu"]["pipeline_clusters"]:
            if self._la_pool is None:
                self._la_pool = ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="shoeprint-lookahead")
            self._lookahead = (next_plan, self._la_pool.submit(self._lookahead_features, next_plan))
        return out

    def _lookahead_features(self, plan):
        # inference mode is per thread: the worker enters its own
        with torch.inference_mode():
            return self._cluster_features_impl(plan, lookahead=True)

    def _cluster_gallery_state(self, plan, q_files: Sequence[str]):
        """(gallery cache key, cached gallery features or None, stream?)."""
        gkey = GalleryFeatureCache.key(
            self.config["model"]["type"], plan.block, plan.scale,
            self.dataset.gallery_files,
            gallery_dir=self.dataset.gallery_dir, params=self._gcache_params,
        )
        g_cached = self.gallery_cache.get(gkey)
        stream = self._stream_applicable(
            self.dataset.query_dir, q_files, self._q_hdr, plan.scale
        ) and (g_cached is not None or self._stream_applicable(
            self.dataset.gallery_dir, self.dataset.gallery_files, self._g_hdr, plan.scale))
        return gkey, g_cached, stream

    def _cluster_features_impl(self, plan, lookahead: bool = False):
        """The pre-scoring stages of one cluster (the reference's
        run.py:17-24). Streamed where the host CLAHE applies: then no
        ``ingest`` stage, its time is inside ``extract-query`` and
        ``extract-gallery``. Otherwise the sets are ingested, host-CLAHEd
        where the native CLAHE takes both (else CLAHE runs on the device in
        extraction) and extracted."""
        if lookahead:
            def stage(name):
                return stage_timer(name, self.verbose, self.lookahead_seconds)
        else:
            stage = self._stage
        crop = self.config["dataset"]["crop"]
        n_threads = self.config["dataset"]["n_processes"]
        q_files = sorted(plan.files)
        gkey, g_cached, stream = self._cluster_gallery_state(plan, q_files)
        model = self._model_for_block(plan.block)
        g_imgs = None
        device_clahe = False
        if stream:
            with stage("extract-query"):
                q_maps, q_valid = self._extract_streamed(
                    model, self.dataset.query_dir, q_files, plan.scale, self._q_hdr)
        else:
            with stage("ingest"):
                q_imgs = load_images(self.dataset.query_dir, q_files, plan.scale, crop,
                                     n_threads, self.ingest_tiers)
                if g_cached is None:
                    g_imgs = load_images(self.dataset.gallery_dir, self.dataset.gallery_files,
                                         plan.scale, crop, n_threads, self.ingest_tiers)
                q_eq = self._host_clahe(q_imgs)
                g_eq = None if g_imgs is None else self._host_clahe(g_imgs)
                device_clahe = q_eq is None or (g_imgs is not None and g_eq is None)
                if not device_clahe:
                    q_imgs, g_imgs = q_eq, g_eq
            with stage("extract-query"):
                q_maps, q_valid = self._extract(model, q_imgs, device_clahe=device_clahe)
        self.clahe_routes["device" if device_clahe else "host"] += 1
        with stage("extract-gallery"):
            if g_cached is not None:  # on the device, or at rest on the host
                g_maps, g_valid = g_cached[0], np.asarray(g_cached[1])
            else:
                if stream:
                    g_maps, g_valid = self._extract_streamed(
                        model, self.dataset.gallery_dir, self.dataset.gallery_files,
                        plan.scale, self._g_hdr)
                else:
                    g_maps, g_valid = self._extract(model, g_imgs, device_clahe=device_clahe)
                # on the device as they are, within the budget; else a host copy
                self.gallery_cache.put(
                    gkey, g_maps if self._on_device(g_maps) else np.asarray(g_maps), g_valid,
                    device_budget=_device_maps_budget(self.device))
            g_maps = self._maps_at_rest(g_maps)
        return q_maps, q_valid, g_maps, g_valid, q_files

    def _on_device(self, maps: torch.Tensor | np.ndarray) -> bool:
        """Whether ``maps`` lie on the pipeline's device (a pinned host
        tensor does not)."""
        return isinstance(maps, torch.Tensor) and maps.device.type == self.device.type

    def _count_maps_at_rest(self, g_maps: torch.Tensor | np.ndarray) -> None:
        self.maps_at_rest["device" if self._on_device(g_maps) else "host"] += 1

    def _maps_at_rest(self, g_maps: torch.Tensor | np.ndarray) -> torch.Tensor | np.ndarray:
        """``tpu.cache_dtype = "bfloat16"``: gallery maps at rest on the host
        (NumPy arrays or tensors off the device: over the budget of
        :func:`_device_maps_budget`, moved out of the gallery feature cache
        past it, or loaded from its disk copy) as a bf16 tensor, made once a
        cluster, which halves the bytes each gallery block moves to the
        device. Maps on the device stay float32 as they are, in every call
        of a standing pipeline: the feature cache keeps them there, so a
        later cluster gets the first one's maps, not bf16-rounded host
        copies. The FFT backend's maps stay as they are too (the JAX engine
        casts its host maps in its direct scoring path, after the FFT
        backend has branched off).
        """
        tpu = self.config["tpu"]
        if (tpu["cache_dtype"] != "bfloat16" or tpu["ncc_backend"] == "fft"
                or self._on_device(g_maps)):
            return g_maps
        return torch.as_tensor(g_maps).to(torch.bfloat16)

    def run_cluster(self, plan, next_plan=None) -> ClusterOutput:
        """Score one cluster and rank (the reference's run.py:17-34 body);
        ``next_plan``, where given, is the cluster to prepare meanwhile.

        ``tpu.fusion_blocks``: the cluster is scored once per listed
        truncation block at its planned scale and the score matrices are
        summed before ranking (score-level fusion: the blocks' correlation
        grids have other strides, so their shift axes do not align for a
        sum of maps). No lookahead runs then, as in the JAX engine: each
        block's features are made when it is scored. ``tpu.pruned_scoring``:
        :meth:`_run_cluster_pruned`.
        """
        tpu = self.config["tpu"]
        if tpu["pruned_scoring"]:
            return self._run_cluster_pruned(plan, next_plan)
        fusion = list(tpu["fusion_blocks"] or [])
        if fusion:
            scores = None
            for fb in fusion:
                s, q_files = self._cluster_scores(replace(plan, block=fb))
                if isinstance(s, DeviceScores):  # fusion sums matrices on the host
                    s = s.materialize()
                scores = s if scores is None else scores + s
        else:
            scores, q_files = self._cluster_scores(plan, next_plan)
        pairs = self.dataset.matching_pairs(q_files)
        if isinstance(scores, DeviceScores):
            ranks = scores.ranks(pairs)
        else:
            ranks = ranks_from_scores(scores, pairs)
        self._report(q_files, ranks)
        return ClusterOutput(ranks, pairs, len(q_files), plan.block, plan.scale, scores)

    def _cluster_scores(self, plan, next_plan=None):
        """(scores, q_files) of one (cluster, block): features, then
        :meth:`_score_cluster`; ``run_cluster`` runs it once, or once per
        fusion block."""
        q_maps, q_valid, g_maps, g_valid, q_files = self._cluster_features(plan, next_plan)
        return self._score_cluster(q_maps, q_valid, g_maps, g_valid), q_files

    def _run_cluster_pruned(self, plan, next_plan=None) -> ClusterOutput:
        """Rank one cluster through :func:`~.pruned.pruned_ranks`, with
        :meth:`_score_cluster` as its score function (device scores pulled
        to the host: its bound arithmetic runs there). The maps stay where
        extraction left them; each pass slices them there."""
        q_maps, q_valid, g_maps, g_valid, q_files = self._cluster_features(plan, next_plan)
        pairs = self.dataset.matching_pairs(q_files)

        def score_fn(qm, qv, gm, gv):
            s = self._score_cluster(qm, qv, gm, gv)
            return s.materialize() if isinstance(s, DeviceScores) else s

        tpu = self.config["tpu"]
        with self._stage("score-pruned"):
            ranks, stats = pruned_ranks(
                score_fn, q_maps, q_valid, g_maps, g_valid, pairs,
                k=int(tpu["prune_channels"] or 0), margin=float(tpu["prune_margin"] or 5e-3))
        self.prune_stats.append(stats)
        if self.verbose:
            print(f"pruned scoring: prune_rate={stats['prune_rate']:.3f} "
                  f"survivors={stats['survivors']}/{len(g_valid)} "
                  f"pair_frac={stats['pair_frac']:.3f} k={stats['k']}")
        self._report(q_files, ranks)
        return ClusterOutput(ranks, pairs, len(q_files), plan.block, plan.scale, None)

    def _report(self, q_files: Sequence[str], ranks: np.ndarray) -> None:
        """The per-query rank lines and what served ingest and CLAHE."""
        if self.verbose:
            for qf, rank in zip(q_files, ranks):
                print(f"Print {parse_image_id(qf, self.dataset.type)} "
                      f"true match ranked {rank}")
            print(f"ingest tiers so far {dict(self.ingest_tiers)}, "
                  f"CLAHE routes {dict(self.clahe_routes)}")

    def close(self) -> None:
        """Retire the lookahead and prewarm threads: wait for a lookahead
        still running (a thread left inside a device call at interpreter exit
        can crash it), then stop its pool and join the prewarm build."""
        la, self._lookahead = self._lookahead, None
        if la is not None:
            try:
                la[1].result()
            except Exception as exc:  # noqa: BLE001 — its cluster is not scored
                warnings.warn(f"the unused lookahead for the next cluster failed: {exc!r}")
        if self._la_pool is not None:
            self._la_pool.shutdown(wait=True)
            self._la_pool = None
        if self._prewarm is not None:
            self._prewarm.join()
            self._prewarm = None

    def run(self):
        """Every cluster in plan order, one :class:`ClusterOutput` each; with
        ``tpu.profile_dir`` one Chrome trace per cluster,
        ``{profile_dir}/cluster{i}.json``."""
        profile_dir = self.config["tpu"]["profile_dir"]
        try:
            for i, plan in enumerate(self.plans):
                if self.verbose:
                    print(f"Cluster has {len(plan.files)} items.")
                nxt = self.plans[i + 1] if i + 1 < len(self.plans) else None
                with profile_trace(profile_dir, f"cluster{i}", self.device):
                    out = self.run_cluster(plan, nxt)
                yield out
        finally:
            self.close()

"""The retrieval pipeline on one device, cluster at a time.

The port of the single-device main path of ``shoeprint_image_retrieval_tpu/
retrieval/engine.py`` (reference run.py:17-34 + similarity.py:129-375):

* host ingest (``data/loader.py``) and native CLAHE (``data/native_ingest``);
* normalisation and masked batched extraction through the truncated
  backbone (``ops/preprocess.py``, ``models/``);
* the gallery cache: demeaned prints + integral images, height-sorted, one
  block (``ops/ncc_direct.build_direct_cache``);
* per probe batch, a class-major variant stack (PIL-exact rotation gathers
  and bicubic scale matrices, ``ops/warp.py``) scored by the fused NCC
  kernel (``ops/ncc_kernel.score_ncc``); max over variants floored at 0;
* host ranks and the S-line (``metrics.py``).

Not carried over (ROADMAP.md, 'Still to port'): streamed ingest, device
CLAHE, gallery blocking and the TPU sizing helpers, prewarm, cluster
lookahead, on-device ranks, fusion, pruning, the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import check_supported, not_ported
from ..data import native_ingest
from ..data.discovery import Dataset, parse_image_id
from ..data.loader import load_images, pack_canvas
from ..data.planner import PlannerConfig, plan_clusters, read_header_sizes
from ..device import resolve_device
from ..metrics import ranks_from_scores
from ..models.registry import get_backbone
from ..models.weights import build_model
from ..ops.boxsum import EDGE_CROP
from ..ops.ncc_direct import (
    PackedVariants,
    VariantLayout,
    build_direct_cache,
    fold_template,
    score_direct,
)
from ..ops.ncc_kernel import score_ncc
from ..ops.preprocess import normalize_batch
from ..ops.warp import pil_resize_size, resample_weights, rotate_index_map
from ..utils.tracing import stage_timer
from .gallery import GalleryFeatureCache

# Probes per scoring call when tpu.probe_batch is 0: 56 probes x 25 variants
# = 1400 variant rows, the TPU engine's main-path depth. Re-deriving it for
# the H100 is ROADMAP work ('gallery blocking and H100 sizing').
DEFAULT_PROBE_BATCH = 56


@dataclass
class ClusterOutput:
    ranks: np.ndarray
    matching_pairs: list[int]
    n_queries: int
    block: int
    scale: float
    scores: np.ndarray  # (Q, G) max-over-variant scores, original gallery order


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
    """Class-major folded variant rows (N, C, hk, wk) for a probe batch.

    ``maps`` (pb, C, hc, wc) and the per-probe plan rows of
    :class:`VariantPlan` on the same device. Rotation is a gather, scaling
    two batched matrix products (vertical, then horizontal), folding
    :func:`fold_template`.
    """
    pb, c, hc, wc = maps.shape
    rot = rotate_maps(maps, rot_idx, rot_ok)
    r1 = rot.shape[1]
    base = rot if include_rots_unscaled else rot[:, :1]
    b0 = base.shape[1]
    kerns = [fold_template(
        base.reshape(pb * b0, c, hc, wc), valid.repeat_interleave(b0, dim=0), kernel_hw
    )]
    for si in range(n_scl):
        vert = torch.einsum("poh,prchw->prcow", wv[:, si], rot)
        scaled = torch.einsum("pqw,prcow->prcoq", wh[:, si], vert)
        kerns.append(fold_template(
            scaled.reshape(pb * r1, c, *scaled.shape[-2:]),
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
    """

    def __init__(self, config: dict, weights_dir: str | None = "weights",
                 verbose: bool = True, device: str | torch.device = "cuda"):
        check_supported(config)
        self.config = config
        self.verbose = verbose
        self.device = resolve_device(device)
        self.dataset = Dataset(config["dataset"]["dir"], config["dataset"]["type"])
        if verbose:
            print(self.dataset.summary())
        model_cfg = config["model"]
        self.spec = get_backbone(model_cfg["type"])
        self.weights_dir = weights_dir
        self._models: dict[int, torch.nn.Module] = {}
        self.stage_seconds: dict[str, float] = {}
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
        self.plans = plan_clusters(
            q_sizes, self.dataset.query_files, g_sizes, config["dataset"]["crop"],
            config["dataset"]["n_clusters"], planner_cfg,
        )
        if verbose:
            print(f"{len(self.plans)} clusters of image sizes found.")

    # ------------------------------------------------------------------
    def _stage(self, name: str):
        return stage_timer(name, self.verbose, self.stage_seconds, self.device)

    def _model_for_block(self, block: int) -> torch.nn.Module:
        if block not in self._models:
            self._models[block] = build_model(
                self.config["model"]["type"], block, self.weights_dir, self.device
            )
        return self._models[block]

    def _host_clahe(self, images: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Equalise on the host with the native C++ CLAHE (bit-exact vs cv2).

        Each image is equalised per its own mode (gray CLAHE for 2-D, LAB-L
        CLAHE for RGB); in a mixed set the gray results are expanded to
        3-channel repeats so the set packs onto one canvas. Inputs the native
        path cannot take exactly (non-uint8, images smaller than the tile
        grid) need the device CLAHE, which the port does not have yet.
        """
        gray_i = [i for i, im in enumerate(images) if im.ndim == 2 and im.dtype == np.uint8]
        rgb_i = [i for i, im in enumerate(images)
                 if im.ndim == 3 and im.shape[2] == 3 and im.dtype == np.uint8]
        mcfg = self.config["model"]
        tx, ty = mcfg["clahe_tile_grid_size"]  # cv2 order: (width, height)
        if len(gray_i) + len(rgb_i) != len(images) or not all(
            im.shape[0] >= ty and im.shape[1] >= tx for im in images
        ):
            raise not_ported("CLAHE of non-uint8 or sub-tile-grid images", 2, "device CLAHE")
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

    @torch.inference_mode()
    def _extract(self, model: torch.nn.Module, images: Sequence[np.ndarray]):
        """Batched masked extraction -> (maps (B, C, Hf, Wf) on the device,
        valid (B, 2) int32 numpy)."""
        batch_u8, valid = pack_canvas(images)
        bs = max(1, int(self.config["tpu"]["extraction_batch"]))
        outs, vouts = [], []
        for i in range(0, len(images), bs):
            u8 = torch.from_numpy(batch_u8[i : i + bs]).to(self.device)
            v = torch.from_numpy(valid[i : i + bs]).to(self.device)
            x = normalize_batch(u8, v, self.spec.mean, self.spec.std)
            y, vy = model(x, v)
            outs.append(y)
            vouts.append(vy.cpu().numpy().astype(np.int32))
        return torch.cat(outs), np.concatenate(vouts)

    def _variant_plan(self, q_valid: np.ndarray, feat_canvas: tuple[int, int]) -> VariantPlan:
        comp = self.config["comparison"]
        return variant_plan(q_valid, feat_canvas, comp["rotations"] or [], comp["scales"] or [])

    def _score_cluster(
        self,
        q_maps: torch.Tensor,
        q_valid: np.ndarray,
        g_maps: torch.Tensor,
        g_valid: np.ndarray,
    ) -> np.ndarray:
        """(Q, G) max-over-variant score matrix for one cluster.

        One gallery block, height-sorted (columns are un-permuted on return);
        probes in batches of ``probe_batch``, the tail batch repeating its
        last probe so every batch has the same shapes.
        """
        dev = self.device

        def on_dev(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, device=dev)

        n_q, true_c, hc, wc = q_maps.shape
        plan = self._variant_plan(q_valid, (hc, wc))
        kernel_hw = (plan.template_canvas[0] - 2 * EDGE_CROP,
                     plan.template_canvas[1] - 2 * EDGE_CROP)
        include_rots_unscaled, class_counts = variant_classes(
            self.config["tpu"]["variant_mode"], plan.n_rot, plan.n_scl
        )
        pb = max(1, min(n_q, int(self.config["tpu"]["probe_batch"]) or DEFAULT_PROBE_BATCH))
        layout = VariantLayout(class_counts, pb)
        # score_ncc takes the plain version itself for CPU tensors
        scorer = score_direct if self.config["tpu"]["ncc_backend"] == "direct" else score_ncc
        q_valid = np.asarray(q_valid)
        g_valid = np.asarray(g_valid)

        with torch.inference_mode():
            with self._stage("cache"):
                order = np.argsort(-g_valid[:, 0], kind="stable")
                cache = build_direct_cache(
                    g_maps.index_select(0, on_dev(order)).to(torch.float32),
                    on_dev(g_valid[order]),
                )
            tables = [on_dev(a) for a in (q_valid, plan.rot_idx, plan.rot_ok, plan.wv,
                                          plan.wh, plan.scale_hw)]
            out = np.zeros((n_q, len(g_valid)), np.float32)
            with self._stage("score"):
                for lo in range(0, n_q, pb):
                    take = np.minimum(np.arange(lo, lo + pb), n_q - 1)
                    take_d = on_dev(take)
                    kernels = build_kernels(
                        q_maps.index_select(0, take_d),
                        *[t.index_select(0, take_d) for t in tables],
                        kernel_hw=kernel_hw,
                        include_rots_unscaled=include_rots_unscaled,
                        n_scl=plan.n_scl,
                    )
                    wins, uniq, inv = batch_windows(q_valid[take], plan.scale_hw[take],
                                                    plan.n_scl)
                    scores = scorer(cache, PackedVariants(kernels, on_dev(wins)), layout,
                                    true_c, on_dev(uniq), on_dev(inv))
                    n_take = min(pb, n_q - lo)
                    out[lo : lo + n_take] = regroup_max(scores, layout).cpu().numpy()[:n_take]
                    if self.verbose:
                        print(f"  scored {lo + n_take}/{n_q} queries")
        return out[:, np.argsort(order)]

    def _cluster_features(self, plan):
        """Ingest + extract one cluster: (q_maps, q_valid, g_maps, g_valid, q_files)."""
        crop = self.config["dataset"]["crop"]
        n_threads = self.config["dataset"]["n_processes"]
        q_files = sorted(plan.files)
        gkey = GalleryFeatureCache.key(
            self.config["model"]["type"], plan.block, plan.scale,
            self.dataset.gallery_files,
            gallery_dir=self.dataset.gallery_dir, params=self._gcache_params,
        )
        g_cached = self.gallery_cache.get(gkey)
        with self._stage("ingest"):
            q_imgs = self._host_clahe(
                load_images(self.dataset.query_dir, q_files, plan.scale, crop, n_threads)
            )
            g_imgs = None
            if g_cached is None:
                g_imgs = self._host_clahe(load_images(
                    self.dataset.gallery_dir, self.dataset.gallery_files,
                    plan.scale, crop, n_threads,
                ))
        model = self._model_for_block(plan.block)
        with self._stage("extract-query"):
            q_maps, q_valid = self._extract(model, q_imgs)
        with self._stage("extract-gallery"):
            if g_cached is not None:
                g_maps = torch.as_tensor(g_cached[0], device=self.device)
                g_valid = np.asarray(g_cached[1])
            else:
                g_maps, g_valid = self._extract(model, g_imgs)
                self.gallery_cache.put(gkey, g_maps.cpu().numpy(), g_valid)
        return q_maps, q_valid, g_maps, g_valid, q_files

    def run_cluster(self, plan) -> ClusterOutput:
        """Score one cluster and rank (the reference's run.py:17-34 body)."""
        q_maps, q_valid, g_maps, g_valid, q_files = self._cluster_features(plan)
        scores = self._score_cluster(q_maps, q_valid, g_maps, g_valid)
        pairs = self.dataset.matching_pairs(q_files)
        ranks = ranks_from_scores(scores, pairs)
        if self.verbose:
            for qf, rank in zip(q_files, ranks):
                print(f"Print {parse_image_id(qf, self.dataset.type)} "
                      f"true match ranked {rank}")
        return ClusterOutput(ranks, pairs, len(q_files), plan.block, plan.scale, scores)

    def run(self):
        for plan in self.plans:
            if self.verbose:
                print(f"Cluster has {len(plan.files)} items.")
            yield self.run_cluster(plan)

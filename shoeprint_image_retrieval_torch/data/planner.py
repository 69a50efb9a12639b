"""Cluster planning: size clustering, scale/block selection ("Algorithm 1").

The port's own copy of ``shoeprint_image_retrieval_tpu/data/planner.py``
(pure Python; kept identical so both packages plan the same clusters).

The reference groups queries by smallest image dimension with (unseeded)
sklearn KMeans, merges clusters whose chosen scale is within a tolerance and
whose network block agrees, and picks a (scale, block) per cluster with a
recursive rule it calls Algorithm 1 (reference dataloader.py:255-419).

A cluster is also the *shape bucket*: every image in it is padded onto one
canvas and extracted as one masked batch.

Divergences from the reference, deliberate and documented:

* clustering is deterministic (seeded k-means); the reference's unseeded
  KMeans gives run-to-run different clusters (SURVEY.md section 4, item 4);
* ``image_extremes`` fixes two reference bugs — the (width, height) swap of
  PIL's ``.size`` and the ``elif`` that skips the smallest-dim update
  whenever the largest was updated (reference dataloader.py:446, 458-464);
  ``extremes_mode="reference"`` reproduces them for strict parity runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Literal, Sequence

from PIL import Image


def read_header_sizes(directory: Path, files: Sequence[str]) -> list[tuple[int, int]]:
    """(width, height) per file from image headers (no pixel decode)."""
    out = []
    for name in files:
        with Image.open(directory / name) as im:
            out.append((im.width, im.height))
    return out


def cluster_by_min_dim(
    sizes: Sequence[tuple[int, int]], n_clusters: int, seed: int = 0
) -> list[list[int]]:
    """Deterministic 1-D k-means on min(width, height); returns index groups.

    Same feature as the reference (dataloader.py:276-279) with a seeded,
    dependency-free Lloyd's iteration (the input is a small 1-D list).
    """
    feats = [min(w, h) for w, h in sizes]
    n_clusters = min(n_clusters, len(set(feats)))
    if n_clusters <= 1:
        return [list(range(len(feats)))]
    # k-means++-free deterministic init: evenly spaced quantiles of sorted values
    uniq = sorted(set(feats))
    centers = [uniq[round(i * (len(uniq) - 1) / (n_clusters - 1))] for i in range(n_clusters)]
    assign = [0] * len(feats)
    for _ in range(50):
        changed = False
        for i, f in enumerate(feats):
            best = min(range(n_clusters), key=lambda c: (abs(f - centers[c]), c))
            if best != assign[i]:
                assign[i] = best
                changed = True
        for c in range(n_clusters):
            members = [feats[i] for i in range(len(feats)) if assign[i] == c]
            if members:
                centers[c] = sum(members) / len(members)
        if not changed:
            break
    groups: dict[int, list[int]] = {}
    for i, a in enumerate(assign):
        groups.setdefault(a, []).append(i)
    return [groups[k] for k in sorted(groups)]


ExtremesMode = Literal["correct", "reference"]


def image_extremes(
    sizes: Sequence[tuple[int, int]],
    crop: Sequence[float],
    mode: ExtremesMode = "correct",
) -> tuple[int, int]:
    """(largest_dim, smallest_dim) over crop-adjusted image sizes.

    ``"correct"``: crop ratios applied to their own axes, both extremes
    tracked independently. ``"reference"`` replicates the reference's
    swapped-axes crop and elif-skip (reference dataloader.py:444-464) so a
    parity run can match its plans exactly.
    """
    largest = 0
    smallest = 2**31 - 1
    for width, height in sizes:
        if mode == "reference":
            h, w = width, height  # the reference's swapped unpack
        else:
            w, h = width, height
        ch = math.floor(h * crop[0] * 2)
        cw = math.floor(w * crop[1] * 2)
        h -= ch
        w -= cw
        big, small = max(w, h), min(w, h)
        if big > largest:
            largest = big
            if mode == "reference":
                continue  # elif-skip: smallest not updated this iteration
        if small < smallest:
            smallest = small
    return largest, smallest


@dataclass(frozen=True)
class PlannerConfig:
    minimum_dim: int
    maximum_dim: int
    start_block: int
    end_block: int
    skip_blocks: tuple[int, ...]
    cluster_tolerance: float


def find_best_scale(
    smallest_dim: int,
    largest_dim: int,
    cfg: PlannerConfig,
    minimum_dim: int | None = None,
    block: int | None = None,
) -> tuple[float, int]:
    """Algorithm 1: pick (image scale, network block) for a size range.

    Recursive rule (reference dataloader.py:366-419): if the smallest image
    is below ``minimum_dim``, step the block down (skipping non-resolution
    blocks) and halve the requirement; if the largest exceeds
    ``maximum_dim``, downscale, falling back to a lower block or an upscale
    if that pushes the smallest below the requirement.
    """
    minimum_dim = cfg.minimum_dim if minimum_dim is None else minimum_dim
    block = cfg.start_block if block is None else block
    scale = 1.0

    if smallest_dim < minimum_dim:
        if block > cfg.end_block:
            while True:
                block -= 1
                if block not in cfg.skip_blocks:
                    break
            return find_best_scale(
                smallest_dim, largest_dim, cfg, int(minimum_dim / 2), block
            )
        return 1.0, block
    if largest_dim > cfg.maximum_dim:
        scale = cfg.maximum_dim / largest_dim
        if smallest_dim * scale < minimum_dim:
            if block > cfg.end_block:
                while True:
                    block -= 1
                    if block not in cfg.skip_blocks or block == cfg.end_block:
                        break
            else:
                scale = minimum_dim / smallest_dim
    return scale, block


@dataclass
class ClusterPlan:
    files: list[str]
    scale: float
    block: int


def plan_clusters(
    query_sizes: Sequence[tuple[int, int]],
    query_files: Sequence[str],
    gallery_sizes: Sequence[tuple[int, int]],
    crop: Sequence[float],
    n_clusters: int,
    cfg: PlannerConfig,
    extremes_mode: ExtremesMode = "correct",
    seed: int = 0,
) -> list[ClusterPlan]:
    """Cluster queries, choose (scale, block) per cluster, merge within
    tolerance (reference dataloader.py:300-364)."""
    groups = cluster_by_min_dim(query_sizes, n_clusters, seed)
    g_large, g_small = image_extremes(gallery_sizes, crop, extremes_mode)

    plans: list[ClusterPlan] = []
    for idx_group in groups:
        q_sizes = [query_sizes[i] for i in idx_group]
        q_large, q_small = image_extremes(q_sizes, crop, extremes_mode)
        smallest = min(q_small, g_small)
        largest = max(q_large, g_large)
        scale, block = find_best_scale(smallest, largest, cfg)

        merged = False
        for plan in plans:
            if abs(scale - plan.scale) <= cfg.cluster_tolerance and plan.block == block:
                plan.files.extend(query_files[i] for i in idx_group)
                merged = True
                break
        if not merged:
            plans.append(
                ClusterPlan([query_files[i] for i in idx_group], scale, block)
            )
    return plans

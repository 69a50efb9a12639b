"""Config loading: the reference ``run.toml`` schema plus the ``[tpu]`` section.

Same parse as ``shoeprint_image_retrieval_tpu/config.py``: plain TOML, the
``""`` -> ``None`` normalisation of ``comparison.rotations`` /
``comparison.scales``, and the ``[tpu]`` section filled from
:data:`_TPU_DEFAULTS`, so one ``run.toml`` drives both packages.

:func:`check_supported` says which ``[tpu]`` keys this port honours:

* honoured: ``variant_mode``, ``extraction_batch``, ``probe_batch``,
  ``cache_dir``, ``clahe_host`` (true: the native host CLAHE where it can
  take the images exactly, streamed with extraction; false: CLAHE on the
  device in the extraction step), ``ncc_backend`` (``auto``/``pallas``
  = the CUDA kernel on a card, ``direct`` = its plain PyTorch version; on
  the CPU all three are the plain version; ``fft`` = the FFT correlation
  of ``ops/ncc.py`` on either device), ``gallery_block`` (prints per
  gallery block; 0 = the largest block that fits the card's free memory,
  one block on the CPU, and for ``fft`` the whole gallery),
  ``rank_on_device`` (scores stay on the device and ranks are counted
  there; ties in height-sorted column order; ``fft`` ignores it),
  ``pipeline_clusters`` (the next cluster's ingest and extraction on a
  lookahead thread while this one scores), ``prewarm`` (on a card, the NCC
  kernel builds on a thread from the moment the pipeline is made; nothing
  on the CPU or for ``fft``), ``profile_dir`` (one ``torch.profiler``
  Chrome trace per cluster there; empty = none), ``fusion_blocks`` (each
  cluster scored once per listed truncation block at its planned scale,
  the score matrices summed before ranking) and ``pruned_scoring`` with
  ``prune_channels`` and ``prune_margin`` (exact true-match ranks from a
  channel-prefix bound, ``retrieval/pruned.py``; no score matrix),
  ``precision`` (``"float32"``, or ``"bfloat16"``: the backbone convs with
  bf16 operands and f32 accumulation on a card, plain f32 on the CPU as
  XLA:CPU computes the JAX package's ``Precision.DEFAULT``; and the direct
  scorer's correlation on operands rounded to bf16, the NCC kernel's bf16
  leg on a card; ``fft`` scores in f32 either way) and ``cache_dtype``
  (``"float32"``, or ``"bfloat16"``: gallery maps at rest on the host, over
  the engine's maps budget or loaded from the gallery feature cache's
  host or disk copy, are held in bf16 while scored; maps on the device stay
  f32, and the cache and scoring stay f32);
  ``probe_batch = 0`` means 56 on the CPU and on a card the rows the card
  can take (``ops/ncc_kernel.auto_probe_rows``); ``mesh_shape`` (the
  gallery sharded over that many devices, ``parallel/``; 0 = every visible
  CUDA device, one on the CPU; a value over the device count is clamped to
  it, as the JAX engine's ``_mesh_size`` clamps to ``jax.devices()``);
* refused: ``pruned_scoring`` with ``fusion_blocks`` is a ``ValueError``
  (pruned mode never builds the matrices fusion sums), and so is a negative
  ``gallery_block``; other values of ``ncc_backend``,
  ``variant_mode``, ``precision`` and ``cache_dtype`` are a ``LookupError``.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

_TPU_DEFAULTS: dict = {
    "mesh_shape": 0,
    "precision": "float32",
    "cache_dir": "",
    "variant_mode": "reference",
    "extraction_batch": 32,
    "ncc_backend": "auto",
    "profile_dir": "",
    "probe_batch": 0,
    "gallery_block": 0,
    "clahe_host": True,
    "prewarm": True,
    "cache_dtype": "float32",
    "fusion_blocks": [],
    "rank_on_device": False,
    "pruned_scoring": False,
    "prune_channels": 0,
    "prune_margin": 5e-3,
    "pipeline_clusters": True,
}


def load_config(config_file: Path | str) -> dict:
    """Load a ``run.toml`` with reference-compatible semantics."""
    with Path(config_file).open("rb") as fh:
        raw = tomllib.load(fh)

    comparison = raw.get("comparison", {})
    if comparison.get("rotations") == "":
        comparison["rotations"] = None
    if comparison.get("scales") == "":
        comparison["scales"] = None

    tpu = dict(_TPU_DEFAULTS)
    tpu.update(raw.get("tpu", {}))
    raw["tpu"] = tpu
    return raw


def check_supported(config: dict) -> None:
    """Raise for ``[tpu]`` values the port cannot run."""
    tpu = config["tpu"]
    if tpu["ncc_backend"] not in ("auto", "pallas", "direct", "fft"):
        raise LookupError(f"Unknown tpu.ncc_backend: {tpu['ncc_backend']!r}")
    if tpu["variant_mode"] not in ("reference", "full"):
        raise LookupError(f"Unknown tpu.variant_mode: {tpu['variant_mode']!r}")
    if tpu["pruned_scoring"] and tpu["fusion_blocks"]:
        raise ValueError(
            "tpu.pruned_scoring is rank-only and cannot be combined with "
            "tpu.fusion_blocks (fusion sums score matrices; pruned mode never "
            "materializes one)")
    if int(tpu["gallery_block"]) < 0:
        raise ValueError(f"tpu.gallery_block must be >= 0, got {tpu['gallery_block']!r}")
    for key in ("precision", "cache_dtype"):
        if tpu[key] not in ("float32", "bfloat16"):
            raise LookupError(f"Unknown tpu.{key}: {tpu[key]!r}")

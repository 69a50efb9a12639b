"""Config loading: the reference ``run.toml`` schema plus the ``[tpu]`` section.

Same parse as ``shoeprint_image_retrieval_tpu/config.py``: plain TOML, the
``""`` -> ``None`` normalisation of ``comparison.rotations`` /
``comparison.scales``, and the ``[tpu]`` section filled from
:data:`_TPU_DEFAULTS`, so one ``run.toml`` drives both packages.

:func:`check_supported` says which ``[tpu]`` keys this port honours:

* honoured: ``variant_mode``, ``extraction_batch``, ``probe_batch``,
  ``cache_dir``, ``clahe_host`` and ``ncc_backend`` (``auto``/``pallas``
  = the CUDA kernel on a card, ``direct`` = its plain PyTorch version; on
  the CPU all three are the plain version);
* read and ignored, because they only shape TPU speed: ``prewarm``,
  ``pipeline_clusters``, ``gallery_block``, ``mesh_shape`` <= 1 and
  ``profile_dir``;
* refused with ``NotImplementedError`` naming the ROADMAP item that will
  port them: ``ncc_backend="fft"``, ``mesh_shape`` > 1, a non-empty
  ``fusion_blocks``, ``pruned_scoring``, ``rank_on_device``,
  ``precision``/``cache_dtype`` = ``"bfloat16"`` and ``clahe_host=false``.
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


def not_ported(what: str, item: int, title: str) -> NotImplementedError:
    """The error for a feature a later slice of the port brings."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: ROADMAP.md, 'Still to port', "
        f"item {item} ({title})"
    )


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
    """Raise for ``[tpu]`` values that need a later slice of the port."""
    tpu = config["tpu"]
    if tpu["ncc_backend"] == "fft":
        raise not_ported("tpu.ncc_backend = 'fft'", 4, "FFT backend")
    if tpu["ncc_backend"] not in ("auto", "pallas", "direct"):
        raise LookupError(f"Unknown tpu.ncc_backend: {tpu['ncc_backend']!r}")
    if tpu["variant_mode"] not in ("reference", "full"):
        raise LookupError(f"Unknown tpu.variant_mode: {tpu['variant_mode']!r}")
    if int(tpu["mesh_shape"]) > 1:
        raise not_ported("tpu.mesh_shape > 1", 8, "multi-GPU")
    if tpu["fusion_blocks"]:
        raise not_ported("tpu.fusion_blocks", 7, "fusion and pruning")
    if tpu["pruned_scoring"]:
        raise not_ported("tpu.pruned_scoring", 7, "fusion and pruning")
    if tpu["rank_on_device"]:
        raise not_ported("tpu.rank_on_device", 6, "on-device ranks")
    for key in ("precision", "cache_dtype"):
        if tpu[key] == "bfloat16":
            raise not_ported(f"tpu.{key} = 'bfloat16'", 10, "bf16 precision")
        if tpu[key] != "float32":
            raise LookupError(f"Unknown tpu.{key}: {tpu[key]!r}")
    if not tpu["clahe_host"]:
        raise not_ported("tpu.clahe_host = false", 2, "device CLAHE")

"""Backbone weights: torchvision state dicts, seeded init, JAX parameter trees.

Weights resolve in order (as in ``shoeprint_image_retrieval_tpu/models/
weights.py``):

1. ``{weights_dir}/{model_type}.npz``, ``.pth`` or ``.pt`` — a torchvision
   ``state_dict`` (``scripts/export_torchvision_weights.py`` writes the
   ``.npz``), loaded with ``load_state_dict``;
2. deterministic random init from a ``torch.Generator`` seeded by the
   sha256 of the model name, with a loud warning: rankings stay
   reproducible, accuracy is meaningless. Torch's generator gives other
   numbers than JAX's from the same seed, so the two packages agree only on
   a shared checkpoint.

:func:`params_from_jax` turns the JAX package's parameter tree (as numpy
arrays) into this port's state dict, so tests can run both packages on the
same weights.
"""

from __future__ import annotations

import hashlib
import math
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .densenet import CHILD_NAMES as DENSENET_NAMES
from .efficientnet import Features
from .registry import get_backbone

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def load_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """Load a ``.npz`` or torch ``.pth``/``.pt`` state dict as CPU tensors."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    return torch.load(path, map_location="cpu", weights_only=True)


def load_into(features: Features, sd: dict[str, torch.Tensor]) -> None:
    """Load a torchvision ``features.*`` state dict into (truncated) features.

    Every tensor the truncated module needs must be present (BN's
    ``num_batches_tracked`` counter excepted); tensors past the truncation
    point are ignored.
    """
    own = features.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint is missing {missing[:8]}")
    features.load_state_dict({k: sd[k] for k in own if k in sd}, strict=False)


def seeded_init(features: Features, model_type: str) -> None:
    """Deterministic init: conv weights and biases ~ U(-1/sqrt(fan_in), +),
    BatchNorm as identity (the JAX package's init distribution)."""
    seed = int.from_bytes(hashlib.sha256(model_type.encode()).digest()[:4], "little")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in features.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
                bound = 1.0 / math.sqrt(fan_in)
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=gen) * 2 * bound - bound)
                if mod.bias is not None:
                    mod.bias.copy_(torch.rand(mod.bias.shape, generator=gen) * 2 * bound - bound)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)


def find_checkpoint(weights_dir: str | Path | None, model_type: str) -> Path | None:
    """``{weights_dir}/{model_type}`` with the first of .npz, .pth, .pt that exists."""
    if weights_dir is None:
        return None
    for suffix in (".npz", ".pth", ".pt"):
        path = Path(weights_dir) / f"{model_type}{suffix}"
        if path.exists():
            return path
    return None


def build_model(
    model_type: str,
    block: int,
    weights_dir: str | Path | None = "weights",
    device: torch.device | str = "cuda",
) -> Features:
    """Truncated backbone ``features[:block]`` with weights, in eval mode on
    ``device`` (the card unless the caller asks for the CPU; reference
    Model.__init__, network.py:93-195)."""
    features = get_backbone(model_type).build(block)
    path = find_checkpoint(weights_dir, model_type)
    if path is not None:
        load_into(features, load_state_dict(path))
    else:
        print(
            f"[shoeprint-torch] WARNING: no checkpoint for {model_type} under "
            f"{weights_dir!r}; using seeded random init (retrieval accuracy will "
            "be meaningless until torchvision weights are exported there).",
            file=sys.stderr,
        )
        seeded_init(features, model_type)
    return features.to(device).eval()


def _cna(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.0.weight"] = p["conv"]["weight"]
    _bn(sd, f"{prefix}.1", p["bn"])


def _bn(sd: dict, prefix: str, p: dict) -> None:
    for k in _BN_KEYS:
        sd[f"{prefix}.{k}"] = p[k]


def _conv(sd: dict, prefix: str, p: dict) -> None:
    for k in ("weight", "bias"):
        if k in p:
            sd[f"{prefix}.{k}"] = p[k]


def _stage(sd: dict, prefix: str, blocks: dict) -> None:
    """EfficientNet stage: MBConv blocks carry ``dw``/``se`` (and ``expand``
    unless their expand ratio is 1), fused blocks ``project`` (and
    ``expand`` unless 1)."""
    for j, blk in blocks.items():
        bp = f"{prefix}.{j}.block"
        idx = 0
        if "expand" in blk:
            _cna(sd, f"{bp}.{idx}", blk["expand"])
            idx += 1
        if "dw" in blk:
            _cna(sd, f"{bp}.{idx}", blk["dw"])
            for fc in ("fc1", "fc2"):
                _conv(sd, f"{bp}.{idx + 1}.{fc}", blk["se"][fc])
            idx += 2
        _cna(sd, f"{bp}.{idx}", blk["project"])


def _child(sd: dict, prefix: str, child: dict) -> None:
    """One ``features`` child of any JAX backbone tree, by its keys."""
    if not child:  # ReLU, pools
        return
    if "conv" in child and "bn" in child:  # EfficientNet conv-BN-act
        _cna(sd, prefix, child)
    elif "running_var" in child:  # VGG BatchNorm, DenseNet norm0 / norm5
        _bn(sd, prefix, child)
    elif "weight" in child:  # VGG conv (with bias), DenseNet conv0
        _conv(sd, prefix, child)
    elif "norm" in child:  # DenseNet transition
        _bn(sd, f"{prefix}.norm", child["norm"])
        _conv(sd, f"{prefix}.conv", child["conv"])
    elif all("norm1" in layer for layer in child.values()):  # DenseNet dense block
        for j, layer in child.items():
            lp = f"{prefix}.denselayer{int(j) + 1}"
            for name in ("norm1", "norm2"):
                _bn(sd, f"{lp}.{name}", layer[name])
            for name in ("conv1", "conv2"):
                _conv(sd, f"{lp}.{name}", layer[name])
    else:
        _stage(sd, prefix, child)


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX backbone parameter tree (numpy leaves) -> port state dict.

    The tree is what the JAX package's ``Features.init`` or ``convert``
    returns for any of its backbones: ``{"0": child, "1": child, ...}``
    (``convert.py`` maps the same layouts from torchvision's keys). A
    DenseNet tree is told by its first child, a conv without a bias; its
    children take torchvision's names (``conv0``, ``denseblock1``, ...).
    """
    first = params.get("0", {})
    dense = set(first) == {"weight"}
    sd: dict = {}
    for i, child in params.items():
        name = DENSENET_NAMES[int(i)] if dense else i
        _child(sd, f"features.{name}", child)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}

"""Backbone weights made from the run's seed, on the device, in float32.

The scheme is the port's seeded init, frozen here: every conv weight and
bias ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)) (PyTorch's default conv init),
BatchNorm as the identity (weight 1, bias 0, running mean 0, variance 1).
One ``torch.Generator`` on the run's device draws all of it in one call,
split into the tensors in state-dict order; the shapes and keys come from
the plain reference's file for the architecture (``reference/nets/``),
under torchvision's names, so the same tensors load into the program
(``{weights_dir}/{model_type}.pt``) and feed the reference.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from .reference import backbones


def make(model_type: str, block: int, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """``features[:block]``'s state dict from ``seed``, float32 on ``device``."""
    shapes = backbones.param_shapes(backbones.network(model_type, block))
    drawn = [(k, s, kind) for k, (s, kind) in shapes.items()
             if kind == "conv" or kind.startswith("bias:")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out: dict[str, torch.Tensor] = {}
    off = 0
    for key, shape, kind in drawn:
        n = math.prod(shape)
        fan_in = math.prod(shape[1:]) if kind == "conv" else int(kind.split(":")[1])
        bound = 1.0 / math.sqrt(fan_in)
        out[key] = (flat[off : off + n].view(shape) * 2 - 1) * bound
        off += n
    for key, (shape, kind) in shapes.items():
        if kind == "one":
            out[key] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[key] = torch.zeros(shape, device=device)
    return {k: out[k] for k in shapes}


def save(weights: dict[str, torch.Tensor], directory: Path, model_type: str) -> Path:
    """Write the state dict where the program's ``weights_dir`` finds it."""
    path = Path(directory) / f"{model_type}.pt"
    torch.save({k: v.detach().cpu() for k, v in weights.items()}, path)
    return path

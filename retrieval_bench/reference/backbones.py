"""Plain truncated backbones, ``features[:block]``, one file an architecture.

Each architecture is ``nets/<type>.py``, named by the configuration's
``[model] type`` string and found by that name; nothing here knows one.
Written from torchvision's published layer tables, one image at a time at
its own size: no padding to a shared canvas, no masking, no kernels of the
program. A net file defines:

* ``NORMALISATION``: the (mean, std) the model is served with;
* ``BLOCKS``: the ``block`` values it defines;
* ``layers(block)``: its layer table for ``features[:block]``;
* ``channels(table)``, ``out_size(table, hw)``, ``param_shapes(table)``,
  ``forward(table, weights, x)`` and ``conv_flop(table, hw)`` over that
  table, as :mod:`.ops` defines them (most take those as their own).

The functions below are thin calls onto the loaded architecture, so
``weights``, ``flops``, ``check`` and ``harness`` read the same whatever
the architecture.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

import torch

NETS = Path(__file__).resolve().parent / "nets"


@dataclass(frozen=True)
class Net:
    """An architecture's module and its layer table for one ``block``."""

    arch: ModuleType
    table: object


def architecture(model_type: str) -> ModuleType:
    """The module ``nets/<model_type>.py``; ``LookupError`` where there is
    none."""
    path = NETS / f"{model_type}.py"
    if not model_type.isidentifier() or not path.is_file():
        raise LookupError(f"no plain reference for {model_type!r}")
    spec = importlib.util.spec_from_file_location(f"retrieval_bench.reference.nets.{model_type}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def network(model_type: str, block: int) -> Net:
    arch = architecture(model_type)
    return Net(arch, arch.layers(block))


def normalisation(net: Net) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """(mean, std) of the input, per channel."""
    return net.arch.NORMALISATION


def channels(net: Net) -> int:
    """Channels of the output."""
    return net.arch.channels(net.table)


def out_size(net: Net, hw: tuple[int, int]) -> tuple[int, int]:
    """The output (h, w) for an input of ``hw``."""
    return net.arch.out_size(net.table, hw)


def param_shapes(net: Net) -> dict[str, tuple[tuple[int, ...], str]]:
    """State-dict key -> (shape, init kind), in the order the weights are
    drawn: ``conv`` (``fan_in`` from the shape), ``bias:<fan_in>``, ``one``,
    ``zero``."""
    return net.arch.param_shapes(net.table)


def forward(net: Net, weights: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(1, 3, H, W) normalised image -> (1, C, h, w) features, in the
    weights' dtype and on their device."""
    return net.arch.forward(net.table, weights, x)


def conv_flop(net: Net, hw: tuple[int, int]) -> float:
    """FLOP (2 a multiply-add) of the convolutions on one image of ``hw``."""
    return net.arch.conv_flop(net.table, hw)

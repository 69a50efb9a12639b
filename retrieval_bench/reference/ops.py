"""A network as a list of :class:`Op` records, and their interpreter.

One record per conv or pool, in torchvision's ``features`` order and under
torchvision's state-dict keys (a conv with BatchNorm as ``<key>.0.weight``
and ``<key>.1.*``, one without as ``<key>.weight`` / ``<key>.bias``). The
same records give the weights' shapes (:func:`param_shapes`), each image's
output size (:func:`out_size`) and the convolutions' FLOP
(:func:`conv_flop`), and run the forward pass (:func:`forward`) in whatever
dtype the weights are given in. A file under ``nets/`` builds its table
and takes these functions as its own; one whose layers these records
cannot say brings its own.

Inference only: BatchNorm uses its running statistics; stochastic depth and
dropout are no-ops and are left out.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass
class Op:
    """One conv (with optional BatchNorm and activation) or pool.

    ``kind``: ``conv``, ``se`` (squeeze-excitation: ``key`` is its prefix),
    ``maxpool``, ``relu``. ``res_begin`` / ``res_end`` bracket a residual
    block (the input saved at ``res_begin`` is added after ``res_end``).
    ``eps`` is the BatchNorm's (torch's default where the net sets none).
    """

    kind: str
    key: str = ""
    cin: int = 0
    cout: int = 0
    k: int = 1
    stride: int = 1
    groups: int = 1
    bias: bool = False
    bn: bool = False
    act: str = ""          # "silu" or ""
    squeeze: int = 0       # SE hidden width
    res_begin: bool = False
    res_end: bool = False
    child: int = 0         # index of the torchvision features child
    eps: float = 1e-5


def channels(ops: list[Op]) -> int:
    """Channels of the last op's output."""
    return [o.cout for o in ops if o.kind == "conv"][-1]


def _pad(op: Op) -> int:
    return (op.k - 1) // 2 if op.kind == "conv" else 0


def out_size(ops: list[Op], hw: tuple[int, int]) -> tuple[int, int]:
    """The output (h, w) for an input of ``hw`` (torch's conv and pool
    arithmetic, floor mode)."""
    h, w = hw
    for op in ops:
        if op.kind in ("conv", "maxpool"):
            p = _pad(op)
            h = (h + 2 * p - op.k) // op.stride + 1
            w = (w + 2 * p - op.k) // op.stride + 1
    return h, w


def param_shapes(ops: list[Op]) -> dict[str, tuple[tuple[int, ...], str]]:
    """State-dict key -> (shape, init kind): ``conv`` weights and biases
    (``fan_in`` read from the weight's shape), BatchNorm's ``one`` / ``zero``
    entries."""
    out: dict[str, tuple[tuple[int, ...], str]] = {}
    for op in ops:
        if op.kind == "conv":
            wk = f"{op.key}.0.weight" if op.bn else f"{op.key}.weight"
            shape = (op.cout, op.cin // op.groups, op.k, op.k)
            out[wk] = (shape, "conv")
            if op.bias:
                out[f"{op.key}.bias"] = ((op.cout,), f"bias:{shape[1] * op.k * op.k}")
            if op.bn:
                for name, kind in (("weight", "one"), ("bias", "zero"),
                                   ("running_mean", "zero"), ("running_var", "one")):
                    out[f"{op.key}.1.{name}"] = ((op.cout,), kind)
        elif op.kind == "se":
            out[f"{op.key}.fc1.weight"] = ((op.squeeze, op.cin, 1, 1), "conv")
            out[f"{op.key}.fc1.bias"] = ((op.squeeze,), f"bias:{op.cin}")
            out[f"{op.key}.fc2.weight"] = ((op.cin, op.squeeze, 1, 1), "conv")
            out[f"{op.key}.fc2.bias"] = ((op.cin,), f"bias:{op.squeeze}")
    return out


def forward(ops: list[Op], weights: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(1, 3, H, W) normalised image -> (1, C, h, w) features, in the
    weights' dtype and on their device."""
    saved = None
    for op in ops:
        if op.res_begin:
            saved = x
        if op.kind == "conv":
            wk = f"{op.key}.0.weight" if op.bn else f"{op.key}.weight"
            bias = weights[f"{op.key}.bias"] if op.bias else None
            x = F.conv2d(x, weights[wk], bias, op.stride, _pad(op), 1, op.groups)
            if op.bn:
                pre = f"{op.key}.1"
                scale = weights[f"{pre}.weight"] / torch.sqrt(weights[f"{pre}.running_var"]
                                                              + op.eps)
                shift = weights[f"{pre}.bias"] - weights[f"{pre}.running_mean"] * scale
                x = x * scale[None, :, None, None] + shift[None, :, None, None]
            if op.act == "silu":
                x = F.silu(x)
        elif op.kind == "se":
            s = x.mean(dim=(2, 3), keepdim=True)
            s = F.silu(F.conv2d(s, weights[f"{op.key}.fc1.weight"], weights[f"{op.key}.fc1.bias"]))
            s = F.conv2d(s, weights[f"{op.key}.fc2.weight"], weights[f"{op.key}.fc2.bias"])
            x = x * torch.sigmoid(s)
        elif op.kind == "relu":
            x = F.relu(x)
        elif op.kind == "maxpool":
            x = F.max_pool2d(x, op.k, op.stride)
        if op.res_end:
            x = x + saved
            saved = None
    return x


def conv_flop(ops: list[Op], hw: tuple[int, int]) -> float:
    """Multiply-adds of every conv and squeeze-excitation 1 x 1 on one
    image of ``hw``, as FLOP (2 a multiply-add); BatchNorm, activations and
    pools are not counted."""
    h, w = hw
    total = 0.0
    for op in ops:
        if op.kind == "conv":
            p = _pad(op)
            h = (h + 2 * p - op.k) // op.stride + 1
            w = (w + 2 * p - op.k) // op.stride + 1
            total += 2.0 * (op.cin // op.groups) * op.k * op.k * op.cout * h * w
        elif op.kind == "se":
            total += 2.0 * 2 * op.cin * op.squeeze
        elif op.kind == "maxpool":
            h = (h - op.k) // op.stride + 1
            w = (w - op.k) // op.stride + 1
    return total

"""Plain truncated backbones: EfficientNetV2-M and VGG16 ``features[:block]``.

Written from torchvision's published layer tables (``efficientnet_v2_m``,
``vgg16``), one image at a time at its own size: no padding to a shared
canvas, no masking, no kernels of the program. A network is a list of
:class:`Op` records, one per conv or pool, in torchvision's ``features``
order and under torchvision's state-dict keys. The same records give the
weights' shapes (``retrieval_bench/weights.py``), each image's output size
and the convolutions' FLOP (``retrieval_bench/flops.py``), and run the
forward pass (:func:`forward`) in whatever dtype the weights are given in.

Inference only: BatchNorm uses its running statistics; stochastic depth and
dropout are no-ops and are left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

BN_EPS_V2 = 1e-3  # torchvision's EfficientNetV2 BatchNorm eps

# torchvision efficientnet_v2_m: (kind, expand, kernel, stride, in, out, layers)
_V2_M = [
    ("fused", 1, 3, 1, 24, 24, 3),
    ("fused", 4, 3, 2, 24, 48, 5),
    ("fused", 4, 3, 2, 48, 80, 5),
    ("mb", 4, 3, 2, 80, 160, 7),
    ("mb", 6, 3, 1, 160, 176, 14),
    ("mb", 6, 3, 2, 176, 304, 18),
    ("mb", 6, 3, 1, 304, 512, 5),
]
# torchvision vgg16 "D": channels, "M" = 2 x 2 max pool
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"]

# input normalisation (mean, std) each model is served with: ImageNet for
# V2-M, torchvision's IMAGENET1K_FEATURES statistics for VGG16
NORMALISATION = {
    "EfficientNetV2_M": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "VGG16": ((0.48235, 0.45882, 0.40784), (1 / 255.0, 1 / 255.0, 1 / 255.0)),
}


@dataclass
class Op:
    """One conv (with optional BatchNorm and activation) or pool.

    ``kind``: ``conv``, ``se`` (squeeze-excitation: ``key`` is its prefix),
    ``maxpool``, ``relu``. ``res_begin`` / ``res_end`` bracket a residual
    block (the input saved at ``res_begin`` is added after ``res_end``).
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
    act: str = ""          # "silu", "relu" or ""
    squeeze: int = 0       # SE hidden width
    res_begin: bool = False
    res_end: bool = False
    child: int = 0         # index of the torchvision features child
    extra: dict = field(default_factory=dict)


def _cna(ops, key, cin, cout, k, stride, groups, act, child):
    ops.append(Op("conv", key, cin, cout, k, stride, groups, bias=False, bn=True,
                  act="silu" if act else "", child=child))


def efficientnet_v2_m(block: int) -> list[Op]:
    """``features[:block]`` of EfficientNetV2-M (stem = child 0, stages 1-7,
    head = child 8)."""
    ops: list[Op] = []
    _cna(ops, "features.0", 3, 24, 3, 2, 1, True, 0)
    for s, (kind, expand, k, stride, cin, cout, n) in enumerate(_V2_M, start=1):
        if s >= block:
            break
        for j in range(n):
            i_ch = cin if j == 0 else cout
            st = stride if j == 0 else 1
            res = st == 1 and i_ch == cout
            pre = f"features.{s}.{j}.block"
            first = len(ops)
            if kind == "fused":
                if expand != 1:
                    e = i_ch * expand
                    _cna(ops, f"{pre}.0", i_ch, e, k, st, 1, True, s)
                    _cna(ops, f"{pre}.1", e, cout, 1, 1, 1, False, s)
                else:
                    _cna(ops, f"{pre}.0", i_ch, cout, k, st, 1, True, s)
            else:
                e = i_ch * expand
                idx = 0
                if expand != 1:
                    _cna(ops, f"{pre}.0", i_ch, e, 1, 1, 1, True, s)
                    idx = 1
                _cna(ops, f"{pre}.{idx}", e, e, k, st, e, True, s)
                ops.append(Op("se", f"{pre}.{idx + 1}", e, e, squeeze=max(1, i_ch // 4), child=s))
                _cna(ops, f"{pre}.{idx + 2}", e, cout, 1, 1, 1, False, s)
            if res:
                ops[first].res_begin = True
                ops[-1].res_end = True
    if block > len(_V2_M) + 1:
        _cna(ops, f"features.{len(_V2_M) + 1}", _V2_M[-1][5], 1280, 1, 1, 1, True, len(_V2_M) + 1)
    return ops


def vgg16(block: int) -> list[Op]:
    """``features[:block]`` of VGG16: every conv, ReLU and pool its own child."""
    ops: list[Op] = []
    child, cin = 0, 3
    for v in _VGG16:
        if child >= block:
            break
        if v == "M":
            ops.append(Op("maxpool", k=2, stride=2, child=child))
            child += 1
            continue
        ops.append(Op("conv", f"features.{child}", cin, v, 3, 1, 1, bias=True, child=child))
        child += 1
        if child < block:
            ops.append(Op("relu", child=child))
            child += 1
        cin = v
    return ops


ARCHITECTURES = {"EfficientNetV2_M": efficientnet_v2_m, "VGG16": vgg16}


def network(model_type: str, block: int) -> list[Op]:
    try:
        return ARCHITECTURES[model_type](block)
    except KeyError:
        raise LookupError(f"no plain reference for {model_type!r}") from None


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
                                                              + BN_EPS_V2)
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

"""DenseNet-201 ``features[:block]``, from Huang et al., "Densely Connected
Convolutional Networks" (2017, arXiv:1608.06993), Table 1, under
torchvision's ``densenet201`` layer and state-dict names. Served with
ImageNet's normalisation, as torchvision's IMAGENET1K_V1 weights are.

``features`` has twelve named children: ``conv0`` (7 x 7 / 2, 64 channels),
``norm0``, ``relu0``, ``pool0`` (3 x 3 / 2 max pool, padding 1), then
``denseblock1`` .. ``denseblock4`` of 6, 12, 48 and 32 dense layers with a
``transition`` after each of the first three, and ``norm5``. A dense layer
(growth k = 32, bottleneck 4k = 128) is BN-ReLU, a 1 x 1 conv to 128,
BN-ReLU, a 3 x 3 conv to 32 (padding 1), its output concatenated after its
input's channels. A transition (compression 0.5) is BN-ReLU, a 1 x 1 conv to
half the channels and a 2 x 2 average pool, stride 2.

Inference only: BatchNorm uses its running statistics (eps 1e-5, torch's
default, which torchvision keeps). No departure from the published net but
the truncation at ``block``; dropout (0 in torchvision's ``densenet201``)
and the classifier lie past ``features``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["NORMALISATION", "BLOCKS", "layers", "channels", "out_size", "param_shapes",
           "forward", "conv_flop"]

NORMALISATION = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
BLOCKS = range(1, 13)
BN_EPS = 1e-5
GROWTH, BOTTLENECK, STEM = 32, 4 * 32, 64
BLOCK_LAYERS = (6, 12, 48, 32)

# One op a tuple:
#   ("conv", key, in, out, kernel, stride, padding)   no bias
#   ("bn", key, channels)
#   ("relu",)
#   ("maxpool", kernel, stride, padding)
#   ("avgpool", kernel, stride)
#   ("dense", key, in)   one dense layer, its output concatenated onto its input


def _children() -> list[list[tuple]]:
    """The twelve children of ``features``, each a list of ops."""
    out = [[("conv", "features.conv0", 3, STEM, 7, 2, 3)], [("bn", "features.norm0", STEM)],
           [("relu",)], [("maxpool", 3, 2, 1)]]
    c = STEM
    for i, n in enumerate(BLOCK_LAYERS, start=1):
        out.append([("dense", f"features.denseblock{i}.denselayer{j + 1}", c + j * GROWTH)
                    for j in range(n)])
        c += n * GROWTH
        if i < len(BLOCK_LAYERS):
            t = f"features.transition{i}"
            out.append([("bn", f"{t}.norm", c), ("relu",),
                        ("conv", f"{t}.conv", c, c // 2, 1, 1, 0), ("avgpool", 2, 2)])
            c //= 2
    out.append([("bn", "features.norm5", c)])
    return out


def layers(block: int) -> list[tuple]:
    """``features[:block]`` as one list of ops."""
    if block not in BLOCKS:
        raise ValueError(f"block {block} outside {BLOCKS.start}..{BLOCKS.stop - 1}")
    return [op for child in _children()[:block] for op in child]


def _dense(key: str, cin: int) -> list[tuple]:
    """A dense layer's ops, before the concatenation."""
    return [("bn", f"{key}.norm1", cin), ("relu",),
            ("conv", f"{key}.conv1", cin, BOTTLENECK, 1, 1, 0),
            ("bn", f"{key}.norm2", BOTTLENECK), ("relu",),
            ("conv", f"{key}.conv2", BOTTLENECK, GROWTH, 3, 1, 1)]


def channels(table: list[tuple]) -> int:
    c = 3
    for op in table:
        if op[0] == "conv":
            c = op[3]
        elif op[0] == "dense":
            c = op[2] + GROWTH
    return c


def _walk(table: list[tuple], hw: tuple[int, int]) -> tuple[int, int, float]:
    """(h, w) after ``table`` from ``hw`` (torch's floor arithmetic), and the
    convs' FLOP (2 a multiply-add)."""
    h, w = hw
    total = 0.0
    for op in table:
        if op[0] == "conv":
            _, _, cin, cout, k, s, p = op
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            total += 2.0 * cin * k * k * cout * h * w
        elif op[0] == "maxpool":
            _, k, s, p = op
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        elif op[0] == "avgpool":
            _, k, s = op
            h, w = (h - k) // s + 1, (w - k) // s + 1
        elif op[0] == "dense":
            total += _walk(_dense(op[1], op[2]), (h, w))[2]
    return h, w, total


def out_size(table: list[tuple], hw: tuple[int, int]) -> tuple[int, int]:
    return _walk(table, hw)[:2]


def conv_flop(table: list[tuple], hw: tuple[int, int]) -> float:
    return _walk(table, hw)[2]


def param_shapes(table: list[tuple]) -> dict[str, tuple[tuple[int, ...], str]]:
    """State-dict key -> (shape, kind) in torchvision's order: a conv's
    ``weight`` (``conv``); a BatchNorm's ``weight`` (``one``), ``bias``
    (``zero``), ``running_mean`` (``zero``), ``running_var`` (``one``)."""
    out: dict[str, tuple[tuple[int, ...], str]] = {}
    for op in table:
        if op[0] == "conv":
            _, key, cin, cout, k, _, _ = op
            out[f"{key}.weight"] = ((cout, cin, k, k), "conv")
        elif op[0] == "bn":
            for name, kind in (("weight", "one"), ("bias", "zero"),
                               ("running_mean", "zero"), ("running_var", "one")):
                out[f"{op[1]}.{name}"] = ((op[2],), kind)
        elif op[0] == "dense":
            out.update(param_shapes(_dense(op[1], op[2])))
    return out


def forward(table: list[tuple], weights: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(1, 3, H, W) normalised image -> (1, C, h, w) features, in the
    weights' dtype and on their device."""
    for op in table:
        if op[0] == "conv":
            _, key, _, _, _, s, p = op
            x = F.conv2d(x, weights[f"{key}.weight"], None, s, p)
        elif op[0] == "bn":
            k = op[1]
            scale = weights[f"{k}.weight"] / torch.sqrt(weights[f"{k}.running_var"] + BN_EPS)
            shift = weights[f"{k}.bias"] - weights[f"{k}.running_mean"] * scale
            x = x * scale[None, :, None, None] + shift[None, :, None, None]
        elif op[0] == "relu":
            x = F.relu(x)
        elif op[0] == "maxpool":
            x = F.max_pool2d(x, op[1], op[2], op[3])
        elif op[0] == "avgpool":
            x = F.avg_pool2d(x, op[1], op[2])
        elif op[0] == "dense":
            x = torch.cat([x, forward(_dense(op[1], op[2]), weights, x)], 1)
    return x

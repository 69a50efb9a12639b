"""EfficientNetV2-M ``features[:block]``, from torchvision's published layer
table (``efficientnet_v2_m``): the stem is child 0, the stages children
1-7, the 1 x 1 head child 8. Served with ImageNet's normalisation."""

from __future__ import annotations

from retrieval_bench.reference.ops import Op, channels, conv_flop, forward, out_size, param_shapes

__all__ = ["NORMALISATION", "BLOCKS", "layers", "channels", "out_size", "param_shapes",
           "forward", "conv_flop"]

NORMALISATION = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
BLOCKS = range(1, 10)
BN_EPS = 1e-3  # torchvision's EfficientNetV2 BatchNorm eps

# (kind, expand, kernel, stride, in, out, layers) of each stage
STAGES = [
    ("fused", 1, 3, 1, 24, 24, 3),
    ("fused", 4, 3, 2, 24, 48, 5),
    ("fused", 4, 3, 2, 48, 80, 5),
    ("mb", 4, 3, 2, 80, 160, 7),
    ("mb", 6, 3, 1, 160, 176, 14),
    ("mb", 6, 3, 2, 176, 304, 18),
    ("mb", 6, 3, 1, 304, 512, 5),
]


def _cna(ops, key, cin, cout, k, stride, groups, act, child):
    ops.append(Op("conv", key, cin, cout, k, stride, groups, bias=False, bn=True,
                  act="silu" if act else "", child=child, eps=BN_EPS))


def layers(block: int) -> list[Op]:
    ops: list[Op] = []
    _cna(ops, "features.0", 3, 24, 3, 2, 1, True, 0)
    for s, (kind, expand, k, stride, cin, cout, n) in enumerate(STAGES, start=1):
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
    if block > len(STAGES) + 1:
        _cna(ops, f"features.{len(STAGES) + 1}", STAGES[-1][5], 1280, 1, 1, 1, True,
             len(STAGES) + 1)
    return ops

"""VGG16 ``features[:block]``, from torchvision's published layer table
(``vgg16``, configuration "D"): every conv, ReLU and pool its own child.
Served with torchvision's IMAGENET1K_FEATURES statistics."""

from __future__ import annotations

from retrieval_bench.reference.ops import Op, channels, conv_flop, forward, out_size, param_shapes

__all__ = ["NORMALISATION", "BLOCKS", "layers", "channels", "out_size", "param_shapes",
           "forward", "conv_flop"]

NORMALISATION = ((0.48235, 0.45882, 0.40784), (1 / 255.0, 1 / 255.0, 1 / 255.0))
BLOCKS = range(1, 32)

# channels of each conv, "M" a 2 x 2 max pool
TABLE = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"]


def layers(block: int) -> list[Op]:
    ops: list[Op] = []
    child, cin = 0, 3
    for v in TABLE:
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

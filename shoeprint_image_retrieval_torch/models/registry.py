"""Backbone registry: the reference's model strings -> port backbones.

The reference selects among 13 torchvision classifiers by name (reference
network.py:121-182). This slice of the port carries ``EfficientNetV2_M``,
the main path's backbone; the other 12 names raise ``NotImplementedError``
naming the ROADMAP item that ports them, and unknown names raise
``LookupError`` as the reference does (network.py:180-182).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..config import not_ported
from .efficientnet import Features, efficientnet_v2

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class BackboneSpec:
    build: Callable[[int | None], Features]  # truncation block -> features[:block]
    weights_tag: str  # torchvision weights enum the reference uses
    mean: tuple[float, float, float] = IMAGENET_MEAN
    std: tuple[float, float, float] = IMAGENET_STD


REGISTRY: dict[str, BackboneSpec] = {
    "EfficientNetV2_M": BackboneSpec(lambda block: efficientnet_v2("M", block), "IMAGENET1K_V1"),
}

NOT_PORTED = (
    "VGG19", "VGG16", "VGG19_BN",
    "EfficientNet_B1", "EfficientNet_B2", "EfficientNet_B3", "EfficientNet_B4",
    "EfficientNet_B5", "EfficientNet_B7",
    "EfficientNetV2_S", "EfficientNetV2_L",
    "DenseNet_201",
)


def get_backbone(model_type: str) -> BackboneSpec:
    if model_type in REGISTRY:
        return REGISTRY[model_type]
    if model_type in NOT_PORTED:
        raise not_ported(f"backbone {model_type!r}", 3, "the other 12 backbones")
    raise LookupError(
        f"Model string not found: {model_type!r} "
        f"(available: {sorted(REGISTRY) + sorted(NOT_PORTED)})"
    )

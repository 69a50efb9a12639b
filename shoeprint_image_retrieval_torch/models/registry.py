"""Backbone registry: the reference's 13 model strings -> port backbones.

The reference selects among 13 torchvision classifiers by name (reference
network.py:121-182). Each entry carries the build function, the torchvision
weights tag the reference loads, and the input normalisation (reference
network.py:51-87: ImageNet defaults; VGG16's ``IMAGENET1K_FEATURES``
statistics; EfficientNetV2_L 0.5 / 0.5), as the JAX package's
``models/registry.py`` does. Unknown names raise ``LookupError`` as the
reference does (network.py:180-182).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .densenet import densenet201
from .efficientnet import Features, efficientnet_v1, efficientnet_v2
from .vgg import vgg

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG16_FEATURES_MEAN = (0.48235, 0.45882, 0.40784)
VGG16_FEATURES_STD = (1 / 255.0, 1 / 255.0, 1 / 255.0)


@dataclass(frozen=True)
class BackboneSpec:
    build: Callable[[int | None], Features]  # truncation block -> features[:block]
    weights_tag: str  # torchvision weights enum the reference uses
    mean: tuple[float, float, float] = IMAGENET_MEAN
    std: tuple[float, float, float] = IMAGENET_STD


def _v1(variant: str) -> Callable[[int | None], Features]:
    return lambda block: efficientnet_v1(variant, block)


def _v2(variant: str) -> Callable[[int | None], Features]:
    return lambda block: efficientnet_v2(variant, block)


def _vgg(variant: str) -> Callable[[int | None], Features]:
    return lambda block: vgg(variant, block)


REGISTRY: dict[str, BackboneSpec] = {
    "VGG19": BackboneSpec(_vgg("VGG19"), "IMAGENET1K_V1"),
    "VGG16": BackboneSpec(_vgg("VGG16"), "IMAGENET1K_FEATURES",
                          VGG16_FEATURES_MEAN, VGG16_FEATURES_STD),
    "VGG19_BN": BackboneSpec(_vgg("VGG19_BN"), "IMAGENET1K_V1"),
    "EfficientNet_B1": BackboneSpec(_v1("B1"), "IMAGENET1K_V2"),
    "EfficientNet_B2": BackboneSpec(_v1("B2"), "IMAGENET1K_V1"),
    "EfficientNet_B3": BackboneSpec(_v1("B3"), "IMAGENET1K_V1"),
    "EfficientNet_B4": BackboneSpec(_v1("B4"), "IMAGENET1K_V1"),
    "EfficientNet_B5": BackboneSpec(_v1("B5"), "IMAGENET1K_V1"),
    "EfficientNet_B7": BackboneSpec(_v1("B7"), "IMAGENET1K_V1"),
    "EfficientNetV2_S": BackboneSpec(_v2("S"), "IMAGENET1K_V1"),
    "EfficientNetV2_M": BackboneSpec(_v2("M"), "IMAGENET1K_V1"),
    "EfficientNetV2_L": BackboneSpec(_v2("L"), "IMAGENET1K_V1",
                                     (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "DenseNet_201": BackboneSpec(densenet201, "IMAGENET1K_V1"),
}


def get_backbone(model_type: str) -> BackboneSpec:
    try:
        return REGISTRY[model_type]
    except KeyError:
        raise LookupError(
            f"Model string not found: {model_type!r} (available: {sorted(REGISTRY)})"
        ) from None

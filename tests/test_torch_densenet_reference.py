"""The port's DenseNet-201 against the benchmark's plain float64 reference
(``retrieval_bench/reference/nets/DenseNet_201.py``), image by image.

One seeded state dict (``retrieval_bench.weights.make``, its BatchNorms then
moved off the identity so that their statistics and eps count) is loaded into
the port's ``densenet201(block)`` through ``models/weights.load_into``, which
runs one ragged batch of three odd-sized images zero-padded to one canvas:
every floor of the stem's conv and padded max pool and of the transitions'
average pools, and each image's ``valid_hw``, decide what the valid region
holds. Each image's valid region is held against the reference run on that
image alone at its own size, at blocks 6 (``transition1``), 7
(``denseblock2``) and 8 (``transition2``).
"""

import pytest
import torch

from retrieval_bench import weights as bench_weights
from retrieval_bench.reference import backbones
from shoeprint_image_retrieval_torch.models import layers as L
from shoeprint_image_retrieval_torch.models.densenet import densenet201
from shoeprint_image_retrieval_torch.models.weights import load_into

SIZES = [(97, 83), (64, 56), (131, 109)]
# float32 against float64 over at most 18 dense layers and two transitions:
# the worst element's error, over the largest magnitude of that image's
# maps, is 2e-7 to 5e-7 here (the rounding of float32's 24 bits, grown over
# the layers); bf16 convs (8 bits) give 3e-3 to 4e-3. The limit sits 40x
# above the one and 150x below the other.
REL_TOL = 2e-5


def _state(block: int) -> dict[str, torch.Tensor]:
    sd = bench_weights.make("DenseNet_201", block, 2**31 + 7, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    for k in sd:
        if k.endswith(("norm0.weight", "norm1.bias", "norm2.running_mean", "norm.running_var",
                       "norm2.weight", "norm.bias")):
            sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
    return sd


def _worst(block: int, sd: dict, images: list[torch.Tensor]) -> float:
    """The port's batch against the float64 reference: the largest error of
    any image over its valid region, relative to that image's largest map."""
    model = densenet201(block)
    load_into(model, sd)
    model.eval()
    hmax, wmax = max(h for h, _ in SIZES), max(w for _, w in SIZES)
    x = torch.zeros((len(images), 3, hmax, wmax))
    for i, img in enumerate(images):
        x[i, :, : img.shape[1], : img.shape[2]] = img
    valid = torch.tensor(SIZES, dtype=torch.int32)
    net = backbones.network("DenseNet_201", block)
    sd64 = {k: v.double() for k, v in sd.items()}
    with torch.inference_mode():
        maps, vout = model(x, valid)
        worst = 0.0
        for i, img in enumerate(images):
            ref = backbones.forward(net, sd64, img[None].double())[0]
            h, w = backbones.out_size(net, SIZES[i])
            assert tuple(ref.shape) == (maps.shape[1], h, w)
            assert vout[i].tolist() == [h, w]
            assert not maps[i, :, h:].any() and not maps[i, :, :, w:].any()
            err = (maps[i, :, :h, :w].double() - ref).abs().max() / ref.abs().max()
            worst = max(worst, float(err))
    return worst


@pytest.mark.parametrize("block", [6, 7, 8])
def test_port_matches_the_plain_reference_image_by_image(block, monkeypatch):
    sd = _state(block)
    gen = torch.Generator().manual_seed(block)
    images = [torch.randn((3, h, w), generator=gen) for h, w in SIZES]
    assert _worst(block, sd, images) <= REL_TOL
    # the tolerance tells float32 convs from bf16 ones
    monkeypatch.setattr(L, "conv_route", lambda precision, device: "bf16")
    assert _worst(block, sd, images) > 10 * REL_TOL

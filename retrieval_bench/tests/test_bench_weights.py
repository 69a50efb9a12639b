"""The seeded weights load into the program's backbones under their names
and are the same for the same seed."""

from __future__ import annotations

import pytest
import torch

from retrieval_bench import weights
from shoeprint_image_retrieval_torch.models.weights import build_model


@pytest.mark.parametrize("model,block", [("EfficientNetV2_M", 6), ("VGG16", 24)])
def test_weights_load_into_the_program(model, block, tmp_path):
    w = weights.make(model, block, 2**31 + 1, torch.device("cpu"))
    weights.save(w, tmp_path, model)
    net = build_model(model, block, tmp_path, "cpu")
    own = net.state_dict()
    for k, v in w.items():
        assert torch.equal(own[k], v), k
    again = weights.make(model, block, 2**31 + 1, torch.device("cpu"))
    assert all(torch.equal(again[k], w[k]) for k in w)

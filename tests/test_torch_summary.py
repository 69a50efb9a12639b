"""``models/summary.output_size`` against the JAX package's and the forward.

For all 13 model strings at three input sizes: the port's analytic output
size equals JAX ``summary.output_size`` (a shape-only trace) and the valid
sizes the port's masked forward returns for those inputs in one batch.
VGG runs whole; DenseNet-201 and the EfficientNets are cut at stride 16
(through ``transition2``; the reference's ``start_block`` 6), where the JAX
trace of the deeper blocks would take most of a minute per model.
"""

import pytest
import torch

from shoeprint_image_retrieval_tpu.models.registry import REGISTRY as JREG
from shoeprint_image_retrieval_tpu.models.registry import get_backbone as jget
from shoeprint_image_retrieval_tpu.models.summary import output_size as jout
from shoeprint_image_retrieval_torch.models.registry import get_backbone as tget
from shoeprint_image_retrieval_torch.models.summary import describe, output_size

SIZES = [(64, 48), (97, 121), (33, 35)]
# VGG whole (stride 32); the others at stride 16
BLOCKS = {"VGG16": 31, "VGG19": 37, "VGG19_BN": 53, "DenseNet_201": 8}


@pytest.mark.parametrize("name", sorted(JREG))
def test_output_size_matches_jax_and_forward(name):
    block = BLOCKS.get(name, 6)
    jf = jget(name).build().truncate(block)
    tf = tget(name).build(block)
    tf.eval()
    got = [output_size(tf, hw) for hw in SIZES]
    assert got == [tuple(jout(jf, hw)) for hw in SIZES]
    x = torch.zeros((len(SIZES), 3, 121, 121))
    with torch.inference_mode():
        y, valid = tf(x, torch.tensor(SIZES, dtype=torch.int32))
    assert [(y.shape[1], *v) for v in valid.tolist()] == got
    text = describe(tf)
    assert text.count("\n") == block and type(list(tf.features)[-1]).__name__ in text

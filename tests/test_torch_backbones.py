"""The port's other 12 backbones against the JAX package's.

* Every new model string: the JAX parameter tree, filled with seeded numpy
  values (BN variances in [0.5, 2]), carried across with
  ``params_from_jax``; the port's truncated forward matches JAX
  ``features.apply`` to 1e-4 of the activation scale on a masked batch of
  two sizes, with equal valid sizes (the blocks of
  ``tests/test_weight_parity.py:125-136``).
* One model of each family (VGG16, DenseNet_201, EfficientNet_B1): batched
  output equals per-image output and is zero outside the valid region; the
  ``params_from_jax`` keys are the truncated torchvision-layout replica's
  (``tests/torch_effnet_replica.py``); a replica ``.npz`` loaded by
  ``build_model`` gives the replica's own forward and the JAX ``convert``
  route's.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_tpu.models.registry import get_backbone as jget
from shoeprint_image_retrieval_tpu.models.weights import load_or_init_params
from shoeprint_image_retrieval_torch.device import set_float32_precision
from shoeprint_image_retrieval_torch.models import weights as tw
from shoeprint_image_retrieval_torch.models.registry import get_backbone as tget

sys.path.insert(0, str(Path(__file__).parent))
from torch_effnet_replica import (  # noqa: E402
    replica_b1,
    replica_densenet201,
    replica_v1,
    replica_v2,
    replica_vgg,
)

TOL = 1e-4  # relative to the activation scale (float32 convs in another order)
# the truncation blocks of tests/test_weight_parity.py:125-136
BLOCKS = {
    "VGG16": 7, "VGG19": 7, "VGG19_BN": 10, "DenseNet_201": 6,
    "EfficientNet_B1": 4, "EfficientNet_B2": 4, "EfficientNet_B3": 4, "EfficientNet_B4": 4,
    "EfficientNet_B5": 4, "EfficientNet_B7": 4, "EfficientNetV2_S": 4, "EfficientNetV2_L": 4,
}
REPLICAS = {
    "VGG16": lambda: replica_vgg("VGG16"),
    "DenseNet_201": replica_densenet201,
    "EfficientNet_B1": replica_b1,
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((2, 3, 48, 44), np.float32)
    valid = np.asarray([[48, 44], [37, 29]], np.int32)
    for i, (h, w) in enumerate(valid):
        x[i, :, :h, :w] = rng.normal(size=(3, h, w))
    return x, valid


def _close(got, want):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(scale, 1.0), f"max abs err {err} (scale {scale})"


def _jax_tree(name, block, seed=0):
    """The JAX features and their parameter tree's structure filled with
    seeded numpy values."""
    features = jget(name).build().truncate(block)
    shapes = jax.eval_shape(features.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if "running_var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)

    return features, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_params_from_jax_matches_jax_forward(name):
    set_float32_precision()
    block = BLOCKS[name]
    jf, params = _jax_tree(name, block)
    tf = tget(name).build(block)
    tw.load_into(tf, tw.params_from_jax(params))
    tf.eval()
    x, valid = _inputs(0)
    want, want_v = jf.apply(params, jnp.asarray(x), jnp.asarray(valid))
    with torch.inference_mode():
        got, got_v = tf(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got.shape == want.shape
    assert got.shape[1] == tf.out_channels[-1] == jf.out_channels[-1]
    _close(got.numpy(), np.asarray(want))


def _replica(name, block):
    """A seeded torchvision-layout replica and its state dict cut to the
    kept children (DenseNet's children are named: its keys are filtered)."""
    model = REPLICAS[name]()
    names = [n for n, _ in model.features.named_children()][:block]
    sd = {k: v.numpy() for k, v in model.state_dict().items() if k.split(".")[1] in names}
    return model, sd


@pytest.mark.parametrize("name", sorted(REPLICAS))
def test_family_batched_equals_per_image_and_is_masked(name):
    set_float32_precision()
    block = BLOCKS[name]
    _, params = _jax_tree(name, block, seed=1)
    tf = tget(name).build(block)
    tw.load_into(tf, tw.params_from_jax(params))
    tf.eval()
    x, valid = _inputs(2)
    with torch.inference_mode():
        got, got_v = tf(torch.from_numpy(x), torch.from_numpy(valid))
        for i, (h, w) in enumerate(valid):
            one, one_v = tf(torch.from_numpy(x[i : i + 1, :, :h, :w].copy()),
                            torch.from_numpy(valid[i : i + 1]))
            vh, vw = one_v[0].tolist()
            assert got_v[i].tolist() == [vh, vw] == list(one.shape[-2:])
            np.testing.assert_allclose(got[i, :, :vh, :vw].numpy(), one[0].numpy(),
                                       rtol=1e-5, atol=1e-5)
            assert int(torch.count_nonzero(got[i, :, vh:, :])) == 0
            assert int(torch.count_nonzero(got[i, :, :, vw:])) == 0


@pytest.mark.parametrize("name", sorted(REPLICAS))
def test_family_key_set_is_the_replicas(name):
    block = BLOCKS[name]
    _, params = _jax_tree(name, block)
    _, replica_sd = _replica(name, block)
    want = {k for k in replica_sd if not k.endswith("num_batches_tracked")}
    assert set(tw.params_from_jax(params)) == want
    own = {k for k in tget(name).build(block).state_dict()
           if not k.endswith("num_batches_tracked")}
    assert own == want


@pytest.mark.parametrize("name", sorted(REPLICAS))
def test_family_checkpoint_matches_replica_and_jax_convert(tmp_path, name):
    set_float32_precision()
    block = BLOCKS[name]
    model, sd = _replica(name, block)
    wdir = tmp_path / "weights"
    wdir.mkdir()
    np.savez(wdir / f"{name}.npz", **sd)
    tf = tw.build_model(name, block, wdir, "cpu")
    jf = jget(name).build().truncate(block)
    jparams = load_or_init_params(jf, name, wdir)
    x, valid = _inputs(3)
    want, _ = jf.apply(jparams, jnp.asarray(x), jnp.asarray(valid))
    with torch.inference_mode():
        got, _ = tf(torch.from_numpy(x), torch.from_numpy(valid))
        replica = model.features[:block](torch.from_numpy(x[:1]))
    _close(got.numpy(), np.asarray(want))
    _close(got[:1].numpy(), replica.numpy())
    missing = dict(sd)
    missing.pop(sorted(k for k in sd if k.endswith("weight"))[-1])
    with pytest.raises(KeyError):
        tw.load_into(tget(name).build(block), {k: torch.from_numpy(v) for k, v in missing.items()})


def test_other_replicas_load_into_the_port():
    """B2 and V2_S replica state dicts (truncated) load with the port's key
    layout and reproduce the replica's forward."""
    set_float32_precision()
    x, _ = _inputs(4)
    for name, model in (("EfficientNet_B2", replica_v1("B2")), ("EfficientNetV2_S", replica_v2("S"))):
        model.features = model.features[:4]
        tf = tget(name).build(4)
        tw.load_into(tf, model.state_dict())
        tf.eval()
        with torch.inference_mode():
            got, _ = tf(torch.from_numpy(x[:1]), torch.tensor([[48, 44]], dtype=torch.int32))
            want = model.features(torch.from_numpy(x[:1]))
        _close(got.numpy(), want.numpy())

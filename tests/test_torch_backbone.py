"""The port's masked EfficientNetV2_M against the JAX package's.

* JAX parameters carried across with ``params_from_jax``: the truncated
  forward (through the first MBConv stage, so fused blocks, MBConv and
  squeeze-excitation are all covered) matches JAX ``features.apply`` to
  1e-4 of the activation scale on a masked batch of two sizes;
* batched masked output equals per-image output;
* a torchvision-layout checkpoint (``tests/torch_effnet_replica.py``, the
  route of ``tests/test_weight_parity.py``) loaded by the port gives the
  JAX ``convert`` route's features, and the replica's own.
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
from torch_effnet_replica import replica_v2m  # noqa: E402

BLOCK = 5  # stem + 3 fused stages + the first MBConv stage
TOL = 1e-4  # relative to the activation scale (float32 convs in another order)


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


@pytest.fixture(scope="module")
def jax_features_and_params():
    """The JAX tree's structure, filled with seeded numpy values (BN
    variances positive) — the same tree ``features.init`` returns."""
    features = jget("EfficientNetV2_M").build().truncate(BLOCK)
    shapes = jax.eval_shape(features.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "running_var" in name:
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)

    return features, jax.tree_util.tree_map_with_path(fill, shapes)


def test_params_from_jax_matches_jax_forward(jax_features_and_params):
    set_float32_precision()
    jf, params = jax_features_and_params
    tf = tget("EfficientNetV2_M").build(BLOCK)
    tw.load_into(tf, tw.params_from_jax(params))
    tf.eval()
    x, valid = _inputs(0)
    want, want_v = jax.jit(jf.apply)(params, jnp.asarray(x), jnp.asarray(valid))
    with torch.inference_mode():
        got, got_v = tf(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got.shape == want.shape
    _close(got.numpy(), np.asarray(want))

    # batched masked extraction == per-image extraction at native shape
    with torch.inference_mode():
        for i, (h, w) in enumerate(valid):
            one, one_v = tf(torch.from_numpy(x[i : i + 1, :, :h, :w].copy()),
                            torch.from_numpy(valid[i : i + 1]))
            vh, vw = one_v[0].tolist()
            np.testing.assert_allclose(got[i, :, :vh, :vw].numpy(), one[0].numpy(),
                                       rtol=1e-5, atol=1e-5)
            assert int(torch.count_nonzero(got[i, :, vh:, :])) == 0
            assert int(torch.count_nonzero(got[i, :, :, vw:])) == 0


def test_params_from_jax_key_set_is_torchvision_layout(jax_features_and_params):
    _, params = jax_features_and_params
    sd = tw.params_from_jax(params)
    own = {k for k in tget("EfficientNetV2_M").build(BLOCK).state_dict()
           if not k.endswith("num_batches_tracked")}
    assert set(sd) == own
    assert "features.4.0.block.2.fc1.weight" in sd  # MBConv SE
    assert "features.1.0.block.0.0.weight" in sd  # fused, expand 1


def test_checkpoint_load_matches_jax_convert_and_replica(tmp_path):
    set_float32_precision()
    model = replica_v2m(seed=0)
    model.features = model.features[:BLOCK]
    wdir = tmp_path / "weights"
    wdir.mkdir()
    np.savez(wdir / "EfficientNetV2_M.npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})

    tf = tw.build_model("EfficientNetV2_M", BLOCK, wdir, "cpu")
    jf = jget("EfficientNetV2_M").build().truncate(BLOCK)
    jparams = load_or_init_params(jf, "EfficientNetV2_M", wdir)
    x, valid = _inputs(1)
    want, _ = jax.jit(jf.apply)(jparams, jnp.asarray(x), jnp.asarray(valid))
    with torch.inference_mode():
        got, _ = tf(torch.from_numpy(x), torch.from_numpy(valid))
        replica = model.features(torch.from_numpy(x[:1]))
    _close(got.numpy(), np.asarray(want))
    _close(got[:1].numpy(), replica.numpy())

    sd = tw.load_state_dict(wdir / "EfficientNetV2_M.npz")
    sd.pop("features.3.0.block.1.0.weight")
    with pytest.raises(KeyError):
        tw.load_into(tget("EfficientNetV2_M").build(BLOCK), sd)


def test_other_backbones_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tget("VGG16")
    with pytest.raises(LookupError):
        tget("ResNet50")

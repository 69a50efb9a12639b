"""The port's ``scripts/summed_feature_maps`` against the JAX script's steps.

A seeded 160 x 144 uint8 query/print pair goes through full-width
EfficientNetV2_M truncated at block 6 (C = 176; maps 10 x 9, then 6 x 5
after the edge crop) in both packages, on the JAX package's seeded
parameters (``load_or_init_params`` without a checkpoint) carried across
with ``params_from_jax``. The JAX side runs ``scripts/summed_feature_maps.py``'s
``maps_of`` and per-channel ``normxcorr_same`` loop with ``jax.jit(features.apply)``.

* features within 1e-4 of the activation scale, the score within 1e-4 and
  the summed map's argmax identical;
* on JAX's features given to both, every per-channel map within 1e-5;
* the score equals the FFT scorer's identity-variant score within 1e-6 and
  the engine's direct scorer's (its plain version on the CPU) within 1e-5;
* an image whose maps the edge crop empties raises ``ValueError``;
* the CLI with ``--device cpu`` writes the figure, and without ``--device``
  it needs a card.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from shoeprint_image_retrieval_tpu.models.efficientnet import efficientnet_v2
from shoeprint_image_retrieval_tpu.models.registry import IMAGENET_MEAN, IMAGENET_STD
from shoeprint_image_retrieval_tpu.models.weights import load_or_init_params
from shoeprint_image_retrieval_tpu.ops.clahe import clahe_u8 as jclahe_u8
from shoeprint_image_retrieval_tpu.ops.ncc import normxcorr_same as jnormxcorr_same
from shoeprint_image_retrieval_tpu.ops.preprocess import normalize_batch as jnormalize_batch
from shoeprint_image_retrieval_torch.device import set_float32_precision
from shoeprint_image_retrieval_torch.models import weights as tw
from shoeprint_image_retrieval_torch.models.registry import get_backbone
from shoeprint_image_retrieval_torch.ops.boxsum import EDGE_CROP
from shoeprint_image_retrieval_torch.ops.ncc import build_gallery_cache, score_one_template
from shoeprint_image_retrieval_torch.scripts import summed_feature_maps as sfm

REPO = Path(__file__).resolve().parents[1]
FEATURE_TOL = 1e-4  # relative to the activation scale (float32 convs in another order)
SCORE_TOL = 1e-4    # the score on each package's own features
MAP_TOL = 1e-5      # per-channel maps on the same features (float32 FFTs in another library)
FFT_TOL = 1e-6      # the FFT scorer: the same FFTs, channels summed in blocks of 16
DIRECT_TOL = 1e-5   # the direct scorer: a spatial correlation instead of FFTs


def _pair(seed=3, hw=(160, 144)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=hw, dtype=np.uint8) for _ in range(2)]


def _jax_maps(apply, params, img):
    """The JAX script's ``maps_of`` (scripts/summed_feature_maps.py:46-57)
    with the jitted forward ``apply``, then its edge crop."""
    hw = jnp.asarray([[img.shape[0], img.shape[1]]], jnp.int32)
    x = jnormalize_batch(jclahe_u8(jnp.asarray(img))[None], hw, IMAGENET_MEAN, IMAGENET_STD)
    y, v = apply(params, x, hw)
    return np.asarray(y)[0, :, : int(v[0, 0]), : int(v[0, 1])][:, 2:-2, 2:-2]


def _jax_channel_maps(q, p):
    corr = np.stack([np.asarray(jnormxcorr_same(jnp.asarray(q[c]), jnp.asarray(p[c])))
                     for c in range(q.shape[0])])
    summed = np.sum(corr, axis=0)
    return corr, summed, float(summed.max() / q.shape[0])


@pytest.fixture(scope="module")
def both():
    """JAX's and the port's edge-cropped maps of the seeded pair on the
    same parameters, the JAX script's (corr, summed, score) and the port's
    features."""
    set_float32_precision()
    jf = efficientnet_v2("M").truncate(sfm.BLOCK)
    params = jax.tree_util.tree_map(np.asarray,
                                    load_or_init_params(jf, sfm.MODEL, weights_dir=None))
    tf = get_backbone(sfm.MODEL).build(sfm.BLOCK)
    tw.load_into(tf, tw.params_from_jax(params))
    tf.eval()
    imgs = _pair()
    apply = jax.jit(jf.apply)
    want = [_jax_maps(apply, params, img) for img in imgs]
    got = [sfm.feature_maps(img, tf, "cpu") for img in imgs]
    return want, got, _jax_channel_maps(*want), tf


def test_features_and_score_match_jax_script(both):
    want, got, (_, w_summed, w_score), _ = both
    for w, g in zip(want, got):
        assert g.shape == w.shape == (176, 6, 5)
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert 0 < scale and err <= FEATURE_TOL * scale, f"max abs err {err} (scale {scale})"
    corr, summed, score = sfm.channel_maps(*got)
    assert corr.shape == (176, 6, 5) and summed.shape == (6, 5)
    assert np.isfinite(corr.numpy()).all()
    assert abs(score - w_score) <= SCORE_TOL, (score, w_score)
    assert int(summed.argmax()) == int(np.argmax(w_summed))


def test_channel_maps_match_jax_per_channel(both):
    want, _, (w_corr, w_summed, w_score), _ = both
    corr, summed, score = sfm.channel_maps(*(torch.from_numpy(np.ascontiguousarray(m))
                                            for m in want))
    np.testing.assert_allclose(corr.numpy(), w_corr, atol=MAP_TOL, rtol=0)
    np.testing.assert_allclose(summed.numpy(), w_summed, atol=MAP_TOL * 176, rtol=0)
    assert abs(score - w_score) <= MAP_TOL


def test_score_is_the_identity_variant_score(both):
    _, (q, p), _, _ = both
    _, _, score = sfm.channel_maps(q, p)
    q_raw, p_raw = (torch.nn.functional.pad(m, (EDGE_CROP,) * 4) for m in (q, p))
    q_hw = torch.tensor([q_raw.shape[-2:]], dtype=torch.int32)
    p_hw = torch.tensor([p_raw.shape[-2:]], dtype=torch.int32)
    cache, _ = build_gallery_cache(p_raw[None], p_hw, tuple(q.shape[-2:]))
    fft = float(score_one_template(cache, q_raw, q_hw, true_channels=q.shape[0])[0])
    assert abs(score - fft) <= FFT_TOL, (score, fft)
    direct = sfm.engine_score(q, p)  # score_ncc on CPU tensors: score_direct
    assert abs(score - direct) <= DIRECT_TOL, (score, direct)


@pytest.mark.parametrize("hw", [(64, 144), (160, 48), (16, 16)])
def test_empty_maps_raise(both, hw):
    """Maps of 4 px or fewer in a dimension (stride 16: 64 px) are empty
    after the edge crop; the JAX script fails inside ``max`` there."""
    tf = both[-1]
    img = np.random.default_rng(0).integers(0, 256, size=hw, dtype=np.uint8)
    with pytest.raises(ValueError, match="query.png: its .* feature maps are empty"):
        sfm.feature_maps(img, tf, "cpu", "query.png")


def test_cli_writes_the_figure_on_the_cpu(tmp_path):
    names = []
    for name, img in zip(("q.png", "p.png"), _pair(seed=5, hw=(96, 112))):
        Image.fromarray(img).save(tmp_path / name)
        names.append(str(tmp_path / name))
    out = tmp_path / "maps.png"
    proc = subprocess.run(
        [sys.executable, "-m", "shoeprint_image_retrieval_torch.scripts.summed_feature_maps",
         *names, str(out), "--device", "cpu", "--weights-dir", str(tmp_path / "weights")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "seeded random init" in proc.stderr
    assert f"wrote {out}" in proc.stdout
    assert out.stat().st_size > 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sfm.main([str(tmp_path / "q.png"), str(tmp_path / "p.png"), str(tmp_path / "out.png")])
    assert not (tmp_path / "out.png").exists()

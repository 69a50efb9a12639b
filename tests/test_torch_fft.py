"""The port's FFT scoring backend against the JAX package's ``ops/ncc.py``.

Seeded numpy inputs go to both packages: the FFT sizes must be equal, the
single-pair ``normxcorr_same`` map and the batched ``build_gallery_cache`` +
``score_templates`` scores within 1e-5 (float32 FFTs in another library),
with no NaN. The batch covers C = 20 (not a multiple of the 16-channel
block), a template larger than a print, a flat print channel, a flat
template channel and variants that share a window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_tpu.ops import fft as jfft
from shoeprint_image_retrieval_tpu.ops import ncc as jncc
from shoeprint_image_retrieval_torch.ops import fft as tfft
from shoeprint_image_retrieval_torch.ops import ncc as tncc

TOL = 1e-5


def test_fft_sizes_equal_jax():
    assert [tfft.next_fast_fft_size(n) for n in range(1, 601)] == [
        jfft.next_fast_fft_size(n) for n in range(1, 601)]
    for hw, t in (((43, 39), (34, 34)), ((5, 7), (9, 3)), ((120, 96), (64, 80))):
        assert tfft.correlation_fft_shape(hw, t) == jfft.correlation_fft_shape(hw, t)


@pytest.mark.parametrize("t_hw,i_hw", [((7, 5), (23, 19)), ((12, 16), (12, 16)),
                                       ((20, 9), (11, 14))])
def test_normxcorr_same_matches_jax(t_hw, i_hw):
    rng = np.random.default_rng(sum(t_hw) + sum(i_hw))
    template = rng.normal(size=t_hw).astype(np.float32)
    image = rng.normal(size=i_hw).astype(np.float32)
    want = np.asarray(jncc.normxcorr_same(jnp.asarray(template), jnp.asarray(image)))
    got = tncc.normxcorr_same(torch.from_numpy(template), torch.from_numpy(image)).numpy()
    assert got.shape == want.shape == i_hw
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _batch(seed, c=20, g=5, canvas=(22, 19), t_canvas=(26, 24)):
    """Prints of several sizes (one with a flat channel, one smaller than
    the largest template) and variants (one larger than every print, one
    with a flat channel, two sharing a window)."""
    rng = np.random.default_rng(seed)
    prints = np.zeros((g, c, *canvas), np.float32)
    p_valid = np.zeros((g, 2), np.int32)
    for i in range(g):
        h, w = int(rng.integers(10, canvas[0] + 1)), int(rng.integers(9, canvas[1] + 1))
        prints[i, :, :h, :w] = rng.normal(size=(c, h, w))
        p_valid[i] = (h, w)
    prints[1, 3] = 0.0  # a flat (all-zero) print channel: zero energy everywhere
    sizes = [(9, 8), (13, 11), (13, 11), (26, 24), (17, 6), (7, 7)]
    templates = np.zeros((len(sizes), c, *t_canvas), np.float32)
    for i, (h, w) in enumerate(sizes):
        templates[i, :, :h, :w] = rng.normal(size=(c, h, w))
    templates[4, 5] = 0.0  # a flat (all-zero) template channel
    return prints, p_valid, templates, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("seed,batch_bytes", [(0, tncc.VARIANT_BATCH_BYTES), (1, 1)])
def test_gallery_cache_and_scores_match_jax(seed, batch_bytes):
    prints, p_valid, templates, t_valid = _batch(seed)
    c = prints.shape[1]
    kernel_hw = (templates.shape[2] - 4, templates.shape[3] - 4)
    jcache, jshape = jncc.build_gallery_cache(jnp.asarray(prints), jnp.asarray(p_valid), kernel_hw)
    tcache, tshape = tncc.build_gallery_cache(torch.from_numpy(prints), torch.from_numpy(p_valid),
                                              kernel_hw)
    assert tshape == jshape
    assert tcache.phat.shape == jcache.phat.shape and tcache.phat.shape[0] == 32  # 20 -> 32
    np.testing.assert_allclose(tcache.int2.numpy(), np.asarray(jcache.int2), atol=1e-4)
    np.testing.assert_array_equal(tcache.valid_hw.numpy(), np.asarray(jcache.valid_hw))
    jt = jnp.pad(jnp.asarray(templates), ((0, 0), (0, 32 - c), (0, 0), (0, 0)))
    want = np.asarray(jncc.score_templates(jcache, jt, jnp.asarray(t_valid), true_channels=c))
    # the port pads the stack's channels itself; valid sizes on the host
    got = tncc.score_templates(tcache, torch.from_numpy(templates), t_valid, true_channels=c,
                               batch_bytes=batch_bytes).numpy()
    assert got.shape == want.shape == (len(t_valid), len(prints))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    one = tncc.score_one_template(tcache, torch.from_numpy(templates[3]),
                                  torch.from_numpy(t_valid[3]), true_channels=c)
    np.testing.assert_allclose(one.numpy(), want[3], atol=TOL, rtol=0)

"""The port's NCC scorer (plain version of the CUDA kernel) against the JAX
package, on identical numpy inputs.

* the port's cache, template folding and plain scorer vs JAX
  ``ops/ncc_direct`` (<= 1e-5 abs on scores; folding is pure data movement
  after the same float32 arithmetic, so it is held to 1e-6);
* the plain scorer vs the Pallas kernel in interpret mode at one tiny shape;
* edge cases: zero template channel, flat print, zero-energy windows, a
  template canvas larger than the prints, the adversarial negative pair and
  ``regroup_max``'s 0.0 floor.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_tpu.ops import ncc_direct as jnd
from shoeprint_image_retrieval_tpu.ops.pallas.ncc_kernel import score_direct_pallas
from shoeprint_image_retrieval_torch.ops import ncc_direct as tnd
from shoeprint_image_retrieval_torch.ops.boxsum import box_sum_same, integral_image
from shoeprint_image_retrieval_torch.ops.ncc_kernel import kernel_operands, score_ncc
from shoeprint_image_retrieval_torch.retrieval.engine import regroup_max

SCORE_TOL = 1e-5  # float32 sums over C channels x hk*wk taps in another order


def _pad_stack(maps, canvas_hw):
    c = maps[0].shape[0]
    arr = np.zeros((len(maps), c, *canvas_hw), np.float32)
    valid = np.zeros((len(maps), 2), np.int32)
    for i, m in enumerate(maps):
        arr[i, :, : m.shape[1], : m.shape[2]] = m
        valid[i] = m.shape[1:]
    return arr, valid


def _caches(gal, gv):
    jc = _jax_cache(jnp.asarray(gal), jnp.asarray(gv))
    tc = tnd.build_direct_cache(torch.from_numpy(gal), torch.from_numpy(gv))
    return jc, tc


def _fold_both(tm, tv, kernel_hw):
    want = np.stack([
        np.asarray(_jax_fold(jnp.asarray(t), jnp.asarray(v), kernel_hw, "roll"))
        for t, v in zip(tm, tv)
    ])
    got = tnd.fold_template(torch.from_numpy(tm), torch.from_numpy(tv), kernel_hw).numpy()
    return want, got


# one channel per scan step keeps the JAX compile small (the result does not
# depend on the step size beyond float32 summation order)
_jax_score_direct = jax.jit(
    functools.partial(jnd.score_direct, channel_block=1),
    static_argnames=("true_channels", "layout"),
)
_jax_cache = jax.jit(jnd.build_direct_cache)
_jax_fold = jax.jit(jnd.fold_template, static_argnums=(2, 3))


def _score_both(jc, tc, kernels, windows, layout_counts, pb, c):
    jl = jnd.VariantLayout(layout_counts, pb)
    tl = tnd.VariantLayout(layout_counts, pb)
    want = np.asarray(_jax_score_direct(
        jc, jnd.PackedVariants(jnp.asarray(kernels), jnp.asarray(windows)),
        true_channels=c, layout=jl,
    ))
    packed = tnd.PackedVariants(torch.from_numpy(kernels), torch.from_numpy(windows))
    got = tnd.score_direct(tc, packed, tl, c).numpy()
    return want, got, packed, tl


def _random_case(seed, c=5, n_prints=4, pb=2, counts=(1, 3), canvas=(20, 20), kernel_hw=(12, 12)):
    rng = np.random.default_rng(seed)
    prints = [rng.normal(size=(c, int(rng.integers(14, 21)), int(rng.integers(14, 21))))
              .astype(np.float32) for _ in range(n_prints)]
    gal, gv = _pad_stack(prints, canvas)
    # one template per (class, probe, variant), class-major, probe-major
    marks, windows = [], []
    for ci, cnt in enumerate(counts):
        for p in range(pb):
            h = int(rng.integers(6, kernel_hw[0] + 5))
            w = int(rng.integers(6, kernel_hw[1] + 5))
            windows.append((h - 4, w - 4))
            for _ in range(cnt):
                marks.append(rng.normal(size=(c, h, w)).astype(np.float32))
    tm, tv = _pad_stack(marks, (kernel_hw[0] + 4, kernel_hw[1] + 4))
    return gal, gv, tm, tv, np.asarray(windows, np.int32)


def test_integral_and_box_sums_match_jax():
    from shoeprint_image_retrieval_tpu.ops import boxsum as jbs

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 11, 9)).astype(np.float32)
    ji = np.asarray(jbs.integral_image(jnp.asarray(x)))
    ti = integral_image(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ti, ji, atol=1e-5)
    for h, w in [(1, 1), (4, 3), (11, 9), (15, 20)]:
        want = np.asarray(jbs.box_sum_same(jnp.asarray(ji), h, w))
        got = box_sum_same(torch.from_numpy(np.array(ji)), h, w).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_cache_and_fold_match_jax(seed):
    gal, gv, tm, tv, _ = _random_case(seed)
    jc, tc = _caches(gal, gv)
    # integral images sum up to ~400 demeaned values, so their float32
    # rounding in another summation order reaches ~1e-5 absolute
    for name, tol in (("p0", 1e-5), ("int1", 1e-4), ("int2", 1e-4), ("valid_hw", 0)):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   atol=tol, err_msg=name)
    want, got = _fold_both(tm, tv, (12, 12))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_inv_window_energy_matches_jax():
    """Same integral images in, same energy out: the energy's cancellation
    (b2 - b1^2/n) would amplify the integrals' own rounding differences, so
    both sides read the JAX cache's integrals."""
    gal, gv, *_ = _random_case(3)
    jc, _ = _caches(gal, gv)
    windows = np.asarray([[5, 7], [10, 10], [1, 1], [20, 3]], np.int32)
    got = tnd.inv_window_energy(torch.from_numpy(np.array(jc.int1)),
                                torch.from_numpy(np.array(jc.int2)),
                                torch.from_numpy(windows)).numpy()
    for u, (h, w) in enumerate(windows):
        want = np.asarray(jnd.inv_window_energy(jc, jnp.int32(h), jnp.int32(w)))
        np.testing.assert_allclose(got[u], want, rtol=1e-6, atol=1e-6)


# every case has N = 8 variant rows, so the jitted JAX scorer compiles once
@pytest.mark.parametrize("seed,counts,pb", [(0, (1, 3), 2), (1, (2,), 4), (2, (1, 2, 1), 2)])
def test_plain_scorer_matches_jax_score_direct(seed, counts, pb):
    gal, gv, tm, tv, windows = _random_case(seed, counts=counts, pb=pb)
    jc, tc = _caches(gal, gv)
    kernels, _ = _fold_both(tm, tv, (12, 12))
    want, got, packed, layout = _score_both(jc, tc, kernels, windows, counts, pb, 5)
    assert got.shape == want.shape == (len(kernels), len(gal))
    np.testing.assert_allclose(got, want, atol=SCORE_TOL)
    # CPU tensors: the wrapper is the plain version
    np.testing.assert_array_equal(score_ncc(tc, packed, layout, 5).numpy(), got)


def test_window_dedup_gives_the_same_scores():
    gal, gv, tm, tv, windows = _random_case(4, counts=(1, 3), pb=2)
    windows[1] = windows[0]  # two groups share a window size
    _, tc = _caches(gal, gv)
    kernels, _ = _fold_both(tm, tv, (12, 12))
    packed = tnd.PackedVariants(torch.from_numpy(kernels), torch.from_numpy(windows))
    layout = tnd.VariantLayout((1, 3), 2)
    uniq, inv = np.unique(windows, axis=0, return_inverse=True)
    plain = tnd.score_direct(tc, packed, layout, 5).numpy()
    dedup = tnd.score_direct(tc, packed, layout, 5, torch.from_numpy(uniq.astype(np.int32)),
                             torch.from_numpy(inv.reshape(-1))).numpy()
    np.testing.assert_array_equal(dedup, plain)
    _, row_hw = kernel_operands(tc, packed, layout, torch.from_numpy(uniq.astype(np.int32)),
                                torch.from_numpy(inv.reshape(-1)))
    want_rows = windows[layout.row_groups()]
    np.testing.assert_array_equal(row_hw.numpy(), want_rows)


def test_plain_scorer_matches_pallas_interpret():
    """One tiny shape through the Pallas kernel run as the JAX package's own
    tests run it on the CPU (interpret mode)."""
    gal, gv, tm, tv, windows = _random_case(5, c=3, n_prints=3, pb=1, counts=(2, 1),
                                            canvas=(20, 20), kernel_hw=(8, 8))
    jc, tc = _caches(gal, gv)
    kernels, _ = _fold_both(tm, tv, (8, 8))
    jl = jnd.VariantLayout((2, 1), 1)
    want = np.asarray(score_direct_pallas(
        jc, jnd.PackedVariants(jnp.asarray(kernels), jnp.asarray(windows)),
        true_channels=3, layout=jl, interpret=True,
    ))
    packed = tnd.PackedVariants(torch.from_numpy(kernels), torch.from_numpy(windows))
    got = tnd.score_direct(tc, packed, tnd.VariantLayout((2, 1), 1), 3).numpy()
    np.testing.assert_allclose(got, want[:, : len(gal)], atol=SCORE_TOL)


def test_zero_template_and_flat_print_score_zero():
    rng = np.random.default_rng(1)
    c = 2
    prints = [rng.normal(size=(c, 16, 16)).astype(np.float32),
              np.zeros((c, 16, 16), np.float32)]  # flat: zero energy everywhere
    gal, gv = _pad_stack(prints, (16, 16))
    jc, tc = _caches(gal, gv)
    marks = [np.zeros((c, 9, 9), np.float32),  # zero template
             rng.normal(size=(c, 9, 9)).astype(np.float32)]
    marks[1][0] = 0.0  # one zero template channel
    tm, tv = _pad_stack(marks, (9, 9))
    kernels, got_fold = _fold_both(tm, tv, (5, 5))
    np.testing.assert_allclose(got_fold, kernels, atol=1e-6)
    windows = np.asarray([[5, 5], [5, 5]], np.int32)
    want, got, *_ = _score_both(jc, tc, kernels, windows, (1,), 2, c)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SCORE_TOL)
    assert np.all(got[0] == 0.0)  # zero template
    assert np.all(got[:, 1] == 0.0)  # flat print


def test_zero_energy_windows_give_zero_not_nan():
    """A print that is flat over part of its extent: windows inside the flat
    part have zero energy and must contribute 0, not NaN."""
    rng = np.random.default_rng(2)
    c = 3
    p = np.zeros((c, 18, 18), np.float32)
    p[:, 10:, :] = rng.normal(size=(c, 8, 18))
    gal, gv = _pad_stack([p], (18, 18))
    jc, tc = _caches(gal, gv)
    e = tnd.inv_window_energy(tc.int1, tc.int2, torch.tensor([[3, 3]], dtype=torch.int32))
    assert torch.isfinite(e).all()
    marks = [rng.normal(size=(c, 7, 7)).astype(np.float32)]
    tm, tv = _pad_stack(marks, (9, 9))
    kernels, _ = _fold_both(tm, tv, (5, 5))
    want, got, *_ = _score_both(jc, tc, kernels, np.asarray([[3, 3]], np.int32), (1,), 1, c)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SCORE_TOL)


def test_template_larger_than_print():
    rng = np.random.default_rng(6)
    c = 2
    prints = [rng.normal(size=(c, 10, 9)).astype(np.float32),
              rng.normal(size=(c, 8, 12)).astype(np.float32)]
    gal, gv = _pad_stack(prints, (12, 12))
    jc, tc = _caches(gal, gv)
    marks = [rng.normal(size=(c, 18, 17)).astype(np.float32)]
    tm, tv = _pad_stack(marks, (20, 20))
    kernels, _ = _fold_both(tm, tv, (16, 16))
    want, got, *_ = _score_both(jc, tc, kernels, np.asarray([[14, 13]], np.int32), (1,), 1, c)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL)


def test_regroup_max_floors_at_zero():
    layout = tnd.VariantLayout((1, 2), 2)
    # rows: class 0 (p0, p1), class 1 (p0 v0, p0 v1, p1 v0, p1 v1)
    scores = torch.tensor([[-0.3, 0.2], [-0.1, -0.4],
                           [-0.2, 0.5], [-0.05, 0.1],
                           [-0.6, -0.2], [-0.7, -0.9]])
    got = regroup_max(scores, layout).numpy()
    np.testing.assert_array_equal(got, np.asarray([[0.0, 0.5], [0.0, 0.0]], np.float32))


def test_negative_pair_scores_exactly_zero(tmp_path):
    """The adversarial pair of ``tests/data/negative_score_pair.npz`` through
    the port's cluster scorer: floored entries are exactly 0.0, and the
    scores match the JAX direct path."""
    from PIL import Image

    from shoeprint_image_retrieval_tpu.config import load_config as jload
    from shoeprint_image_retrieval_tpu.retrieval.engine import Pipeline as JPipeline
    from shoeprint_image_retrieval_torch.config import load_config as tload
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline as TPipeline

    z = np.load(Path(__file__).parent / "data" / "negative_score_pair.npz")
    root = tmp_path / "ds"
    (root / "Gallery").mkdir(parents=True)
    (root / "Query").mkdir()
    img = np.full((24, 24), 128, np.uint8)
    Image.fromarray(img).save(root / "Gallery" / "1_1.png")
    Image.fromarray(img).save(root / "Query" / "1_q0.png")
    cfg = tmp_path / "run.toml"
    cfg.write_text(f"""
[dataset]
dir = "{root}"
type = "Impress"
crop = [0.0, 0.0]
n_processes = 1
n_clusters = 1
cluster_minimise_tolerance = 0.05
[model]
type = "EfficientNetV2_M"
clahe_clip_limit = 2.0
clahe_tile_grid_size = [4, 4]
start_block = 3
end_block = 2
skip_blocks = []
minimum_dim = 8
maximum_dim = 200
[comparison]
n_processes = 1
rotations = {z["rotations"].tolist()}
scales = {z["scales"].tolist()}
[tpu]
mesh_shape = 1
ncc_backend = "direct"
""")
    mark = z["mark"]
    prints = np.stack([z["pos_print"], z["neg_print"], z["mild_print"]])
    hw = np.asarray([mark.shape[1:]], np.int32)
    g_valid = hw.repeat(len(prints), axis=0)

    tp = TPipeline(tload(cfg), weights_dir=None, verbose=False, device="cpu")
    got = tp._score_cluster(torch.from_numpy(mark[None]), hw, torch.from_numpy(prints), g_valid)
    jp = JPipeline(jload(cfg), weights_dir=None, verbose=False)
    want = jp._score_cluster(mark[None], hw, prints, g_valid)
    assert got[0, 0] > 0.5
    assert got[0, 1] == 0.0 and got[0, 2] == 0.0
    np.testing.assert_allclose(got, want, atol=SCORE_TOL)

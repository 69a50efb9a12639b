"""The port's variant stacks against the JAX engine's, in both variant modes.

Same feature maps and valid sizes in; the per-cluster variant plans must be
equal, the rotation gathers bit-exact, and the folded class-major stacks
equal to 1e-6 for unscaled rows (the fold's float32 mean and energy sums
run in another order) and 1e-5 for scaled rows (two resample products on
top).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from shoeprint_image_retrieval_tpu.config import load_config as jload
from shoeprint_image_retrieval_tpu.ops import warp as jwarp
from shoeprint_image_retrieval_tpu.retrieval.engine import Pipeline as JPipeline
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.retrieval import engine as teng

RUN_TOML = """
[dataset]
dir = "{dir}"
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
rotations = [-9, 3, 180]
scales = [1.04, 1.08]
[tpu]
variant_mode = "{mode}"
mesh_shape = 1
ncc_backend = "direct"
"""


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants_ds")
    (root / "Gallery").mkdir()
    (root / "Query").mkdir()
    img = np.full((24, 24), 128, np.uint8)
    Image.fromarray(img).save(root / "Gallery" / "1_1.png")
    Image.fromarray(img).save(root / "Query" / "1_q0.png")
    return root


@pytest.mark.parametrize("mode", ["reference", "full"])
def test_variant_stack_matches_jax_engine(dataset, tmp_path, mode):
    cfg = tmp_path / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=dataset, mode=mode))
    jp = JPipeline(jload(cfg), weights_dir=None, verbose=False)
    tp = teng.Pipeline(tload(cfg), weights_dir=None, verbose=False, device="cpu")

    rng = np.random.default_rng(0)
    c, hc, wc = 3, 15, 14
    q_valid = np.asarray([[15, 14], [11, 13], [9, 9]], np.int32)
    maps = np.zeros((len(q_valid), c, hc, wc), np.float32)
    for i, (h, w) in enumerate(q_valid):
        maps[i, :, :h, :w] = rng.normal(size=(c, h, w))

    jplan = jp._variant_plan_impl(q_valid, (hc, wc))
    tplan = tp._variant_plan(q_valid, (hc, wc))
    for name, a, b in zip(("rot_idx", "rot_ok", "wv", "wh", "scale_hw"), jplan[:5],
                          (tplan.rot_idx, tplan.rot_ok, tplan.wv, tplan.wh, tplan.scale_hw)):
        np.testing.assert_array_equal(b, a, err_msg=name)
    tc = tplan.template_canvas
    assert tc == jplan[5]
    kernel_hw = (tc[0] - 4, tc[1] - 4)
    include, counts = teng.variant_classes(mode, tplan.n_rot, tplan.n_scl)
    pb = len(q_valid)

    fns = jp._scorer_bundle(
        true_c=c, hc=hc, wc=wc, kernel_hw=kernel_hw, class_counts=counts, pb=pb,
        n_rot=tplan.n_rot, n_scl=tplan.n_scl, include_rots_unscaled=include,
        use_pallas=False, dtype=jnp.float32, interpret=False,
    )
    args = (maps, q_valid, *jplan[:5])
    want = np.asarray(jax.jit(fns.build_kernels)(*[jnp.asarray(a) for a in args]))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    got = teng.build_kernels(*targs, kernel_hw=kernel_hw, include_rots_unscaled=include,
                             n_scl=tplan.n_scl).numpy()
    assert got.shape == want.shape == (pb * sum(counts), c, *kernel_hw)
    n0 = pb * counts[0]
    np.testing.assert_allclose(got[:n0], want[:n0], atol=1e-6)
    np.testing.assert_allclose(got[n0:], want[n0:], atol=1e-5)

    # the rotation gather alone is bit-exact
    rot = teng.rotate_maps(targs[0], targs[2], targs[3]).numpy()
    for p in range(pb):
        for r in range(1 + tplan.n_rot):
            want_r = np.asarray(jwarp.apply_index_map(
                jnp.asarray(maps[p]), jnp.asarray(tplan.rot_idx[p, r].reshape(hc, wc)),
                jnp.asarray(tplan.rot_ok[p, r])))
            np.testing.assert_array_equal(rot[p, r], want_r)


def test_window_dedup_matches_jax_engine_rule():
    """Class-major group windows and their distinct set, as the JAX engine
    builds them per probe batch."""
    q_valid = np.asarray([[20, 18], [15, 16], [20, 18]], np.int32)
    scale_hw = np.asarray([[[20, 18], [21, 19]], [[15, 16], [16, 17]], [[20, 18], [21, 19]]],
                          np.int32)
    wins, uniq, inv = teng.batch_windows(q_valid, scale_hw, 2)
    assert wins.shape == (9, 2)
    np.testing.assert_array_equal(wins[:3], q_valid - 4)
    np.testing.assert_array_equal(wins[3:6], scale_hw[:, 0] - 4)
    np.testing.assert_array_equal(uniq[inv], wins)
    assert len(uniq) == 4

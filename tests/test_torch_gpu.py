"""The CUDA kernel on the card: held against its plain PyTorch version.

Needs an NVIDIA GPU and ``nvcc``; every test skips without a CUDA device.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch
from PIL import Image

from shoeprint_image_retrieval_torch.ops import ncc_kernel
from shoeprint_image_retrieval_torch.ops.ncc_direct import (
    PackedVariants,
    VariantLayout,
    build_direct_cache,
    fold_template,
    score_direct,
)

pytestmark = pytest.mark.gpu

TOL = 1e-4  # float32 channel and tap sums in another order than cuDNN's


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _case(seed, c, n_prints, counts, pb, canvas, kernel_hw):
    rng = np.random.default_rng(seed)
    gal = np.zeros((n_prints, c, *canvas), np.float32)
    gv = np.zeros((n_prints, 2), np.int32)
    for i in range(n_prints):
        h, w = int(rng.integers(canvas[0] // 2, canvas[0] + 1)), int(rng.integers(canvas[1] // 2, canvas[1] + 1))
        gal[i, :, :h, :w] = rng.normal(size=(c, h, w))
        gv[i] = (h, w)
    n = pb * sum(counts)
    tm = np.zeros((n, c, kernel_hw[0] + 4, kernel_hw[1] + 4), np.float32)
    tv = np.zeros((n, 2), np.int32)
    windows, row = [], 0
    for cnt in counts:
        for _ in range(pb):
            h, w = int(rng.integers(6, kernel_hw[0] + 5)), int(rng.integers(6, kernel_hw[1] + 5))
            windows.append((h - 4, w - 4))
            for _ in range(cnt):
                tm[row, :, :h, :w] = rng.normal(size=(c, h, w))
                tv[row] = (h, w)
                row += 1
    dev = torch.device("cuda")
    cache = build_direct_cache(torch.from_numpy(gal).to(dev), torch.from_numpy(gv).to(dev))
    kernels = fold_template(torch.from_numpy(tm).to(dev), torch.from_numpy(tv).to(dev), kernel_hw)
    packed = PackedVariants(kernels, torch.tensor(windows, dtype=torch.int32, device=dev))
    return cache, packed, VariantLayout(tuple(counts), pb)


@pytest.mark.parametrize(
    "seed,c,n_prints,counts,pb,canvas,kernel_hw",
    [
        (0, 5, 7, (1, 3), 3, (24, 22), (12, 12)),      # channel padding 5 -> 8
        (1, 16, 5, (1, 8, 8), 2, (46, 46), (34, 34)),  # main-path canvas
        (2, 8, 4, (2,), 9, (12, 10), (20, 18)),        # templates larger than prints
        (3, 8, 3, (1,), 5, (90, 70), (47, 39)),        # wide prints: other launch geometry
    ],
)
def test_kernel_matches_plain(seed, c, n_prints, counts, pb, canvas, kernel_hw):
    _need_card()
    cache, packed, layout = _case(seed, c, n_prints, counts, pb, canvas, kernel_hw)
    before = ncc_kernel.launch_ncc.launches
    got = ncc_kernel.score_ncc(cache, packed, layout, c)
    torch.cuda.synchronize()
    assert ncc_kernel.launch_ncc.launches == before + 1
    want = score_direct(cache, packed, layout, c)
    assert got.shape == want.shape == (layout.n_variants, cache.p0.shape[1])
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


def test_kernel_rejects_bad_operands():
    _need_card()
    cache, packed, layout = _case(0, 5, 3, (1,), 2, (16, 16), (8, 8))
    kern, row_hw = ncc_kernel.kernel_operands(cache, packed, layout)
    args = [cache.p0, cache.int1, cache.int2, kern, row_hw, cache.valid_hw.contiguous(), 5]
    with pytest.raises(TypeError):
        ncc_kernel.launch_ncc(*args[:3], kern.double(), *args[4:])
    with pytest.raises(ValueError):
        ncc_kernel.launch_ncc(*args[:3], kern.transpose(2, 3), *args[4:])
    with pytest.raises(ValueError):
        ncc_kernel.launch_ncc(cache.p0.cpu(), *args[1:])


def test_pipeline_kernel_ranks_equal_plain(tmp_path):
    """A tiny Impress-layout dataset through the port on the card, once
    through the kernel and once through the plain scorer."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    rng = np.random.default_rng(11)
    root = tmp_path / "data"
    (root / "Gallery").mkdir(parents=True)
    (root / "Query").mkdir()
    prints = {}
    for gi in range(8):
        img = rng.integers(30, 220, size=(int(rng.integers(70, 90)), int(rng.integers(60, 80))),
                           dtype=np.uint8)
        Image.fromarray(img).save(root / "Gallery" / f"{gi + 1}_1.png")
        prints[gi + 1] = img
    for qi in range(4):
        gid = int(rng.integers(1, 9))
        crop = np.clip(prints[gid][5:55, 5:50].astype(int) + rng.integers(-15, 16, (50, 45)), 0, 255)
        Image.fromarray(crop.astype(np.uint8)).save(root / "Query" / f"{gid}_q{qi}.png")
    cfg_path = tmp_path / "run.toml"
    cfg_path.write_text(f"""
[dataset]
dir = "{root}"
type = "Impress"
crop = [0.05, 0.05]
n_processes = 2
n_clusters = 1
cluster_minimise_tolerance = 0.05
[model]
type = "EfficientNetV2_M"
clahe_clip_limit = 2.0
clahe_tile_grid_size = [8, 8]
start_block = 4
end_block = 3
skip_blocks = []
minimum_dim = 8
maximum_dim = 200
[comparison]
n_processes = 2
rotations = [9, 180]
scales = [1.04]
[tpu]
probe_batch = 3
""")
    outs = {}
    for backend in ("auto", "direct"):
        cfg = load_config(cfg_path)
        cfg["tpu"]["ncc_backend"] = backend
        before = ncc_kernel.launch_ncc.launches
        outs[backend] = list(Pipeline(cfg, weights_dir=None, verbose=False, device="cuda").run())
        launched = ncc_kernel.launch_ncc.launches - before
        assert (launched > 0) == (backend == "auto")
    for k, p in zip(outs["auto"], outs["direct"]):
        np.testing.assert_array_equal(k.ranks, p.ranks)
        np.testing.assert_allclose(k.scores, p.scores, atol=TOL)

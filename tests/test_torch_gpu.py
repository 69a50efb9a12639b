"""The CUDA kernels on the card: each held against its plain PyTorch version.

Needs an NVIDIA GPU and ``nvcc``; every test skips without a CUDA device.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch
from PIL import Image

from shoeprint_image_retrieval_torch.benchmarks import cases, kernel_probe
from shoeprint_image_retrieval_torch.ops import mma_probe as mp
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
# the kernel against the plain scorer in float64: 3xTF32 keeps a product to
# ~2^-22 and sums each 32-tap chunk afresh. The plain scorer in float32 is
# itself more than 1e-4 from float64 on some of the ring's edge cases, so
# those are held against float64
F64_TOL = 1e-5
# probe kernel vs plain, relative to max |plain|: f32 and bf16 sums in another
# order (bf16 products are exact in f32); 3xTF32 also drops the lo*lo term
PROBE_TOL = {"f32": 1e-5, "f32_3xtf32": 1e-4, "bf16": 1e-5}
# the NCC kernel's bf16 leg vs plain bf16: f32 sums of exact products in
# another order; the bf16 rounding moves scores further than this
BF16_TOL = 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _case(seed, c, n_prints, counts, pb, canvas, kernel_hw, print_hw=()):
    """Seeded prints and templates on the card; ``print_hw`` fixes the raw
    sizes of the first prints (the rest are drawn)."""
    rng = np.random.default_rng(seed)
    gal = np.zeros((n_prints, c, *canvas), np.float32)
    gv = np.zeros((n_prints, 2), np.int32)
    for i in range(n_prints):
        h, w = int(rng.integers(canvas[0] // 2, canvas[0] + 1)), int(rng.integers(canvas[1] // 2, canvas[1] + 1))
        if i < len(print_hw):
            h, w = print_hw[i]
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
        (4, 8, 6, (1, 8, 8, 8), 15, (46, 46), (34, 34)),  # N = 375: a partial last tile
        (5, 8, 6, (1,), 128, (36, 36), (32, 32)),       # N = 128, one variant, 32 x 32 canvas
        (6, 8, 5, (1, 3), 4, (51, 43), (47, 39)),       # the fixture's odd 47 x 39 canvas
        (7, 4, 4, (1, 2), 3, (14, 12), (30, 26)),       # windows far larger than the prints
        # fusion's stride-8 block of a stride-16 cluster: a 73 x 73 canvas
        # over 88-wide prints, whose split patch does not fit (the float patch)
        (8, 8, 3, (1, 8), 3, (92, 92), (73, 73)),
        # the families' stride-8 call at full width: C = 80, a 47 x 39 canvas
        # over 84 x 68 maps, two row tiles (the float patch in two buffers)
        (9, 80, 12, (1, 8, 8, 8), 3, (88, 72), (47, 39)),
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
    # the plan made on the host from host data, as the engine makes it
    plan = _host_plan(cache, packed, layout)
    again = ncc_kernel.score_ncc(cache, packed, layout, c, plan=plan)
    assert torch.equal(again, got)
    geo = ncc_kernel.launch_geometry(cache.p0.shape[3], *kernel_hw, *plan)
    # the layout rule: two patch buffers before one, in either layout; the
    # split patch before the float patch at the same count
    fits = {}
    for patch in ("split", "float"):
        try:
            fits[patch] = ncc_kernel.launch_geometry(cache.p0.shape[3], *kernel_hw, *plan, patch)
        except RuntimeError:
            fits[patch] = None
    first = max((g for g in fits.values() if g),
                key=lambda g: (g["patch_buffers"], g["patch"] == "split"))
    assert (geo["patch"], geo["patch_buffers"]) == (first["patch"], first["patch_buffers"])
    if kernel_hw == (34, 34):  # the main path's canvas: the split patch, twice
        assert (geo["patch"], geo["patch_buffers"]) == ("split", 2)
    if (c, kernel_hw) == (80, (47, 39)):  # the split pairs fit once here: the float patch, twice
        assert (geo["patch"], geo["patch_buffers"]) == ("float", 2)
        assert fits["split"]["patch_buffers"] == 1
    # either layout gives the same products and sums (the float patch splits
    # where it reads); a layout that does not fit is refused
    for patch, fit in fits.items():
        if fit:
            assert torch.equal(ncc_kernel.score_ncc(cache, packed, layout, c, plan=plan,
                                                    patch=patch), got)
        else:
            with pytest.raises(RuntimeError, match=f"{patch} patch"):
                ncc_kernel.score_ncc(cache, packed, layout, c, plan=plan, patch=patch)
    if kernel_hw == (73, 73):  # fusion's canvas: only the float patch fits
        assert fits["split"] is None


_FIXTURE = cases.CASES["fixture_c0"]
# the fixture's stride-8 call with narrower prints: a taller patch, whose
# split pairs fit once
_NARROW = _FIXTURE._replace(print_w=(45, 52))
# the main path's canvases: a 34 x 34 kernel canvas over 42 x 42 maps
_MAIN = cases.Case(16, 6, (38, 46), (38, 46), (46, 46), ((34, 30), (28, 33), (36, 36)),
                          (36, 36))
# fusion's: a 73 x 73 kernel canvas over 88 x 88 maps
_FUSION = cases.Case(8, 6, (76, 92), (76, 92), (92, 92), ((70, 64), (60, 72), (72, 58)),
                            (72, 72))
# each launch geometry of the 3xTF32 leg, reached through `patch`: (case,
# C, patch, (layout, patch buffers))
GEOMETRIES = [
    (_NARROW, 80, "auto", ("float", 2)),
    (_NARROW, 80, "split", ("split", 1)),
    (_FIXTURE, 80, "auto", ("split", 2)),  # 6 prints, few windows: the pairs fit twice
    (_FIXTURE, 80, "float", ("float", 2)),
    (_MAIN, 16, "auto", ("split", 2)),
    (_FUSION, 8, "auto", ("float", 1)),
]


@pytest.mark.parametrize("case,c,patch,want", GEOMETRIES,
                         ids=["narrow-auto", "narrow-split", "fixture-auto", "fixture-float",
                              "main-auto", "fusion-auto"])
def test_kernel_geometries_match_plain(case, c, patch, want):
    """Every launch geometry the layout rule can pick, on seeded calls with
    true matches (``kernel_probe.case_inputs`` at its quick size: 6 prints,
    75 rows in two tiles): within TOL of the plain scorer, true-match ranks
    identical, and the same sums as the kernel's own choice."""
    _need_card()
    dev = torch.device("cuda")
    inputs = kernel_probe.case_inputs(case, dev, quick=True, channels=c)
    cache, packed, layout, slots = (inputs[k] for k in ("cache", "packed", "layout", "slots"))
    tile = ncc_kernel.kernel_tile()
    plan = (ncc_kernel.row_plan(inputs["row_hw"], inputs["kernel_hw"], tile.rows, dev),
            ncc_kernel.print_plan(cache.valid_hw.cpu().numpy(), tile.positions))
    assert len(plan[0].taps) == 2
    geo = ncc_kernel.launch_geometry(cache.p0.shape[3], *inputs["kernel_hw"], *plan, patch)
    assert (geo["patch"], geo["patch_buffers"]) == want
    before = ncc_kernel.launch_ncc.launches
    got = ncc_kernel.score_ncc(cache, packed, layout, c, *slots, plan=plan, patch=patch)
    torch.cuda.synchronize()
    assert ncc_kernel.launch_ncc.launches == before + 1
    plain = score_direct(cache, packed, layout, c, *slots)
    assert torch.isfinite(got).all()
    assert float((got - plain).abs().max()) <= TOL
    truth = inputs["row_truth"][:, None]
    ranks = [np.argmax(np.argsort(-s.cpu().numpy(), axis=1, kind="stable") == truth, axis=1)
             for s in (got, plain)]
    np.testing.assert_array_equal(ranks[0], ranks[1])
    assert torch.equal(ncc_kernel.score_ncc(cache, packed, layout, c, *slots, plan=plan), got)


# the producer/consumer ring's edge cases: (seed, c, n_prints, counts, pb,
# canvas, kernel_hw, print_hw)
RING_EDGES = [
    # C = 1 and a one-chunk rectangle (a 4 x 4 canvas): fewer chunks than
    # the ring has stages, a channel's next patch staged as it starts
    (20, 1, 4, (1, 3), 3, (16, 16), (4, 4), ()),
    # a 1 x 1 print beside others: its block's clipped rectangle is the
    # centre tap alone (K = 1; the centre tap lies in every tile's
    # rectangle, so no block clips to K = 0)
    (21, 8, 4, (1, 8), 2, (40, 40), (34, 34), ((5, 5),)),
    # N = 65: the last tile holds one row, 63 rows past N
    (22, 4, 3, (1,), 65, (30, 30), (20, 20), ()),
    # a print of 5 x 7 = 35 positions, fewer than one consumer fragment
    # (64): the second consumer warpgroup reads clamped positions only
    (23, 8, 4, (1, 3), 3, (40, 40), (30, 30), ((9, 11),)),
    # fusion's 73 x 73 canvas over 88-wide prints (the float patch) at C = 1
    (24, 1, 3, (1, 8), 2, (92, 92), (73, 73), ()),
]


@pytest.mark.parametrize("seed,c,n_prints,counts,pb,canvas,kernel_hw,print_hw", RING_EDGES)
def test_ring_edge_cases_match_plain(seed, c, n_prints, counts, pb, canvas, kernel_hw, print_hw):
    """The 3xTF32 leg at the ring's edges, through the kernel: every score
    finite and within F64_TOL of the plain scorer in float64."""
    _need_card()
    cache, packed, layout = _case(seed, c, n_prints, counts, pb, canvas, kernel_hw, print_hw)
    before = ncc_kernel.launch_ncc.launches
    got = ncc_kernel.score_ncc(cache, packed, layout, c)
    torch.cuda.synchronize()
    assert ncc_kernel.launch_ncc.launches == before + 1
    exact = score_direct(type(cache)(*(t.double() for t in cache[:3]), cache.valid_hw),
                         PackedVariants(packed.kernels.double(), packed.window_hw), layout, c)
    assert got.shape == exact.shape == (layout.n_variants, cache.p0.shape[1])
    assert torch.isfinite(got).all()
    assert float((got.double() - exact).abs().max()) <= F64_TOL
    geo = ncc_kernel.launch_geometry(cache.p0.shape[3], *kernel_hw,
                                     *_host_plan(cache, packed, layout))
    assert geo["stages"] >= 2 and geo["patch_buffers"] in (1, 2)


def _host_plan(cache, packed, layout):
    tile = ncc_kernel.kernel_tile()
    row_hw = ncc_kernel.host_row_hw(packed.window_hw.cpu().numpy(), layout)
    return (ncc_kernel.row_plan(row_hw, packed.kernels.shape[-2:], tile.rows, "cuda"),
            ncc_kernel.print_plan(cache.valid_hw.cpu().numpy(), tile.positions))


def test_kernel_precision_against_float64():
    """At the main path's canvas and depth of taps, the kernel (3xTF32, each
    32-tap chunk summed in a fresh accumulator) stays under half the error
    of the plain version with TF32 convolutions, both against float64."""
    _need_card()
    c = 32
    cache, packed, layout = _case(8, c, 6, (1, 8, 8), 4, (46, 46), (34, 34))
    got = ncc_kernel.score_ncc(cache, packed, layout, c)
    exact = score_direct(type(cache)(*(t.double() for t in cache[:3]), cache.valid_hw),
                         PackedVariants(packed.kernels.double(), packed.window_hw), layout, c)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = score_direct(cache, packed, layout, c)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    err = float((got.double() - exact).abs().max())
    err_tf32 = float((tf32.double() - exact).abs().max())
    assert err < 0.5 * err_tf32, (err, err_tf32)


def test_kernel_rejects_bad_operands():
    _need_card()
    cache, packed, layout = _case(0, 5, 3, (1,), 2, (16, 16), (8, 8))
    kern = packed.kernels.contiguous()
    gvalid = cache.valid_hw.to(torch.int32).contiguous()
    rows, prints = _host_plan(cache, packed, layout)
    args = [cache.p0, cache.int1, cache.int2, kern, gvalid, rows, prints, 5]
    with pytest.raises(TypeError):
        ncc_kernel.launch_ncc(*args[:3], kern.double(), *args[4:])
    with pytest.raises(ValueError):
        ncc_kernel.launch_ncc(*args[:3], kern.transpose(2, 3), *args[4:])
    with pytest.raises(ValueError):
        ncc_kernel.launch_ncc(cache.p0.cpu(), *args[1:])
    other = ncc_kernel.row_plan(np.full((1, 2), 8), kern.shape[-2:], rows.m_tile, "cuda")
    with pytest.raises(ValueError):
        ncc_kernel.launch_ncc(*args[:5], other, prints, 5)
    with pytest.raises(ValueError):  # the plan's table on the host
        ncc_kernel.launch_ncc(*args[:5], rows._replace(table=rows.table.cpu()), prints, 5)


@pytest.mark.parametrize(
    "seed,c,n_prints,counts,pb,canvas,kernel_hw,print_hw",
    [
        (10, 8, 5, (1,), 4, (30, 30), (20, 20), ()),         # one tile (N = 4)
        (11, 5, 6, (1, 3), 3, (41, 37), (33, 31), ()),       # C = 5; odd widths: odd x + dx starts
        (12, 13, 4, (1, 8), 5, (46, 45), (34, 34), ()),      # C = 13, not a multiple of 8
        (13, 8, 6, (1, 8, 8, 8), 15, (46, 46), (34, 34), ()),  # N = 375: a partial last tile
        # fusion's stride-8 block: a 73 x 73 canvas over 88-wide prints
        (14, 8, 3, (1, 8), 3, (92, 92), (73, 73), ()),
        *RING_EDGES,  # the producer/consumer ring's edge cases
    ],
)
def test_bf16_leg_matches_plain_bf16(seed, c, n_prints, counts, pb, canvas, kernel_hw, print_hw):
    """The bf16 leg against the plain scorer with bf16 operands: within
    1e-5, the same top print where the plain margin is clear; its one patch
    layout fits every canvas; and its scores lie further than that from the
    3xTF32 leg's."""
    _need_card()
    cache, packed, layout = _case(seed, c, n_prints, counts, pb, canvas, kernel_hw, print_hw)
    plan = _host_plan(cache, packed, layout)
    before = dict(ncc_kernel.launch_ncc.leg_launches)
    got = ncc_kernel.score_ncc(cache, packed, layout, c, plan=plan, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert ncc_kernel.launch_ncc.leg_launches["bf16"] == before["bf16"] + 1
    assert ncc_kernel.launch_ncc.leg_launches["f32_3xtf32"] == before["f32_3xtf32"]
    want = score_direct(cache, packed, layout, c, compute_dtype=torch.bfloat16)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= BF16_TOL
    g_np, w_np = got.cpu().numpy(), want.cpu().numpy()
    top2 = np.sort(w_np, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * BF16_TOL
    np.testing.assert_array_equal(np.argmax(g_np, 1)[clear], np.argmax(w_np, 1)[clear])
    geo = ncc_kernel.launch_geometry(cache.p0.shape[3], *kernel_hw, *plan, precision="bf16")
    assert geo["patch"] == "bf16" and geo["leg"] == "bf16"
    f32 = ncc_kernel.score_ncc(cache, packed, layout, c, plan=plan)
    assert float((got - f32).abs().max()) > BF16_TOL  # the operands were rounded


def test_bf16_leg_on_cuda_never_takes_the_plain_scorer(monkeypatch):
    """A CUDA tensor with compute_dtype bfloat16 launches the bf16 leg; an
    unknown precision or a 3xTF32 patch layout for the bf16 leg raises."""
    _need_card()
    cache, packed, layout = _case(15, 8, 4, (1, 3), 3, (30, 28), (20, 20))

    def refuse(*args, **kwargs):
        raise AssertionError("score_direct reached with CUDA tensors")

    monkeypatch.setattr(ncc_kernel, "score_direct", refuse)
    before = dict(ncc_kernel.launch_ncc.leg_launches)
    ncc_kernel.score_ncc(cache, packed, layout, 8, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert ncc_kernel.launch_ncc.leg_launches["bf16"] == before["bf16"] + 1
    with pytest.raises(ValueError, match="compute_dtype"):
        ncc_kernel.score_ncc(cache, packed, layout, 8, compute_dtype=torch.float16)
    plan = _host_plan(cache, packed, layout)
    kern = packed.kernels.contiguous()
    gvalid = cache.valid_hw.to(torch.int32).contiguous()
    args = (cache.p0, cache.int1, cache.int2, kern, gvalid, *plan, 8)
    with pytest.raises(ValueError, match="precision"):
        ncc_kernel.launch_ncc(*args, precision="tf32")
    with pytest.raises(ValueError, match="layout"):
        ncc_kernel.launch_ncc(*args, patch="split", precision="bf16")
    assert ncc_kernel.launch_ncc.leg_launches["bf16"] == before["bf16"] + 1


def test_pipeline_kernel_ranks_equal_plain(tmp_path):
    """A tiny Impress-layout dataset through the port on the card, once
    through the kernel and once through the plain scorer."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    cfg_path = _pipeline_config(tmp_path)
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


def _pipeline_config(tmp_path):
    """A tiny Impress-layout dataset (8 prints, 4 queries) and its run.toml,
    on one device (``mesh_shape = 0`` would take every visible card)."""
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
mesh_shape = 1
""")
    return cfg_path


@pytest.mark.parametrize("precision", ["f32", "f32_3xtf32", "bf16"])
@pytest.mark.parametrize(
    "n,k,lanes,y_iters,grid",
    [
        (24, 37, 16, 3, 2),       # ragged everywhere, one tile (bf16 a: a 74-byte stride)
        (70, 1156, 130, 2, 3),    # the probe's depth; ragged rows and lanes, two lane blocks
        (128, 64, 128, 1, 1),     # whole tiles
        (16, 8, 8, 0, 2),         # no products: zeros
        (1400, 1156, 128, 2, 3),  # the NCC row count: a ragged last row tile
        (256, 64, 128, 1, 300),   # 600 tiles: more than SMs, the persistent walk
        (64, 1156, 128, 48, 2),   # the JAX probe's full depth: accumulator drift
    ],
)
def test_probe_kernel_matches_plain(precision, n, k, lanes, y_iters, grid):
    _need_card()
    from shoeprint_image_retrieval_torch.benchmarks.mxu_probe import probe_inputs

    a, b = probe_inputs(n, k, lanes, precision, torch.device("cuda"))
    before = mp.launch_mma.launches
    got = mp.mma_probe(a, b, y_iters, grid, precision)
    torch.cuda.synchronize()
    assert mp.launch_mma.launches == before + 1
    want = mp.probe_plain(a, b, y_iters, grid)
    assert got.shape == want.shape == (grid, n, lanes)
    assert torch.isfinite(got).all()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) / scale <= PROBE_TOL[precision]
    assert torch.equal(got[0], got[-1])  # every step computes the same sum


def test_probe_kernel_rejects_bad_operands():
    _need_card()
    a = torch.zeros((8, 16), device="cuda")
    b = torch.zeros((16, 8), device="cuda")
    with pytest.raises(TypeError):
        mp.launch_mma(a, b, 1, 1, "bf16")
    with pytest.raises(ValueError):
        mp.launch_mma(a, b.t(), 1, 1, "f32")  # (8, 16) does not chain with (8, 16)
    with pytest.raises(ValueError):
        mp.launch_mma(a, b.t().contiguous().t(), 1, 1, "f32")  # not contiguous
    with pytest.raises(ValueError):
        mp.launch_mma(a, b.cpu(), 1, 1, "f32")


def test_probe_geometry_matches_the_model():
    """The library's tile, chunk and cluster are the ones the wrapper packs
    for and ``l2_bytes`` counts, and a call launches one cluster a unit, up
    to what the card holds at once."""
    _need_card()
    geo = mp.tile_geometry()
    assert set(geo) == set(mp.PRECISIONS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for precision, leg in geo.items():
        assert leg["tile"] == [*mp.TILE, mp.k_chunk(precision)]
        assert leg["cluster"] == mp.CLUSTER and leg["consumer_warpgroups"] == 2
        assert leg["smem_bytes"] <= 232448
        plan = mp.launch_plan(512, 1156, 128, 48, 100, precision)  # 200 tiles of 2 grid steps
        assert plan["blocks"] % mp.CLUSTER == 0 and sms // 2 < plan["blocks"] <= sms
        assert 48 % plan["parts"] == 0 and plan["parts"] > 1  # 200 tiles leave a short last round
        plan = mp.launch_plan(70, 1156, 130, 1, 1, precision)  # one step, 2 lane tiles, 1 product
        assert plan["blocks"] == 2 * mp.CLUSTER and plan["parts"] == 1
        assert plan["scratch_bytes"] == (2 * 200 * mp.padded_depth(1156, precision) * 4
                                         if precision == "f32_3xtf32" else 0)


def test_device_clahe_on_the_card_matches_native(tmp_path, monkeypatch):
    """``clahe_host = false`` on a CUDA pipeline: CLAHE runs on the card
    (every call's tensors are there), bit-exact to the native host CLAHE
    (gray and RGB), below the tile grid equal to its CPU run, and the run
    ranks as the host-CLAHE run does."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.data import native_ingest
    from shoeprint_image_retrieval_torch.ops import clahe
    from shoeprint_image_retrieval_torch.retrieval import engine

    rng = np.random.default_rng(3)
    sizes = [(75, 65), (76, 66), (64, 64), (37, 53), (120, 90)]
    gray = [rng.integers(0, 256, hw, dtype=np.uint8) for hw in sizes]
    rgb = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in sizes]
    pipe = engine.Pipeline(load_config(_pipeline_config(tmp_path)), weights_dir=None,
                           verbose=False, device="cuda")
    for imgs in (gray, rgb):
        batch, valid = engine.pack_canvas(imgs)
        got = pipe._device_clahe(torch.from_numpy(batch).cuda(), torch.from_numpy(valid).cuda())
        assert got.is_cuda
        got = got.cpu().numpy()
        for i, want in enumerate(native_ingest.clahe_batch(imgs, 2.0, (8, 8))):
            np.testing.assert_array_equal(got[i, : want.shape[0], : want.shape[1]], want)
    tiny = torch.from_numpy(rng.integers(0, 256, (6, 7, 12), dtype=np.uint8))
    tiny_hw = torch.tensor([[7, 12], [3, 3], [1, 7], [7, 1], [5, 9], [2, 12]], dtype=torch.int32)
    assert torch.equal(clahe.clahe_batched_dynamic(tiny.cuda(), tiny_hw.cuda()).cpu(),
                       clahe.clahe_batched_dynamic(tiny, tiny_hw))

    devices = []

    def spy(u8, valid, *args):
        devices.append((u8.device.type, valid.device.type))
        return clahe.clahe_batched_dynamic(u8, valid, *args)

    monkeypatch.setattr(engine, "clahe_batched_dynamic", spy)
    ranks = {}
    for host in (True, False):
        cfg = load_config(_pipeline_config(tmp_path / str(host)))
        cfg["tpu"]["clahe_host"] = host
        run = engine.Pipeline(cfg, weights_dir=None, verbose=False, device="cuda")
        ranks[host] = [o.ranks.tolist() for o in run.run()]
        assert set(run.clahe_routes) == {"host" if host else "device"}
    assert devices and set(devices) == {("cuda", "cuda")}
    assert ranks[True] == ranks[False]


def test_prewarm_failed_build_raises_at_first_scoring_call(tmp_path, monkeypatch):
    """``prewarm`` builds the NCC kernel on a thread from the moment the
    pipeline is made; a build that fails there is raised by the first
    scoring call, not lost."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.ops import build
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    real_load, calls = build.load, []

    def failing_once(name):
        calls.append(name)
        if len(calls) == 1:
            raise RuntimeError("nvcc failed (injected)")
        return real_load(name)

    ncc_kernel._library.cache_clear()
    ncc_kernel.kernel_tile.cache_clear()
    monkeypatch.setattr(build, "load", failing_once)
    cfg = load_config(_pipeline_config(tmp_path))
    cfg["tpu"]["prewarm"] = True
    pipe = Pipeline(cfg, weights_dir=None, verbose=False, device="cuda")  # does not raise
    with pytest.raises(RuntimeError, match="prewarm") as err:
        list(pipe.run())
    assert "injected" in str(err.value.__cause__)
    assert calls == ["ncc_score"] and pipe._prewarm is None


def test_maps_over_budget_go_to_pinned_host_memory(tmp_path, monkeypatch):
    """Above ``SIR_DEVICE_MAPS_MAX`` the extracted maps leave the card for
    pinned host memory; the ranks do not change."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    cfg_path = _pipeline_config(tmp_path)
    ranks = {}
    for budget in ("0", str(int(2e9))):
        monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", budget)
        pipe = Pipeline(load_config(cfg_path), weights_dir=None, verbose=False, device="cuda")
        q_maps, _, g_maps, _, _ = pipe._cluster_features(pipe.plans[0])
        on_host = budget == "0"
        for maps in (q_maps, g_maps):
            assert maps.is_cuda != on_host and (not on_host or maps.is_pinned())
        ranks[budget] = [o.ranks.tolist() for o in pipe.run()]
    assert ranks["0"] == ranks[str(int(2e9))]


def test_bf16_maps_at_rest_cross_in_bf16(tmp_path):
    """``cache_dtype = "bfloat16"``: host maps rest as a bf16 tensor and are
    scored as those values widened on the card, bit for bit; maps on the
    card are left alone."""
    _need_card()
    from shoeprint_image_retrieval_torch import bench

    w = bench.make_workload(quick=True)
    q = torch.from_numpy(bench.draw_probe_maps(w)).cuda()
    pipe = bench.engine_pipeline(tmp_path, w["pb"], torch.device("cuda"))
    pipe.config["tpu"]["cache_dtype"] = "bfloat16"
    on_card = torch.from_numpy(w["gal"]).cuda()
    assert pipe._maps_at_rest(on_card) is on_card
    rest = pipe._maps_at_rest(torch.from_numpy(w["gal"]).pin_memory())
    assert rest.dtype == torch.bfloat16 and not rest.is_cuda
    got = pipe._score_cluster(q, w["q_sizes"], rest, w["g_sizes"])
    want = pipe._score_cluster(q, w["q_sizes"], rest.cuda().float(), w["g_sizes"])
    pipe.close()
    np.testing.assert_array_equal(got, want)


def test_blocked_engine_equals_unblocked(tmp_path):
    """gallery_block and rank_on_device on the card: identical ranks and
    scores to one block with host ranks."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.retrieval.engine import DeviceScores, Pipeline

    cfg_path = _pipeline_config(tmp_path)
    outs = {}
    for gb, rank_dev in ((0, False), (3, False), (3, True), (0, True)):
        cfg = load_config(cfg_path)
        cfg["tpu"]["gallery_block"] = gb
        cfg["tpu"]["rank_on_device"] = rank_dev
        pipe = Pipeline(cfg, weights_dir=None, verbose=False, device="cuda")
        outs[gb, rank_dev] = list(pipe.run())
        assert pipe.gallery_blocks_scored == (3 if gb == 3 else 1) * len(pipe.plans)
    for key, run in outs.items():
        for o, p in zip(run, outs[0, False]):
            np.testing.assert_array_equal(o.ranks, p.ranks)
            scores = o.scores.materialize() if isinstance(o.scores, DeviceScores) else o.scores
            np.testing.assert_allclose(scores, p.scores, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,block", [("VGG16", 24), ("DenseNet_201", 8), ("EfficientNet_B7", 6)])
def test_backbone_family_on_the_card_matches_cpu(name, block):
    """One backbone of each family, seeded, on the card against the same
    module and weights on the CPU: within 1e-4 of the activation scale,
    equal valid sizes."""
    _need_card()
    from shoeprint_image_retrieval_torch.device import resolve_device
    from shoeprint_image_retrieval_torch.models.registry import get_backbone
    from shoeprint_image_retrieval_torch.models.weights import seeded_init

    resolve_device("cuda")
    features = get_backbone(name).build(block)
    seeded_init(features, name)
    features.eval()
    rng = np.random.default_rng(0)
    x = torch.zeros((2, 3, 160, 144))
    x[0] = torch.from_numpy(rng.normal(size=(3, 160, 144)).astype(np.float32))
    x[1, :, :121, :97] = torch.from_numpy(rng.normal(size=(3, 121, 97)).astype(np.float32))
    valid = torch.tensor([[160, 144], [121, 97]], dtype=torch.int32)
    with torch.inference_mode():
        want, want_v = features(x, valid)
        features.cuda()
        got, got_v = features(x.cuda(), valid.cuda())
    assert torch.equal(got_v.cpu(), want_v)
    scale = float(want.abs().max())
    assert 0 < scale and float((got.cpu() - want).abs().max()) <= 1e-4 * scale


def test_fft_scorer_on_the_card_matches_cpu_and_ranks_as_direct(tmp_path):
    """``ops/ncc`` on the card against its CPU run, and the pipeline with
    ``ncc_backend = "fft"`` on the card against the plain direct scorer."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.ops import ncc
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    rng = np.random.default_rng(5)
    prints = np.zeros((6, 20, 30, 26), np.float32)
    p_valid = np.asarray([[30, 26], [22, 19], [30, 20], [14, 26], [25, 25], [9, 9]], np.int32)
    for i, (h, w) in enumerate(p_valid):
        prints[i, :, :h, :w] = rng.normal(size=(20, h, w))
    templates = np.zeros((4, 20, 28, 24), np.float32)
    t_valid = np.asarray([[28, 24], [12, 10], [12, 10], [20, 7]], np.int32)
    for i, (h, w) in enumerate(t_valid):
        templates[i, :, :h, :w] = rng.normal(size=(20, h, w))
    scores = {}
    for dev in ("cpu", "cuda"):
        cache, _ = ncc.build_gallery_cache(torch.from_numpy(prints).to(dev),
                                           torch.from_numpy(p_valid).to(dev), (24, 20))
        scores[dev] = ncc.score_templates(cache, torch.from_numpy(templates).to(dev), t_valid,
                                          true_channels=20).cpu()
    assert torch.isfinite(scores["cuda"]).all()
    assert float((scores["cuda"] - scores["cpu"]).abs().max()) <= 1e-5

    cfg_path = _pipeline_config(tmp_path)
    outs = {}
    for backend in ("fft", "direct"):
        cfg = load_config(cfg_path)
        cfg["tpu"]["ncc_backend"] = backend
        outs[backend] = list(Pipeline(cfg, weights_dir=None, verbose=False, device="cuda").run())
    for f, d in zip(outs["fft"], outs["direct"]):
        np.testing.assert_array_equal(f.ranks, d.ranks)
        np.testing.assert_allclose(f.scores, d.scores, atol=TOL)


def test_fusion_and_pruned_pipelines_kernel_equal_plain(tmp_path):
    """``fusion_blocks`` and ``pruned_scoring`` on the card: the kernel's
    ranks equal the plain scorer's, fusion's summed scores within the
    kernel's tolerance twice over, pruned ranks equal the full path's, and
    the kernel launched in every kernel run."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    cfg_path = _pipeline_config(tmp_path)
    runs = {}
    for mode, extra in (("full", {}), ("fusion", {"fusion_blocks": [4, 3]}),
                        ("pruned", {"pruned_scoring": True, "prune_channels": 8})):
        for backend in ("auto", "direct"):
            cfg = load_config(cfg_path)
            cfg["tpu"].update(ncc_backend=backend, **extra)
            before = ncc_kernel.launch_ncc.launches
            runs[mode, backend] = list(Pipeline(cfg, weights_dir=None, verbose=False,
                                                device="cuda").run())
            assert (ncc_kernel.launch_ncc.launches > before) == (backend == "auto")
    for mode in ("full", "fusion", "pruned"):
        for k, p, f in zip(runs[mode, "auto"], runs[mode, "direct"], runs["full", "direct"]):
            np.testing.assert_array_equal(k.ranks, p.ranks)
            if mode == "pruned":
                assert k.scores is None
                np.testing.assert_array_equal(k.ranks, f.ranks)
            else:
                np.testing.assert_allclose(k.scores, p.scores, atol=2 * TOL)


def test_auto_probe_rows_on_the_card(tmp_path):
    """``probe_batch = 0`` on the card: whole tiles of the kernel's rows,
    within the card's row cap and its free memory; the scores equal an
    explicit probe batch's within the kernel's tolerance, ranks identical."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.device import free_bytes, resolve_device
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    dev = resolve_device("cuda")
    tile = ncc_kernel.kernel_tile()
    row_bytes = ncc_kernel.probe_row_bytes(176, (36, 36), (38, 38), (34, 34), 7, 3, 25, 300)
    rows = ncc_kernel.auto_probe_rows(row_bytes, free_bytes(dev), tile.rows)
    assert rows % tile.rows == 0 and tile.rows <= rows <= ncc_kernel.H100_PROBE_ROWS
    assert ncc_kernel.auto_probe_rows(row_bytes, 10 * row_bytes * tile.rows, tile.rows) <= 10 * tile.rows
    outs = {}
    for pb in (0, 3):
        cfg = load_config(_pipeline_config(tmp_path / str(pb)))
        cfg["tpu"]["probe_batch"] = pb
        pipe = Pipeline(cfg, weights_dir=None, verbose=False, device="cuda")
        outs[pb] = list(pipe.run())
        if pb == 0:  # the fixture's 4 queries fit one call
            assert pipe.probe_batches == [o.n_queries for o in outs[0]]
    for a, b in zip(outs[0], outs[3]):
        np.testing.assert_array_equal(a.ranks, b.ranks)
        np.testing.assert_allclose(a.scores, b.scores, atol=TOL)


def test_pruned_ranks_with_prints_tied_to_the_true_match(tmp_path):
    """Pruned ranks on the card where other prints score as the true match
    does: exact copies of a true match at lower and higher gallery indices
    (an exact tie in one call), and copies scaled by 1 + 1e-7 (NCC ignores
    the scale, so they differ from the true match by rounding alone). Pass
    0's batch-diagonal calls tile their rows otherwise than the full path,
    so only pass 2's own true-pair score ranks them as the full path does."""
    _need_card()
    from shoeprint_image_retrieval_torch import bench
    from shoeprint_image_retrieval_torch.benchmarks.bench_pruned import make_workloads
    from shoeprint_image_retrieval_torch.ops.topk import ranks_on_device
    from shoeprint_image_retrieval_torch.retrieval.pruned import pruned_ranks

    w = make_workloads(quick=True)["planted"]
    gal, g_sizes, pairs = w["gal"].copy(), w["g_sizes"].copy(), w["pairs"]
    free = [j for j in range(len(gal)) if j not in set(pairs.tolist())]
    copies = {}
    for qi, (j, scale) in enumerate(zip((free[0], free[-1], free[1], free[-2]),
                                        (1.0, 1.0, 1.0 + 1e-7, 1.0 + 1e-7))):
        gal[j], g_sizes[j] = gal[pairs[qi]] * np.float32(scale), g_sizes[pairs[qi]]
        copies[qi] = j
    pipe = bench.engine_pipeline(tmp_path, 4, torch.device("cuda"))
    q_in, g_in = torch.from_numpy(w["qmaps"]).cuda(), torch.from_numpy(gal).cuda()

    def score_fn(qm, qv, gm, gv):
        return pipe._score_cluster(qm, qv, gm, gv)

    full = score_fn(q_in, w["q_sizes"], g_in, g_sizes)
    assert full[0, copies[0]] == full[0, pairs[0]] and full[1, copies[1]] == full[1, pairs[1]]
    want = ranks_on_device(torch.from_numpy(full), torch.from_numpy(pairs)).numpy()
    got, stats = pruned_ranks(score_fn, q_in, w["q_sizes"], g_in, g_sizes, pairs, k=2, batch0=2)
    pipe.close()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 2  # the copy at the higher index ranks above the true match
    assert stats["survivors"] >= len(set(pairs.tolist()))


def _sharded_case(mesh_devices, dtype):
    """19 prints at the main-path canvas scored by the kernel unsharded and
    sharded over ``mesh_devices``: (unsharded, sharded, sharded with the pad
    columns, launches of the sharded call, shards)."""
    from shoeprint_image_retrieval_torch.parallel.mesh import build_mesh
    from shoeprint_image_retrieval_torch.parallel.sharded import (
        make_sharded_packed_scorer, shard_cache)

    c = 16
    cache, packed, layout = _case(9, c, 19, (1, 8, 8), 3, (46, 46), (34, 34))
    want = ncc_kernel.score_ncc(cache, packed, layout, c, compute_dtype=dtype)
    mesh = build_mesh(len(mesh_devices), mesh_devices)
    shards, g_true = shard_cache(cache, mesh)
    scorer = make_sharded_packed_scorer(mesh, shards, true_channels=c, layout=layout,
                                        g_true=g_true, use_kernel=True, compute_dtype=dtype)
    before = ncc_kernel.launch_ncc.launches
    got = scorer(packed)
    launches = ncc_kernel.launch_ncc.launches - before
    padded = make_sharded_packed_scorer(mesh, shards, true_channels=c, layout=layout,
                                        use_kernel=True, compute_dtype=dtype)(packed)
    return want.cpu().numpy(), got.cpu().numpy(), padded.cpu().numpy(), launches, shards


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4, 8])
def test_sharded_kernel_matches_unsharded(n, dtype):
    """The NCC kernel once a shard on ``[cuda:0] * n``: within 1e-6 of one
    unsharded call, the same rank order, the last shard's pad prints 0."""
    _need_card()
    want, got, padded, launches, shards = _sharded_case(["cuda:0"] * n, dtype)
    assert launches == n and got.shape == want.shape == (3 * 17, 19)
    assert float(np.abs(got - want).max()) <= 1e-6
    assert (np.argsort(-got, axis=1, kind="stable")
            == np.argsort(-want, axis=1, kind="stable")).all()
    k = shards[0].valid_hw.shape[0]
    assert padded.shape[1] == n * k > 19 and (padded[:, 19:] == 0).all()
    np.testing.assert_array_equal(padded[:, :19], got)


def test_sharded_kernel_across_real_devices():
    """Shards on distinct cards (up to four): the kernel on each, the rows
    copied to the first; then the engine's dryrun over those cards."""
    _need_card()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("one CUDA device visible: copies between cards not exercised")
    from shoeprint_image_retrieval_torch.dryrun import dryrun_multichip

    devices = [f"cuda:{i}" for i in range(n)]
    want, got, padded, launches, shards = _sharded_case(devices, torch.float32)
    assert [s.p0.device.index for s in shards] == list(range(n)) and launches == n
    assert float(np.abs(got - want).max()) <= 1e-6
    assert (padded[:, 19:] == 0).all()
    out = dryrun_multichip(n, devices)
    assert out["score_err"] <= 1e-6 and out["gallery_blocks"] == 2


def test_extraction_makes_no_replica_of_the_model_on_its_own_card(tmp_path):
    """One card, at a mesh of one and of ``cuda:0`` twice: extraction
    runs the pipeline's own models and copies none (``"cuda"`` is
    ``cuda:0``); the sharded run's ranks equal the unsharded run's."""
    _need_card()
    from shoeprint_image_retrieval_torch.config import load_config
    from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline

    cfg_path = _pipeline_config(tmp_path)
    outs = {}
    for mesh_shape in (1, 2):
        cfg = load_config(cfg_path)
        cfg["tpu"]["mesh_shape"] = mesh_shape
        cfg["tpu"]["extraction_batch"] = 32 * mesh_shape  # each device: the same chunk
        pipe = Pipeline(cfg, weights_dir=None, verbose=False, device="cuda",
                        mesh_devices=["cuda:0"] * 2)
        outs[mesh_shape] = list(pipe.run())
        assert pipe._replicas == {}
        assert ("extract:2" in pipe.mesh_runs) == (mesh_shape == 2)
    for a, b in zip(outs[1], outs[2]):
        np.testing.assert_array_equal(a.ranks, b.ranks)
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-6)

"""The NCC kernel's host tile plan and its arithmetic, on the CPU.

The kernel (``csrc/ncc_score.cu``) runs only on the card; what surrounds it
is held here:

* ``row_plan`` covers every nonzero tap of every row of real variant
  stacks (``build_kernels``, both ``variant_mode``s, the fixture's 47 x 39
  and the main path's 34 x 34 canvases), and ``print_plan`` bounds what
  every block stages;
* zeroing the taps outside each tile's rectangle, and scoring the rows in
  the plan's order and scattering them back, leave ``score_direct`` bit for
  bit the same: the plan drops only exact zeros;
* for class-uniform tiles the plan equals the JAX package's
  ``derive_class_taps``;
* ``executed_flop`` counts a hand-worked case;
* a plain emulation of the 3xTF32 split keeps a 1156-deep dot close to
  float64, and an emulation of the tensor cores' truncating accumulator
  shows why the kernel sums each 32-tap chunk in a fresh fragment.

The kernel's tile is read from the built library on the card
(``kernel_tile``); here the plan is held at that tile and at others.
"""

import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_tpu.ops.pallas.ncc_kernel import derive_class_taps
from shoeprint_image_retrieval_torch.ops import ncc_kernel as nk
from shoeprint_image_retrieval_torch.ops.ncc_direct import (
    PackedVariants,
    VariantLayout,
    build_direct_cache,
    row_slots,
    score_direct,
)
from shoeprint_image_retrieval_torch.retrieval.engine import (
    batch_windows,
    build_kernels,
    variant_classes,
    variant_plan,
)

ROTATIONS = [-15, -9, -3, 3, 9, 15, 180]
SCALES = [1.02, 1.04, 1.08]
# map canvases whose kernel canvases are the main path's 34 x 34 and the
# synthetic fixture's 47 x 39 (the 1.08 scale widens the template canvas)
MAP_CANVASES = {"main": (36, 36), "fixture": (48, 40)}
# csrc/ncc_score.cu's tile: rows, positions, taps per chunk
TILE = nk.Tile(64, 256, 32)


def _stack(seed, mode, canvas, pb=6, c=2, n_prints=5):
    """A real variant stack from seeded probe maps, its row windows and a
    small gallery cache on the CPU."""
    rng = np.random.default_rng(seed)
    hc, wc = canvas
    q_sizes = np.stack([rng.integers(hc * 2 // 3, hc + 1, pb),
                        rng.integers(wc * 2 // 3, wc + 1, pb)], axis=1).astype(np.int32)
    maps = np.zeros((pb, c, hc, wc), np.float32)
    for i, (h, w) in enumerate(q_sizes):
        maps[i, :, :h, :w] = rng.normal(size=(c, h, w))
    plan = variant_plan(q_sizes, canvas, ROTATIONS, SCALES)
    include, counts = variant_classes(mode, plan.n_rot, plan.n_scl)
    kernel_hw = (plan.template_canvas[0] - 4, plan.template_canvas[1] - 4)
    t = [torch.from_numpy(np.asarray(a)) for a in
         (maps, q_sizes, plan.rot_idx, plan.rot_ok, plan.wv, plan.wh, plan.scale_hw)]
    kernels = build_kernels(*t, kernel_hw=kernel_hw, include_rots_unscaled=include,
                            n_scl=plan.n_scl)
    wins, uniq, inv = batch_windows(q_sizes, plan.scale_hw, plan.n_scl)
    packed = PackedVariants(kernels, torch.from_numpy(wins))
    layout = VariantLayout(counts, pb)
    slots = (torch.from_numpy(uniq), torch.from_numpy(inv))
    s, row_slot = row_slots(packed, layout, *slots)
    row_hw = s[row_slot].numpy()

    g_sizes = np.stack([rng.integers(hc // 2, hc + 5, n_prints),
                        rng.integers(wc // 2, wc + 5, n_prints)], axis=1).astype(np.int32)
    gal = np.zeros((n_prints, c, hc + 4, wc + 4), np.float32)
    for i, (h, w) in enumerate(g_sizes):
        gal[i, :, :h, :w] = rng.normal(size=(c, h, w))
    cache = build_direct_cache(torch.from_numpy(gal), torch.from_numpy(g_sizes))
    return cache, packed, layout, slots, row_hw, kernel_hw


def _tap_mask(plan, n, kernel_hw):
    """(N, hk, wk) bool: each kernel row's tile rectangle, in plan order."""
    mask = np.zeros((n, *kernel_hw), bool)
    m = plan.m_tile
    for t, (i0, h, j0, w) in enumerate(plan.taps):
        mask[t * m:(t + 1) * m, i0:i0 + h, j0:j0 + w] = True
    return mask


@pytest.mark.parametrize("m_tile", [TILE.rows, 16])
@pytest.mark.parametrize("canvas", sorted(MAP_CANVASES))
@pytest.mark.parametrize("mode", ["reference", "full"])
def test_row_plan_covers_every_nonzero_tap(mode, canvas, m_tile):
    _, packed, _, _, row_hw, kernel_hw = _stack(0, mode, MAP_CANVASES[canvas], pb=12)
    assert tuple(packed.kernels.shape[-2:]) == {"main": (34, 34), "fixture": (47, 39)}[canvas]
    plan = nk.row_plan(row_hw, kernel_hw, m_tile)
    n = len(row_hw)
    assert sorted(plan.order.tolist()) == list(range(n))
    assert plan.taps.shape == (-(-n // m_tile), 4)
    nonzero = (packed.kernels.numpy() != 0).any(axis=1)[plan.order]  # (N, hk, wk)
    assert nonzero.any()
    assert not (nonzero & ~_tap_mask(plan, n, kernel_hw)).any()
    # every row finds its own window in its tile's window table
    sorted_hw = row_hw[plan.order]
    tile_of = np.arange(n) // m_tile
    np.testing.assert_array_equal(plan.windows[tile_of, plan.slots], sorted_hw)
    np.testing.assert_array_equal(plan.table.numpy(), plan.host_table())
    # the rectangle is each tile's largest window, centred as fold_template centres
    for t, (i0, h, j0, w) in enumerate(plan.taps):
        rows = row_hw[plan.order[t * m_tile:(t + 1) * m_tile]]
        assert (h, w) == (min(kernel_hw[0], rows[:, 0].max()), min(kernel_hw[1], rows[:, 1].max()))
        assert (i0, j0) == (kernel_hw[0] // 2 - h // 2, kernel_hw[1] // 2 - w // 2)


@pytest.mark.parametrize("canvas", sorted(MAP_CANVASES))
def test_plan_drops_only_exact_zeros(canvas):
    """score_direct is bit-identical with the taps outside each tile's
    rectangle zeroed, and with the rows scored in plan order and scattered
    back."""
    cache, packed, layout, slots, row_hw, kernel_hw = _stack(1, "reference",
                                                              MAP_CANVASES[canvas], pb=4)
    c = packed.kernels.shape[1]
    plan = nk.row_plan(row_hw, kernel_hw, TILE.rows)
    want = score_direct(cache, packed, layout, c, *slots)

    n = len(row_hw)
    keep = np.zeros((n, *kernel_hw), bool)
    keep[plan.order] = _tap_mask(plan, n, kernel_hw)
    zeroed = packed.kernels * torch.from_numpy(keep)[:, None]
    got = score_direct(cache, PackedVariants(zeroed, packed.window_hw), layout, c, *slots)
    assert torch.equal(got, want)

    # one window group per row, rows in plan order, scattered back
    order = torch.from_numpy(plan.order)
    per_row = VariantLayout((1,), n)
    sorted_rows = PackedVariants(zeroed[order], torch.from_numpy(row_hw)[order])
    permuted = score_direct(cache, sorted_rows, per_row, c)
    back = torch.empty_like(permuted)
    back[order] = permuted
    assert torch.equal(back, want)


@pytest.mark.parametrize("windows", [
    [(30, 28), (20, 34), (9, 5)],   # each class below the canvas in some side
    [(40, 40), (34, 36)],           # every class covers the canvas: no sub-rectangle
])
def test_class_uniform_tiles_match_derive_class_taps(windows):
    hk, wk = 34, 34
    # class-major rows, a whole tile per class, classes in descending window
    # order so the plan keeps them in place
    row_hw = np.repeat(np.asarray(windows, np.int64), TILE.rows, axis=0)
    plan = nk.row_plan(row_hw, (hk, wk), TILE.rows)
    np.testing.assert_array_equal(plan.order, np.arange(len(row_hw)))
    want = derive_class_taps(windows, hk=hk, wk=wk, n_classes=len(windows))
    if want is None:  # the JAX kernel then uses the full canvas for every class
        want = [(hk, wk, 0, 0)] * len(windows)
    got = [(h, w, i0, j0) for i0, h, j0, w in plan.taps.tolist()]
    assert got == [tuple(int(v) for v in taps) for taps in want]


def test_executed_flop_hand_worked():
    """A 9 x 9 canvas, one tile whose window covers it, three channels, two
    prints:
    print A, valid (2, 3): one block; tap rows reach rows 0-1 from i = 3..5
    (3 rows), tap columns reach columns 0-2 from j = 2..6 (5): 15 taps,
    padded to 32;
    print B, valid (20, 30): 600 positions in blocks of 256 (rows 0-8,
    8-17, 17-19); the first two blocks keep all 81 taps (96 padded), the
    last reaches rows 17-19 only from i <= 19 + 4 - 17 = 6 (7 x 9 = 63
    taps, 64 padded).
    Executed: 2 x 64 x 256 x (32 + 96 + 96 + 64) x 3 FLOP, at a tile of
    64 rows x 256 positions x 32 taps."""
    tile = nk.Tile(rows=64, positions=256, taps=32)
    row_hw = np.full((10, 2), 9)
    gvalid = np.asarray([[2, 3], [20, 30]])
    rows = nk.row_plan(row_hw, (9, 9), tile.rows)
    prints = nk.print_plan(gvalid, tile.positions)
    assert rows.taps.tolist() == [[0, 9, 0, 9]]
    assert prints == (3, 10)
    assert nk.patch_rows(prints, 9) == 10 + 9 - 1  # rows 8-17 plus the taps' 9 rows
    np.testing.assert_array_equal(rows.windows, [[[9, 9]]])
    np.testing.assert_array_equal(rows.host_table(), [*range(10), *[0] * 10, 0, 9, 0, 9, 1, 9, 9])
    assert nk.executed_flop(rows, gvalid, 3, (9, 9), tile) == 2 * 64 * 256 * (32 + 96 + 96 + 64) * 3


@pytest.mark.parametrize("canvas", sorted(MAP_CANVASES))
def test_every_block_keeps_the_centre_tap(canvas):
    """The kernel's producer and consumers agree on each block's chunk count
    from K; a live block never clips to K = 0 (the canvas centre tap lies in
    every tile's rectangle and reaches every position), also for a 1 x 1
    print and prints narrower or shorter than the canvas. ``executed_flop``
    is the sum of those blocks' padded taps."""
    _, packed, _, _, row_hw, kernel_hw = _stack(4, "reference", MAP_CANVASES[canvas], pb=8)
    rows = nk.row_plan(row_hw, kernel_hw, TILE.rows)
    rng = np.random.default_rng(5)
    gvalid = np.concatenate([[[1, 1], [1, 40], [40, 1], [5, 7]],
                             np.stack([rng.integers(1, 50, 30), rng.integers(1, 50, 30)], 1)])
    k, live = nk.block_taps(rows, gvalid, kernel_hw, TILE)
    assert k.shape == (len(rows.taps), *live.shape)
    assert (k[:, live] >= 1).all()
    assert (k[:, live] <= kernel_hw[0] * kernel_hw[1]).all()
    # the 1 x 1 print: one block a tile, its centre tap alone
    np.testing.assert_array_equal(k[:, 0, 0], 1)
    k_pad = -(-k // TILE.taps) * TILE.taps
    want = 2.0 * TILE.rows * TILE.positions * 3 * float(np.where(live[None], k_pad, 0).sum())
    assert nk.executed_flop(rows, gvalid, 3, kernel_hw, TILE) == want


@pytest.mark.parametrize("n_tile", [TILE.positions, 100])
def test_print_plan_bounds_every_block(n_tile):
    """The print rows each block holds, computed as the kernel computes them
    from its print and position chunk, stay within the plan's buffer (the
    kernel stops on a block that would not)."""
    rng = np.random.default_rng(3)
    gvalid = np.stack([rng.integers(1, 43, 40), rng.integers(1, 43, 40)], axis=1)
    hk = 34
    prints = nk.print_plan(gvalid, n_tile)
    rows_held = nk.patch_rows(prints, hk)
    assert prints.n_chunks == max(-(-h * w // n_tile) for h, w in gvalid)
    for vh, vw in gvalid:
        npos = vh * vw
        for p_begin in range(0, npos, n_tile):
            y_first, y_last = p_begin // vw, (min(p_begin + n_tile, npos) - 1) // vw
            assert y_last - y_first + hk <= rows_held  # the taps' rows are at most hk


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to a 10-bit
    mantissa (the low 13 bits cleared)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_emulation():
    x = np.asarray([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -(1.0 + 2**-11), 3.0 + 2**-12],
                   np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.asarray([1.0, 1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10), 3.0], np.float32))


def test_3xtf32_split_keeps_a_1156_deep_dot():
    """a . b with a = a_hi + a_lo, b = b_hi + b_lo (each part TF32) and
    d = sum(a_lo b_hi + a_hi b_lo + a_hi b_hi) accumulated in f32 rounded
    to nearest: the error against float64, relative to sum |a_i b_i|, stays
    below 1e-6 and within a small factor of a plain f32 dot's. This holds
    the split alone; the tensor cores' own accumulator rounds otherwise
    (the next test)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(200, 1156)).astype(np.float32)
    b = (rng.normal(size=(200, 1156)) * rng.uniform(0.1, 10, size=(200, 1))).astype(np.float32)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    d = np.zeros(200, np.float32)
    f = np.zeros(200, np.float32)
    for i in range(1156):  # f32 accumulation, one product at a time
        d = d + a_lo[:, i] * b_hi[:, i]
        d = d + a_hi[:, i] * b_lo[:, i]
        d = d + a_hi[:, i] * b_hi[:, i]
        f = f + a[:, i] * b[:, i]
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    exact = (a64 * b64).sum(axis=1)
    scale = np.abs(a64 * b64).sum(axis=1)
    worst = float((np.abs(d - exact) / scale).max())
    worst_f32 = float((np.abs(f - exact) / scale).max())
    assert d.dtype == f.dtype == np.float32
    assert worst < 1e-6
    assert worst < 4 * worst_f32


def _f32_toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _tc_products(d, a, b):
    """One k8 tensor-core product per row: d + sum of 8 exact products,
    rounded toward zero into the FP32 accumulator."""
    return _f32_toward_zero(d.astype(np.float64) + (a.astype(np.float64) * b).sum(axis=1))


def test_truncating_accumulator_needs_fresh_chunks():
    """The kernel's summation on a model of the tensor cores (exact
    products, each k8 sum rounded toward zero into FP32), on correlated
    1156-deep dots (a matching template, whose products share a sign):
    - one accumulator over all 1156 taps (145 k8 steps x 3 products)
      drifts by many ulps of the sum, toward zero;
    - a fresh accumulator per 32-tap chunk (12 products), the chunks added
      in f32 rounded to nearest, as the kernel sums, stays within 1e-6 of
      float64 relative to sum |a_i b_i|, several times closer."""
    rng = np.random.default_rng(1)
    b = rng.normal(size=(200, 1160)).astype(np.float32)
    a = (b + 0.5 * rng.normal(size=b.shape)).astype(np.float32)
    a[:, 1156:] = b[:, 1156:] = 0  # the K tail stages zero taps
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)

    def run(chunk_steps):
        total = np.zeros(200, np.float32)
        part = np.zeros(200, np.float32)
        for s in range(a.shape[1] // 8):
            if s % chunk_steps == 0:
                total = total + part
                part = np.zeros(200, np.float32)
            k = slice(8 * s, 8 * s + 8)
            part = _tc_products(part, a_lo[:, k], b_hi[:, k])
            part = _tc_products(part, a_hi[:, k], b_lo[:, k])
            part = _tc_products(part, a_hi[:, k], b_hi[:, k])
        return total + part

    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    exact = (a64 * b64).sum(axis=1)
    scale = np.abs(a64 * b64).sum(axis=1)
    one = float((np.abs(run(a.shape[1] // 8) - exact) / scale).max())
    chunked = float((np.abs(run(4) - exact) / scale).max())
    assert chunked < 1e-6
    assert one > 4 * chunked


def test_ptxas_report_reads_each_instantiation():
    """``chip_smoke.ptxas_entries`` reads each NCC instantiation's leg,
    launch registers, spills and ptxas's ``wgmma`` notes from an ``nvcc
    -Xptxas -v`` report, and ``ncc_design`` puts them beside a call's roles
    and ring (the lines of the kernel's report on the card, abridged)."""
    import chip_smoke

    name = ("_ZN45_GLOBAL__N__9c01ccf4_12_ncc_score_cu_2e53c2e016ncc_score_kernelILNS_3Leg"
            "E{}EEEvPKfS3_S3_S3_PKiS5_PiNS_8GeometryE")
    report = "\n".join([
        "ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async instructions are "
        f"serialized due to non wgmma instructions in the function '{name.format(1)}'",
        f"ptxas info    : Compiling entry function '{name.format(2)}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{name.format(1)}' for 'sm_90a'",
        "    8 bytes stack frame, 12 bytes spill stores, 52 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__9c01_finalizeEPKiPfif' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 16 registers, used 0 barriers",
    ])
    entries = chip_smoke.ptxas_entries(report)
    assert [(e.get("layout"), e["registers"], e["spill_bytes"], e["wgmma_notes"])
            for e in entries] == [("bf16", 168, 0, []), ("split", 168, 64, ["C7514"]),
                                   (None, 16, 0, [])]
    geometry = {"threads": 384, "producer_warpgroups": 1, "consumer_warpgroups": 2,
                "producer_regs": 64,
                "consumer_regs": 216, "stages": 3, "patch": "split", "patch_buffers": 2,
                "smem_bytes": 213464, "leg": "f32_3xtf32"}
    design = chip_smoke.ncc_design({"sources": {"ncc_score": {"entries": entries}}}, geometry)
    assert design["stages"] == 3 and design["producer_regs"] == 64 and "leg" not in design
    assert design["instantiations"] == [
        {"layout": "bf16", "registers": 168, "spill_bytes": 0, "wgmma_notes": []},
        {"layout": "split", "registers": 168, "spill_bytes": 64, "wgmma_notes": ["C7514"]}]

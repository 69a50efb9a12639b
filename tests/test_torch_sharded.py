"""Gallery sharding (``parallel/``) against the JAX package's mesh.

The JAX package sees eight virtual CPU devices (``tests/conftest.py``); the
port's mesh here is the CPU repeated (``["cpu"] * n``), where each shard runs
the plain scorer. The same seeded numpy inputs go through both:

* ``pad_gallery_cache`` for both cache layouts, bit for bit;
* the FFT sharded scorer at 8 and 2 shards on ``tests/test_sharded.py``'s
  inputs (19 and 6 prints): within 1e-5 of JAX ``make_sharded_scorer``,
  ranks identical;
* the probe-sharded stack build, bit-identical to the replicated build;
* the sharded packed scorer (f32 and bf16) against JAX's, and on the
  plain scorer against JAX's list-form direct scorer;
* the whole slice: the port's Pipeline on ``test_torch_pipeline.py``'s
  fixture over a mesh (8 shards; 2 shards in two gallery blocks; ``fft``;
  pruned; a mesh of 1) against the JAX Pipeline on the same ``mesh_shape``
  (at 1 with ``SIR_FORCE_SHARDED``, the JAX engine's sharded path): ranks
  and S-lines identical, scores within 1e-5;
* the probe batch and gallery block the engine picks on a mesh, against the
  JAX engine's rounding rule;
* ``dryrun_multichip`` over four repeated CPU devices.
"""

import io
import sys
from contextlib import redirect_stdout
from functools import partial
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_tpu.config import load_config as jload
from shoeprint_image_retrieval_tpu.metrics import cmp_all as jcmp
from shoeprint_image_retrieval_tpu.ops import ncc as jncc
from shoeprint_image_retrieval_tpu.ops import ncc_direct as jnd
from shoeprint_image_retrieval_tpu.parallel import mesh as jmesh
from shoeprint_image_retrieval_tpu.parallel import sharded as jsharded
from shoeprint_image_retrieval_torch import bench
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.dryrun import dryrun_multichip
from shoeprint_image_retrieval_torch.metrics import cmp_all as tcmp
from shoeprint_image_retrieval_torch.ops import ncc as tncc
from shoeprint_image_retrieval_torch.ops import ncc_direct as tnd
from shoeprint_image_retrieval_torch.parallel import mesh as tmesh
from shoeprint_image_retrieval_torch.parallel import sharded as tsharded
from shoeprint_image_retrieval_torch.retrieval.engine import (
    Pipeline as TPipeline,
    build_kernels,
    variant_classes,
    variant_plan,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pipeline import (  # noqa: E402
    RUN_TOML,
    START_BLOCK,
    _jax_run,
    _make_dataset,
    _s_lines,
)
from torch_effnet_replica import replica_v2m  # noqa: E402

CPU = torch.device("cpu")


def _cpu_mesh(n):
    return tmesh.build_mesh(n, [CPU] * n)


def _pad_stack(maps, canvas_hw, c_pad=None):
    """``tests/test_sharded.py``'s zero-padded stack, as numpy."""
    c = maps[0].shape[0]
    arr = np.zeros((len(maps), c_pad or c, *canvas_hw), np.float32)
    valid = np.zeros((len(maps), 2), np.int32)
    for i, m in enumerate(maps):
        arr[i, :c, : m.shape[1], : m.shape[2]] = m
        valid[i] = m.shape[1:]
    return arr, valid


def _fft_inputs(case):
    """``tests/test_sharded.py``'s inputs: 19 prints x 5 marks at C = 4 (8
    shards), or 6 prints x 2 marks at C = 2 (2 shards)."""
    if case == 19:
        rng, c, n_marks = np.random.default_rng(0), 4, 5
        prints = [rng.normal(size=(c, int(rng.integers(12, 20)), int(rng.integers(12, 20))))
                  .astype(np.float32) for _ in range(19)]
        marks = [rng.normal(size=(c, int(rng.integers(9, 12)), int(rng.integers(9, 12))))
                 .astype(np.float32) for _ in range(n_marks)]
        return (*_pad_stack(prints, (20, 20)), *_pad_stack(marks, (12, 12)), c, (8, 8), 8)
    rng, c = np.random.default_rng(1), 2
    prints = [rng.normal(size=(c, 14, 14)).astype(np.float32) for _ in range(6)]
    marks = [rng.normal(size=(c, 10, 10)).astype(np.float32) for _ in range(2)]
    return (*_pad_stack(prints, (14, 14)), *_pad_stack(marks, (10, 10)), c, (6, 6), 2)


def _direct_inputs(n_prints=19, c=3, seed=2):
    """Prints of mixed sizes and three marks, zero-padded (numpy)."""
    rng = np.random.default_rng(seed)
    prints = [rng.normal(size=(c, int(rng.integers(12, 18)), int(rng.integers(12, 18))))
              .astype(np.float32) for _ in range(n_prints)]
    gal, gv = _pad_stack(prints, (18, 18))
    marks = [rng.normal(size=(c, int(rng.integers(8, 11)), int(rng.integers(8, 11))))
             .astype(np.float32) for _ in range(3)]
    tm, tv = _pad_stack(marks, (10, 10))
    return gal, gv, tm, tv, c


def _ranks_equal(a, b):
    assert (np.argsort(-a, axis=1, kind="stable") == np.argsort(-b, axis=1, kind="stable")).all()


# --- (a) padding ---------------------------------------------------------------

@pytest.mark.parametrize("layout", ["fft", "direct"])
@pytest.mark.parametrize("n", [8, 2, 19])
def test_pad_gallery_cache_matches_jax(layout, n):
    gal, gv, *_ = _direct_inputs()
    if layout == "fft":
        jc, _ = jncc.build_gallery_cache(jnp.asarray(gal), jnp.asarray(gv), (6, 6))
        tc, _ = tncc.build_gallery_cache(torch.from_numpy(gal), torch.from_numpy(gv), (6, 6))
    else:
        jc = jnd.build_direct_cache(jnp.asarray(gal), jnp.asarray(gv))
        tc = tnd.build_direct_cache(torch.from_numpy(gal), torch.from_numpy(gv))
    jp, jg = jmesh.pad_gallery_cache(jc, n)
    tp, tg = tmesh.pad_gallery_cache(tc, n)
    assert jg == tg == 19 and type(tp) is type(tc)
    for name, want in jp._asdict().items():
        got = getattr(tp, name).numpy()
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        g = 19 if name == "valid_hw" else None
        pad = (slice(g, None),) if name == "valid_hw" else (slice(None), slice(19, None))
        np.testing.assert_array_equal(got[pad], want[pad])  # the pads: zeros, valid 8
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (tp.valid_hw[19:] == tmesh.PAD_VALID).all()


# --- (b) the FFT scorer --------------------------------------------------------

@pytest.mark.parametrize("case", [19, 6])
def test_fft_sharded_scorer_matches_jax(case):
    gal, gv, tm, tv, c, canvas, n = _fft_inputs(case)
    jc, _ = jncc.build_gallery_cache(jnp.asarray(gal), jnp.asarray(gv), canvas, channel_block=4)
    jmesh_n = jmesh.build_mesh(n)
    js, jg = jsharded.shard_cache(jc, jmesh_n)
    jt = np.zeros((len(tm), jc.phat.shape[0], *tm.shape[2:]), np.float32)
    jt[:, :c] = tm
    want = np.asarray(jsharded.make_sharded_scorer(
        jmesh_n, js, true_channels=c, channel_block=4, g_true=jg)(jnp.asarray(jt), jnp.asarray(tv)))

    tc, _ = tncc.build_gallery_cache(torch.from_numpy(gal), torch.from_numpy(gv), canvas)
    mesh = _cpu_mesh(n)
    shards, g_true = tsharded.shard_cache(tc, mesh)
    assert g_true == len(gal) and len(shards) == n
    assert all(s.valid_hw.shape[0] == -(-len(gal) // n) for s in shards)
    got = tsharded.make_sharded_scorer(mesh, shards, true_channels=c, g_true=g_true)(
        torch.from_numpy(tm), tv).numpy()
    unsharded = tncc.score_templates(tc, torch.from_numpy(tm), tv, true_channels=c).numpy()
    assert got.shape == want.shape == (len(tm), len(gal))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, unsharded, atol=1e-6, rtol=0)
    _ranks_equal(got, want)

    # the pad prints of the last shard score exactly 0
    pad_scores = tsharded.make_sharded_scorer(mesh, shards, true_channels=c)(
        torch.from_numpy(tm), tv).numpy()
    assert pad_scores.shape[1] == n * shards[0].valid_hw.shape[0]
    assert (pad_scores[:, len(gal):] == 0).all()

    # shards built from their own slices of the prints equal shard_cache's
    built, g_b = tsharded.build_sharded_cache(
        lambda m, v: tncc.build_gallery_cache(m, v, canvas)[0], torch.from_numpy(gal), gv, mesh)
    assert g_b == g_true
    for a, b in zip(built, shards):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=1e-6, rtol=0)


# --- (c) the probe-sharded stack build -------------------------------------------

def _build_inputs(pb=4, c=3, seed=7):
    rng = np.random.default_rng(seed)
    hc = 12
    q_valid = np.stack([rng.integers(9, hc + 1, pb), rng.integers(9, hc + 1, pb)], 1).astype(np.int32)
    maps = np.zeros((pb, c, hc, hc), np.float32)
    for i, (h, w) in enumerate(q_valid):
        maps[i, :, :h, :w] = rng.normal(size=(c, h, w))
    plan = variant_plan(q_valid, (hc, hc), [-9.0, 9.0, 180.0], [1.04, 1.08])
    include, counts = variant_classes("reference", plan.n_rot, plan.n_scl)
    kernel_hw = (plan.template_canvas[0] - 4, plan.template_canvas[1] - 4)
    tables = [torch.from_numpy(np.asarray(a)) for a in
              (maps, q_valid, plan.rot_idx, plan.rot_ok, plan.wv, plan.wh, plan.scale_hw)]
    fn = partial(build_kernels, kernel_hw=kernel_hw, include_rots_unscaled=include,
                 n_scl=plan.n_scl)
    return fn, tables, counts


@pytest.mark.parametrize("n", [2, 4])
def test_probe_sharded_build_is_bit_identical(n):
    fn, tables, counts = _build_inputs(pb=4)
    want = fn(*tables)
    windows = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    got = tsharded.make_sharded_packed_builder(_cpu_mesh(n), fn, counts, 4)(*tables, windows)
    assert got.window_hw is windows
    assert got.kernels.shape == want.shape and torch.equal(got.kernels, want)


def test_probe_sharded_build_refuses_a_batch_off_the_mesh():
    fn, _, counts = _build_inputs(pb=3)
    with pytest.raises(ValueError, match="not divisible"):
        tsharded.make_sharded_packed_builder(_cpu_mesh(2), fn, counts, 3)


# --- (d) the packed and direct scorers ---------------------------------------------

def _folded(tm, tv, kernel_hw=(6, 6)):
    """The marks folded by the JAX package (one stack, one class: pb = 3)
    and their post-crop windows, the operands both scorers take."""
    jk = np.stack([np.asarray(jnd.fold_template(jnp.asarray(tm[i]), jnp.asarray(tv[i]), kernel_hw))
                   for i in range(len(tm))])
    return jk, (tv - 4).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_packed_scorer_matches_jax(dtype, use_kernel):
    gal, gv, tm, tv, c = _direct_inputs()
    jk, wins = _folded(tm, tv)
    jlayout = jnd.VariantLayout((1,), len(tm))
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jc = jnd.build_direct_cache(jnp.asarray(gal), jnp.asarray(gv))
    jm = jmesh.build_mesh(8)
    js, jg = jsharded.shard_cache(jc, jm)
    uniq, inv = np.unique(wins, axis=0, return_inverse=True)
    want = np.asarray(jsharded.make_sharded_packed_scorer(
        jm, js, true_channels=c, layout=jlayout, g_true=jg, compute_dtype=jdtype)(
        jnd.PackedVariants(jnp.asarray(jk), jnp.asarray(wins)),
        jnp.asarray(uniq.astype(np.int32)), jnp.asarray(inv.astype(np.int32))))

    tdtype = getattr(torch, dtype)
    tc = tnd.build_direct_cache(torch.from_numpy(gal), torch.from_numpy(gv))
    mesh = _cpu_mesh(8)
    shards, g_true = tsharded.shard_cache(tc, mesh)
    layout = tnd.VariantLayout((1,), len(tm))
    packed = tnd.PackedVariants(torch.from_numpy(jk), torch.from_numpy(wins))
    slots = (torch.from_numpy(uniq.astype(np.int32)), torch.from_numpy(inv.reshape(-1)))
    scorer = tsharded.make_sharded_packed_scorer(
        mesh, shards, true_channels=c, layout=layout, g_true=g_true, use_kernel=use_kernel,
        compute_dtype=tdtype)
    got = scorer(packed, *slots).numpy()
    unsharded = tnd.score_direct(tc, packed, layout, c, *slots, compute_dtype=tdtype).numpy()
    assert got.shape == want.shape == (len(tm), len(gal))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, unsharded, atol=1e-6, rtol=0)
    _ranks_equal(got, want)
    # without g_true the pad columns come back, exactly 0
    full = tsharded.make_sharded_packed_scorer(mesh, shards, true_channels=c, layout=layout,
                                               compute_dtype=tdtype)(packed, *slots).numpy()
    assert full.shape[1] == 24 and (full[:, 19:] == 0).all()


def test_sharded_direct_scorer_matches_jax():
    """``tests/test_sharded.py``'s direct case: 13 prints on 8 shards, three
    one-template groups through JAX's list form of ``score_direct``; the
    port scores the same templates as a packed stack, one class a
    template, through the plain sharded scorer."""
    rng = np.random.default_rng(2)
    c = 3
    prints = [rng.normal(size=(c, int(rng.integers(12, 18)), int(rng.integers(12, 18))))
              .astype(np.float32) for _ in range(13)]
    gal, gv = _pad_stack(prints, (18, 18))
    marks = [rng.normal(size=(c, 10, 10)).astype(np.float32) for _ in range(3)]
    tm, tv = _pad_stack(marks, (10, 10))
    jc = jnd.build_direct_cache(jnp.asarray(gal), jnp.asarray(gv), channel_block=3)
    jgroups = [jnd.VariantGroup(jnd.fold_template(jnp.asarray(tm[i]), jnp.asarray(tv[i]), (6, 6))[None],
                                jnp.asarray(tv[i] - 4)) for i in range(3)]
    jm = jmesh.build_mesh(8)
    js, jg = jsharded.shard_cache(jc, jm)
    want = np.asarray(jsharded.make_sharded_direct_scorer(jm, js, true_channels=c, g_true=jg)(jgroups))

    tc = tnd.build_direct_cache(torch.from_numpy(gal), torch.from_numpy(gv))
    folded = tnd.fold_template(torch.from_numpy(tm), torch.from_numpy(tv), (6, 6))
    packed = tnd.PackedVariants(folded, torch.from_numpy(tv - 4).to(torch.int32))
    layout = tnd.VariantLayout((1, 1, 1), 1)
    mesh = _cpu_mesh(8)
    shards, g_true = tsharded.shard_cache(tc, mesh)
    assert g_true == 13
    got = tsharded.make_sharded_packed_scorer(mesh, shards, true_channels=c, layout=layout,
                                              g_true=g_true)(packed).numpy()
    unsharded = tnd.score_direct(tc, packed, layout, c).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(unsharded, np.asarray(jnd.score_direct(jc, jgroups, true_channels=c)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, unsharded, atol=1e-6, rtol=0)
    _ranks_equal(got, want)


# --- (e) the whole slice ----------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """``test_torch_pipeline.py``'s dataset and replica checkpoint."""
    root = tmp_path_factory.mktemp("torch_sharded")
    _make_dataset(root / "data", np.random.default_rng(11))
    model = replica_v2m(seed=0)
    model.features = model.features[:START_BLOCK]
    (root / "weights").mkdir()
    np.savez(root / "weights" / "EfficientNetV2_M.npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})
    return root


# case -> (extra [tpu] lines, the port's mesh, SIR_FORCE_SHARDED for the JAX
# engine, gallery blocks a cluster, the port's mesh runs over the two clusters)
PIPELINE_CASES = {
    "mesh8": ("mesh_shape = 8\n", 8, False, 1, {"extract:8": 4, "score:8": 2}),
    "mesh2_blocks": ("mesh_shape = 2\ngallery_block = 3\n", 2, False, 2,
                     {"extract:2": 4, "score:2": 2}),
    "fft_mesh2": ('mesh_shape = 2\nncc_backend = "fft"\n', 2, False, 1,
                  {"extract:2": 4, "fft:2": 2}),
    "pruned_mesh2": ("mesh_shape = 2\npruned_scoring = true\n", 2, False, 3,
                     {"extract:2": 4, "score:2": 6}),
    "forced_mesh1": ("mesh_shape = 1\n", 1, True, 1, {}),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_sharded_pipeline_matches_jax(fixture_root, monkeypatch, case):
    extra, n, force, blocks, runs = PIPELINE_CASES[case]
    if force:
        monkeypatch.setenv("SIR_FORCE_SHARDED", "1")
    cfg = fixture_root / f"run_{case}.toml"  # beside weights/, where _jax_run looks
    cfg.write_text(RUN_TOML.format(dir=fixture_root / "data", start=START_BLOCK) + extra)
    jp, j_out, j_scores = _jax_run(cfg)
    tp = TPipeline(tload(cfg), weights_dir=str(fixture_root / "weights"), verbose=False,
                   device="cpu", mesh_devices=["cpu"] * 8)
    t_out = list(tp.run())
    assert tp._mesh_size() == n and dict(tp.mesh_runs) == runs
    assert tp.gallery_blocks_scored == blocks * len(t_out)
    assert len(t_out) == len(j_out) == 2
    for i, (t, j) in enumerate(zip(t_out, j_out)):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        assert t.matching_pairs == j.matching_pairs
        if case == "pruned_mesh2":
            assert t.scores is None
        else:
            np.testing.assert_allclose(t.scores, j_scores[i], atol=1e-5, rtol=0)
            assert np.isfinite(t.scores).all() and (t.scores >= 0).all()
    n_g, n_q = len(jp.dataset.gallery_files), len(jp.dataset.query_files)
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        for j in j_out:
            jcmp(j.ranks.tolist(), n_g, n_q)
    with redirect_stdout(got):
        for t in t_out:
            tcmp(t.ranks.tolist(), n_g, n_q)
    assert _s_lines(got.getvalue()) == _s_lines(want.getvalue()) != []


def test_mesh_devices_must_start_with_the_pipeline_device(fixture_root, tmp_path):
    cfg = tmp_path / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=fixture_root / "data", start=START_BLOCK))
    with pytest.raises(ValueError, match="mesh_devices"):
        TPipeline(tload(cfg), weights_dir=None, verbose=False, device="cpu",
                  mesh_devices=["meta", "cpu"])
    tp = TPipeline(tload(cfg), weights_dir=None, verbose=False, device="cpu")
    assert tp._mesh_size() == 1 and tp._mesh().devices == (CPU,)  # mesh_shape = 0: the CPU
    tp.config["tpu"]["mesh_shape"] = 4
    assert tp._mesh_size() == 1  # clamped to the devices there are


# --- (f) sizing on a mesh -----------------------------------------------------------

def _jax_rounding(n_q, g_total, pb_cfg, gb_cfg, n):
    """The JAX engine's mesh rounding of a set probe batch and gallery block
    (engine.py:1134-1161)."""
    gb = min(gb_cfg or g_total, g_total)
    if n > 1:
        gb = -(-gb // n) * n
    pb = max(1, min(n_q, pb_cfg))
    if n > 1 and pb >= n:
        pb = pb // n * n
    return pb, gb


@pytest.mark.parametrize("n_q,g_total,pb_cfg,gb_cfg,n", [
    (30, 300, 56, 0, 8), (30, 300, 7, 128, 4), (5, 8, 2, 3, 8), (5, 8, 2, 3, 2),
    (1000, 10240, 56, 2048, 3), (9, 19, 9, 0, 8), (3, 7, 3, 0, 2), (40, 300, 56, 0, 1)])
def test_mesh_sizing_matches_jax(tmp_path, n_q, g_total, pb_cfg, gb_cfg, n):
    pipe = bench.engine_pipeline(tmp_path, pb_cfg, CPU, mesh_devices=[CPU] * 8)
    pipe.config["tpu"]["gallery_block"] = gb_cfg
    pipe.config["tpu"]["mesh_shape"] = n
    w = bench.make_workload(q=1)
    c, hraw, hc = w["gal"].shape[1], w["gal"].shape[-1], w["canvas"]
    plan = variant_plan(w["q_sizes"], (hc, hc), bench.ROTATIONS, bench.SCALES)
    n_var = sum(variant_classes("reference", plan.n_rot, plan.n_scl)[1])
    got = pipe._probe_batch_and_block(n_q, g_total, c, (hc, hc), (hraw, hraw), plan, n_var, None)
    assert got == _jax_rounding(n_q, g_total, pb_cfg, gb_cfg, n)
    pipe.close()


@pytest.mark.parametrize("g_total,room", [(300, 20 * 10**9), (10240, 12 * 10**9)])
def test_mesh_sizing_takes_the_tightest_device_less_the_margin(tmp_path, monkeypatch, g_total,
                                                               room):
    """``probe_batch = 0`` on a card: a mesh of 3 with 2.5 GB more free than
    one device solves as that device does (the JAX engine's mesh margin),
    then rounds the block up and the batch down to multiples of 3."""
    free = {"bytes": 0}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free["bytes"], 85 * 10**9))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    w = bench.make_workload(q=1)
    c, hraw, hc = w["gal"].shape[1], w["gal"].shape[-1], w["canvas"]
    plan = variant_plan(w["q_sizes"], (hc, hc), bench.ROTATIONS, bench.SCALES)
    n_var = sum(variant_classes("reference", plan.n_rot, plan.n_scl)[1])
    args = (1000, g_total, c, (hc, hc), (hraw, hraw), plan, n_var, 64)
    picks = {}
    for n, extra in ((1, 0), (3, int(2.5e9))):
        root = tmp_path / str(n)
        root.mkdir()
        pipe = bench.engine_pipeline(root, 0, CPU, mesh_devices=[CPU] * n)
        pipe.config["tpu"]["mesh_shape"] = n
        pipe.device = torch.device("cuda")
        free["bytes"] = room + extra
        picks[n] = pipe._probe_batch_and_block(*args)
        pipe.close()
    (pb1, gb1), (pb3, gb3) = picks[1], picks[3]
    assert gb3 == -(-gb1 // 3) * 3
    assert pb3 <= pb1 and (pb3 % 3 == 0 or pb3 < 3)
    if gb3 == gb1:  # the same block: the same rows, rounded down
        assert pb3 == (pb1 // 3 * 3 if pb1 >= 3 else pb1)


def test_bench_sharded_quick_on_cpu(capsys):
    """``bench_sharded --quick --device cpu``: one JSON line; 1 / 2 / 4 / 8
    shards of one call against the unsharded call, with the JAX bench's
    gather bytes and each point's bound."""
    import json

    from shoeprint_image_retrieval_torch.benchmarks import bench_sharded

    result = bench_sharded.main(["--quick", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(result))
    assert result["metric"] == "sharded_scorer" and result["device"] == "cpu"
    sc = result["scaling"]
    assert [p["shards"] for p in sc["points"]] == list(bench_sharded.SHARDS)
    for p in sc["points"]:
        n, g_shard = p["shards"], p["prints_per_shard"]
        assert g_shard == -(-sc["prints"] // n) and p["max_abs_diff"] == 0.0
        assert p["gather_bytes_per_device"] == sc["rows"] * g_shard * 4 * (n - 1)
        assert p["launches"] == 0 and p["bound_ms"] > 0  # no kernel on the CPU


# --- (g) the dryrun -------------------------------------------------------------------

def test_dryrun_multichip_on_four_cpu_devices():
    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["score_err"] <= 1e-6 and out["feature_err"] <= 1e-4
    assert out["gallery_blocks"] == 2 and len(out["ranks"]) == 6

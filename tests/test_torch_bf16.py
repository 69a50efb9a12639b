"""``tpu.precision`` and ``tpu.cache_dtype = "bfloat16"``: the port against the JAX package.

* the plain scorer with bf16 operands (``score_direct(compute_dtype=
  torch.bfloat16)``) against JAX ``ops/ncc_direct.score_direct(
  compute_dtype=jnp.bfloat16)`` and, at a tiny size, against the Pallas
  kernel in interpret mode with the same compute dtype: within 1e-5 (the
  operands round alike, to nearest even, and their products are exact in
  f32, so only the sums' order differs), ranks identical;
* the port's Pipeline against the JAX one on the half-size dataset of
  ``tests/test_torch_reanchor.py``, with ``precision = "bfloat16"`` and with
  ``cache_dtype = "bfloat16"`` on gallery maps at rest on the host
  (``SIR_DEVICE_MAPS_MAX = 0`` and ``gallery_block = 3`` in both packages):
  ranks and S-lines identical, scores within 1e-5 with ``cache_dtype`` and
  5e-5 with ``precision`` (:data:`PIPELINE_TOL`), and in every cluster the
  port's bf16 scores more than :data:`GAP` times that from its f32 run's, so
  the comparison is tighter than the effect it checks;
* ``cache_dtype = "bfloat16"``'s maps at rest: one bf16 tensor, scored as
  its values widened to f32;
* the bf16 conv route (``models/layers.bf16_conv``) called on the CPU, where
  the engine's convs stay f32 as XLA:CPU's do, and the binding of the
  precision on the models that the cluster lookahead's thread runs.
"""

import functools
import io
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shoeprint_image_retrieval_tpu.metrics import cmp_all as jcmp
from shoeprint_image_retrieval_tpu.ops import ncc_direct as jnd
from shoeprint_image_retrieval_tpu.ops.pallas.ncc_kernel import score_direct_pallas
from shoeprint_image_retrieval_torch import bench
from shoeprint_image_retrieval_torch.config import check_supported
from shoeprint_image_retrieval_torch.config import load_config as tload
from shoeprint_image_retrieval_torch.metrics import cmp_all as tcmp
from shoeprint_image_retrieval_torch.models import layers
from shoeprint_image_retrieval_torch.ops import ncc_direct as tnd
from shoeprint_image_retrieval_torch.ops.ncc_kernel import score_ncc
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline as TPipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_ncc import _caches, _fold_both, _random_case  # noqa: E402
from test_torch_pipeline import (  # noqa: E402
    RUN_TOML, START_BLOCK, _export, _jax_run, _make_dataset, _s_lines)
from torch_effnet_replica import replica_v2m  # noqa: E402

SCORE_TOL = 1e-5  # float32 sums of exact products of bf16 values, in another order
# Whole pipelines with precision = "bfloat16": the variant stacks the two
# packages round to bf16 already differ in float32 (their scale resamples by
# up to 1e-5, tests/test_torch_variants.py), and a value that close to a
# bf16 rounding boundary rounds one bf16 ulp (2^-8 relative) apart in the
# two. On the same operands the scorers agree to SCORE_TOL (the tests
# above); here the scores moved up to 2.9e-5 with ranks and S-lines
# unchanged. With cache_dtype only the gallery maps are rounded, and the
# packages' features agree to ~5e-7: SCORE_TOL holds.
PIPELINE_TOL = 5e-5
GAP = 4  # each cluster's bf16-vs-f32 score gap exceeds GAP x the tolerance
CONV_TOL = 1e-2   # the bf16 conv route against f32, relative to the activation scale

_jax_score_direct = jax.jit(
    functools.partial(jnd.score_direct, channel_block=1, compute_dtype=jnp.bfloat16),
    static_argnames=("true_channels", "layout"),
)


def _plain_pair(seed, **case):
    """(JAX bf16 scores, the port's bf16 scores, the port's f32 scores)."""
    counts, pb = case.pop("counts", (1, 3)), case.pop("pb", 2)
    gal, gv, tm, tv, windows = _random_case(seed, counts=counts, pb=pb, **case)
    c = gal.shape[1]
    jc, tc = _caches(gal, gv)
    kernels, _ = _fold_both(tm, tv, (tm.shape[2] - 4, tm.shape[3] - 4))
    want = np.asarray(_jax_score_direct(
        jc, jnd.PackedVariants(jnp.asarray(kernels), jnp.asarray(windows)),
        true_channels=c, layout=jnd.VariantLayout(counts, pb)))
    packed = tnd.PackedVariants(torch.from_numpy(kernels), torch.from_numpy(windows))
    layout = tnd.VariantLayout(counts, pb)
    got = tnd.score_direct(tc, packed, layout, c, compute_dtype=torch.bfloat16).numpy()
    f32 = tnd.score_direct(tc, packed, layout, c).numpy()
    # the kernel's wrapper takes the plain version for CPU tensors, in the same dtype
    wrapped = score_ncc(tc, packed, layout, c, compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(wrapped, got)
    return want, got, f32


@pytest.mark.parametrize("seed,counts,pb", [(0, (1, 3), 2), (1, (2, 2, 1), 3)])
def test_plain_bf16_scorer_matches_jax_score_direct(seed, counts, pb):
    want, got, f32 = _plain_pair(seed, counts=counts, pb=pb)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    np.testing.assert_array_equal(np.argsort(-got, axis=1, kind="stable"),
                                  np.argsort(-want, axis=1, kind="stable"))
    assert np.abs(got - f32).max() > 1e-4  # the operands were rounded


def test_plain_bf16_scorer_matches_pallas_interpret():
    """One tiny shape through the Pallas kernel with ``compute_dtype =
    bfloat16``, run as the JAX package's tests run it on the CPU."""
    gal, gv, tm, tv, windows = _random_case(5, c=3, n_prints=3, pb=1, counts=(2, 1),
                                            canvas=(20, 20), kernel_hw=(8, 8))
    jc, tc = _caches(gal, gv)
    kernels, _ = _fold_both(tm, tv, (8, 8))
    want = np.asarray(score_direct_pallas(
        jc, jnd.PackedVariants(jnp.asarray(kernels), jnp.asarray(windows)),
        true_channels=3, layout=jnd.VariantLayout((2, 1), 1), interpret=True,
        compute_dtype=jnp.bfloat16))[:, : len(gal)]
    packed = tnd.PackedVariants(torch.from_numpy(kernels), torch.from_numpy(windows))
    got = tnd.score_direct(tc, packed, tnd.VariantLayout((2, 1), 1), 3,
                           compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    np.testing.assert_array_equal(np.argsort(-got, axis=1), np.argsort(-want, axis=1))


def test_unknown_precisions_raise():
    gal, gv, tm, tv, windows = _random_case(2, c=2, n_prints=2, pb=1, counts=(1,))
    tc = tnd.build_direct_cache(torch.from_numpy(gal), torch.from_numpy(gv))
    kernels = tnd.fold_template(torch.from_numpy(tm), torch.from_numpy(tv), (12, 12))
    packed = tnd.PackedVariants(kernels, torch.from_numpy(windows))
    layout = tnd.VariantLayout((1,), 1)
    with pytest.raises(ValueError, match="compute_dtype"):
        tnd.score_direct(tc, packed, layout, 2, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        score_ncc(tc, packed, layout, 2, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="precision"):
        layers.conv_route("float16", torch.device("cpu"))
    for key in ("precision", "cache_dtype"):
        cfg = tload("run.toml")
        cfg["tpu"][key] = "float16"
        with pytest.raises(LookupError):
            check_supported(cfg)


def test_bf16_conv_route_on_the_cpu():
    """The bf16 route called on the CPU: within 1e-2 of the f32 conv's
    activation scale and not equal to it; the engine's conv on the CPU stays
    f32 under ``precision = "bfloat16"``, as XLA:CPU computes DEFAULT."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 24, 17, 19)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 24, 3, 3)).astype(np.float32) / 15)
    b = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    valid = torch.tensor([[17, 19], [11, 13]], dtype=torch.int32)
    want = F.conv2d(x, w, b, padding=1)
    got = layers.bf16_conv(x, w, b, padding=1)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert got.dtype == torch.float32
    assert 0 < err <= CONV_TOL * scale, (err, scale)
    assert layers.conv_route("bfloat16", torch.device("cpu")) == "f32"
    assert layers.conv_route("bfloat16", torch.device("cuda")) == "bf16"
    assert layers.conv_route("float32", torch.device("cuda")) == "f32"
    f32, _ = layers.conv2d(x, w, b, valid, padding=1)
    cpu_bf16, _ = layers.conv2d(x, w, b, valid, padding=1, precision="bfloat16")
    assert torch.equal(cpu_bf16, f32)
    # grouped (depthwise) convs take the route too
    wd = torch.from_numpy(rng.normal(size=(24, 1, 3, 3)).astype(np.float32))
    want_d = F.conv2d(x, wd, None, padding=1, groups=24)
    got_d = layers.bf16_conv(x, wd, None, padding=1, groups=24)
    assert 0 < float((got_d - want_d).abs().max()) <= CONV_TOL * float(want_d.abs().max())


def test_maps_at_rest_cast_once_to_bf16(tmp_path):
    """``cache_dtype = "bfloat16"`` on the CPU: maps at rest (NumPy arrays)
    become one bf16 tensor, which scores as its values widened to f32; maps
    on the device, and the FFT backend's maps, stay as they are."""
    w = bench.make_workload(quick=True)
    q = torch.from_numpy(bench.draw_probe_maps(w))
    pipe = bench.engine_pipeline(tmp_path, w["pb"], torch.device("cpu"))
    assert pipe._maps_at_rest(w["gal"]) is w["gal"]  # cache_dtype float32
    pipe.config["tpu"]["cache_dtype"] = "bfloat16"
    rest = pipe._maps_at_rest(w["gal"])
    assert rest.dtype == torch.bfloat16
    on_device = torch.from_numpy(w["gal"])
    assert pipe._maps_at_rest(on_device) is on_device
    got = pipe._score_cluster(q, w["q_sizes"], rest, w["g_sizes"])
    np.testing.assert_array_equal(
        got, pipe._score_cluster(q, w["q_sizes"], rest.float(), w["g_sizes"]))
    assert np.abs(got - pipe._score_cluster(q, w["q_sizes"], on_device, w["g_sizes"])).max() > 0
    pipe.config["tpu"]["ncc_backend"] = "fft"
    assert pipe._maps_at_rest(w["gal"]) is w["gal"]
    pipe.close()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("bf16_weights")
    replica = replica_v2m(seed=0)
    replica.features = replica.features[:START_BLOCK]
    _export(replica, wdir / "EfficientNetV2_M.npz")
    return wdir


def _config(tmp_path: Path, weights: Path, extra: str, half: bool = True) -> Path:
    """The half-size dataset of ``test_torch_reanchor.py`` (or the full-size
    one of ``test_torch_pipeline.py``) and its run.toml with ``extra`` in
    ``[tpu]``."""
    data = tmp_path / "data"
    if half:
        _make_dataset(data, np.random.default_rng(12), n_gallery=7, n_query=4, size=0.5)
    else:
        _make_dataset(data, np.random.default_rng(11))
    text = RUN_TOML.format(dir=data, start=START_BLOCK) + extra
    if half:
        text = text.replace("minimum_dim = 40", "minimum_dim = 20")
    cfg = tmp_path / "run.toml"
    cfg.write_text(text)
    (tmp_path / "weights").symlink_to(weights, target_is_directory=True)
    return cfg


def _held_against_jax(cfg: Path, weights: Path, tol: float):
    """Both Pipelines on ``cfg``: plans, ranks and S-lines identical, scores
    within ``tol``; -> the port's outputs."""
    jp, j_out, j_scores = _jax_run(cfg)
    tp = TPipeline(tload(cfg), weights_dir=str(weights), verbose=False, device="cpu")
    t_out = list(tp.run())
    assert len(t_out) == len(j_out) >= 1
    assert [(p.files, p.scale, p.block) for p in tp.plans] == [
        (p.files, p.scale, p.block) for p in jp.plans]
    for t, j, js in zip(t_out, j_out, j_scores):
        np.testing.assert_array_equal(t.ranks, j.ranks)
        assert t.matching_pairs == j.matching_pairs
        np.testing.assert_allclose(t.scores, js, atol=tol, rtol=0)
    n_g, n_q = len(jp.dataset.gallery_files), len(jp.dataset.query_files)
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        for j in j_out:
            jcmp(j.ranks.tolist(), n_g, n_q)
    with redirect_stdout(got):
        for t in t_out:
            tcmp(t.ranks.tolist(), n_g, n_q)
    assert _s_lines(got.getvalue()) == _s_lines(want.getvalue()) != []
    return tp, t_out


def test_port_matches_jax_pipeline_precision_bf16(tmp_path, weights):
    cfg = _config(tmp_path, weights, 'precision = "bfloat16"\n')
    tp, t_out = _held_against_jax(cfg, weights, PIPELINE_TOL)
    f32 = TPipeline(tload(cfg), weights_dir=str(weights), verbose=False, device="cpu")
    f32.config["tpu"]["precision"] = "float32"
    f32_out = list(f32.run())
    # the scorer's operands were rounded (the CPU's convs are f32 in both),
    # by more than the comparison with JAX lets through
    for t, f in zip(t_out, f32_out):
        assert np.abs(t.scores - f.scores).max() > GAP * PIPELINE_TOL
    assert set(tp.conv_routes) == {"bfloat16:f32"}


def test_port_matches_jax_pipeline_cache_dtype_bf16(tmp_path, weights, monkeypatch):
    """Gallery maps over the (zero) budget are at rest on the host in both
    packages, so both round them to bf16 before the cache is built."""
    monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", "0")
    cfg = _config(tmp_path, weights, 'cache_dtype = "bfloat16"\ngallery_block = 3\n')
    tp, t_out = _held_against_jax(cfg, weights, SCORE_TOL)
    assert tp.gallery_blocks_scored > len(t_out)  # more than one block a cluster
    f32 = TPipeline(tload(cfg), weights_dir=str(weights), verbose=False, device="cpu")
    f32.config["tpu"]["cache_dtype"] = "float32"
    f32_out = list(f32.run())
    # the host maps really were rounded, by more than the comparison with
    # JAX lets through
    for t, f in zip(t_out, f32_out):
        assert np.abs(t.scores - f.scores).max() > GAP * SCORE_TOL
    # under the budget the maps stay on the device and are not rounded
    monkeypatch.setenv("SIR_DEVICE_MAPS_MAX", str(int(2e9)))
    kept = TPipeline(tload(cfg), weights_dir=str(weights), verbose=False, device="cpu")
    for k, f in zip(kept.run(), f32_out):
        np.testing.assert_array_equal(k.scores, f.scores)


def test_lookahead_thread_extracts_with_the_bound_precision(tmp_path, weights, monkeypatch):
    """Two clusters with ``pipeline_clusters = true``: the lookahead thread
    extracts the second cluster with the models bound to bfloat16, and the
    pipeline's record counts the route of every extraction."""
    cfg = _config(tmp_path, weights, 'precision = "bfloat16"\npipeline_clusters = true\n'
                  'prewarm = false\n', half=False)
    seen = []
    real = TPipeline._run_extraction

    def record(self, model, *args, **kwargs):
        seen.append((threading.current_thread().name, model.conv_precision))
        return real(self, model, *args, **kwargs)

    monkeypatch.setattr(TPipeline, "_run_extraction", record)
    tp = TPipeline(tload(cfg), weights_dir=str(weights), verbose=False, device="cpu")
    outs = list(tp.run())
    assert len(outs) == len(tp.plans) == 2
    workers = [p for name, p in seen if name.startswith("shoeprint-lookahead")]
    assert workers and set(workers) == {"bfloat16"}
    assert {p for _, p in seen} == {"bfloat16"}
    assert tp.conv_routes == {"bfloat16:f32": len(seen)}
    assert tp.lookahead_seconds

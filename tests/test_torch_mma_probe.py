"""The probe kernel's plain version against the JAX probe body's arithmetic.

``benchmarks/mxu_probe.py::probe_pallas`` cannot run on a CPU: it takes no
interpret flag, and its TPU grid spec and VMEM scratch need the chip. That
file is not edited, so this test rebuilds its ``body`` in ``jnp``:
``acc += jnp.dot(a, b, preferred_element_type=f32)`` ``y_iters`` times at
HIGHEST precision. (The TPU body never zeroes its scratch and carries it
across grid steps into one output block; the port gives every grid step its
own slice, summed from zero, so each step is compared with one body run.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_torch.benchmarks.mxu_probe import probe_inputs
from shoeprint_image_retrieval_torch.ops import mma_probe as mp

N, K, LANES, Y_ITERS, GRID = 24, 37, 16, 3, 2
TOL = 1e-5  # relative to max |out|: f32 sums of 37 products in another order


def jax_body(a: np.ndarray, b: np.ndarray, y_iters: int) -> np.ndarray:
    """One grid step of probe_pallas's body, from a zero accumulator."""
    aj, bj = jnp.asarray(a), jnp.asarray(b)

    def step(acc, _):
        return acc + jnp.dot(aj, bj, preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST), None

    acc, _ = jax.lax.scan(step, jnp.zeros((a.shape[0], b.shape[1]), jnp.float32), None,
                          length=y_iters)
    return np.asarray(acc)


@pytest.mark.parametrize("precision,jdtype", [("f32", jnp.float32), ("f32_3xtf32", jnp.float32),
                                              ("bf16", jnp.bfloat16)])
def test_plain_matches_jax_body(precision, jdtype):
    a, b = probe_inputs(N, K, LANES, precision, torch.device("cpu"))
    # the same values in the JAX leg's dtype (bf16 -> f32 is exact)
    a_np, b_np = a.float().numpy(), b.float().numpy()
    want = jax_body(a_np.astype(jdtype), b_np.astype(jdtype), Y_ITERS)
    got = mp.probe_plain(a, b, Y_ITERS, GRID).numpy()
    assert got.shape == (GRID, N, LANES) and got.dtype == np.float32
    for s in range(GRID):
        assert np.abs(got[s] - want).max() <= TOL * np.abs(want).max()


def test_bf16_leg_computes_on_rounded_inputs():
    """The bf16 leg is the f32 product of the bf16-rounded inputs."""
    a32, b32 = probe_inputs(N, K, LANES, "f32", torch.device("cpu"))
    a16, b16 = probe_inputs(N, K, LANES, "bf16", torch.device("cpu"))
    assert a16.dtype == torch.bfloat16 and torch.equal(a16, a32.to(torch.bfloat16))
    want = mp.probe_plain(a16.float(), b16.float(), Y_ITERS, GRID)
    assert torch.equal(mp.probe_plain(a16, b16, Y_ITERS, GRID), want)
    assert not torch.equal(mp.probe_plain(a32, b32, Y_ITERS, GRID), want)


def test_wrapper_routes_cpu_tensors_to_plain():
    a, b = probe_inputs(N, K, LANES, "f32", torch.device("cpu"))
    before = mp.launch_mma.launches
    for precision in ("f32", "f32_3xtf32"):
        got = mp.mma_probe(a, b, Y_ITERS, GRID, precision)
        assert torch.equal(got, mp.probe_plain(a, b, Y_ITERS, GRID))
    assert torch.equal(mp.mma_probe(a, b, 0, GRID, "f32"), torch.zeros(GRID, N, LANES))
    assert mp.launch_mma.launches == before  # no kernel launched for CPU tensors


def test_wrapper_rejects_bad_operands():
    a, b = probe_inputs(N, K, LANES, "f32", torch.device("cpu"))
    with pytest.raises(TypeError):
        mp.mma_probe(a, b, 1, 1, "bf16")              # f32 inputs on the bf16 leg
    with pytest.raises(TypeError):
        mp.mma_probe(a.double(), b.double(), 1, 1, "f32")
    with pytest.raises(ValueError):
        mp.mma_probe(a, b[:-1], 1, 1, "f32")          # (24, 37) @ (36, 16)
    with pytest.raises(ValueError):
        mp.mma_probe(a[0], b, 1, 1, "f32")            # 1-D
    with pytest.raises(ValueError):
        mp.mma_probe(a, b, 1, 0, "f32")               # no grid step
    with pytest.raises(ValueError):
        mp.mma_probe(a, b, 1, 1, "tf32")              # plain TF32 is no leg
    with pytest.raises(ValueError):
        mp.launch_mma(a, b, 1, 1, "f32")              # the kernel takes CUDA tensors only


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("lanes", [16, 130])
@pytest.mark.parametrize("k", [37, 1156])
def test_packing_adds_exact_zeros(k, lanes, precision):
    """The wrapper's packed operands at ragged shapes: K-major, zero past k,
    TMA-legal strides, and the same probe sum bit for bit. The operands are
    small integers, so every sum is exact in f32 and no summation order can
    change a bit (with normal floats MKL's CPU matmul blocks K = 1156 and
    K = 1216 differently, and the plain sums differ in the last bits)."""
    rng = np.random.default_rng(k + lanes)
    dtype = mp.PRECISIONS[precision][1]
    a = torch.from_numpy(rng.integers(-8, 9, size=(70, k)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.integers(-8, 9, size=(k, lanes)).astype(np.float32)).to(dtype)
    a_p, bt_p = mp.pack_operands(a, b, precision)
    kp = mp.padded_depth(k, precision)
    assert kp % mp.k_chunk(precision) == 0 and kp - mp.k_chunk(precision) < k <= kp
    assert a_p.shape == (70, kp) and bt_p.shape == (lanes, kp)
    assert a_p.dtype == bt_p.dtype == dtype
    for t in (a_p, bt_p):
        assert t.stride(0) * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0
        assert not t[:, k:].any()
    assert torch.equal(a_p[:, :k], a) and torch.equal(bt_p[:, :k], b.t())
    mp.check_packed(a_p, bt_p)
    assert torch.equal(mp.probe_plain(a_p, bt_p.t(), 2, 3), mp.probe_plain(a, b, 2, 3))


def test_l2_bytes_against_a_hand_count():
    # n = 200, lanes = 130: row tiles of 128 and 72 rows, lane tiles of 128
    # and 2 lanes; over the 4 tiles the A rows plus B lanes are
    # (128 + 128) + (128 + 2) + (72 + 128) + (72 + 2) = 660. A cluster loads
    # them once for a pair of grid steps: grid 3 -> 2 pairs, grid 2 -> 1.
    # bf16, k = 70: 2 chunks of 64; 660 rows x 128 B x 2 chunks x 3 products x 2 pairs
    assert mp.l2_bytes(200, 70, 130, 3, 3, "bf16") == 660 * 128 * 2 * 3 * 2 == 1_013_760
    assert mp.l2_bytes(200, 70, 130, 3, 2, "bf16") == 660 * 128 * 2 * 3 * 1
    # 3xTF32: 3 chunks of 32 f32 (k = 70 -> 96), two planes
    assert mp.l2_bytes(200, 70, 130, 3, 3, "f32_3xtf32") == 660 * 128 * 2 * 3 * 3 * 2
    assert mp.l2_bytes(200, 70, 130, 3, 3, "f32") == 660 * 128 * 3 * 3 * 2
    # the probe's default: 512 rows, 1156 deep (19 bf16 chunks), 48 products x 50 pairs
    assert mp.l2_bytes(512, 1156, 128, 48, 100, "bf16") == (512 + 4 * 128) * 128 * 19 * 48 * 50
    assert mp.l2_bytes(16, 8, 8, 0, 2, "bf16") == 0


def test_wrapper_refuses_operands_tma_cannot_read():
    a_p, _ = mp.pack_operands(torch.zeros(70, 37), torch.zeros(37, 16), "f32")
    mp.check_packed(a_p)
    flat = torch.zeros(70 * 64 + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mp.check_packed(flat[1:].view(70, 64))        # base 4 bytes past an aligned one
    with pytest.raises(ValueError, match="multiple of 16"):
        mp.check_packed(torch.zeros(70, 37))          # 148-byte rows: the raw f32 a at k = 37
    with pytest.raises(ValueError, match="multiple of 16"):
        mp.check_packed(torch.zeros(1156, 130))       # 520-byte rows: the raw f32 b at lanes = 130
    with pytest.raises(ValueError, match="multiple of 16"):
        mp.check_packed(torch.zeros(70, 1156, dtype=torch.bfloat16))  # 2312-byte rows
    with pytest.raises(ValueError, match="contiguous rows"):
        mp.check_packed(torch.zeros(64, 64).t()[:, :32])


def test_probe_flop_counts_every_product():
    assert mp.probe_flop(512, 1156, 128, 48, 100) == 2 * 512 * 1156 * 128 * 48 * 100
    assert mp.SOURCE.endswith("csrc/mma_probe.cu")
    assert mp.REPLACES == "benchmarks/mxu_probe.py:34"

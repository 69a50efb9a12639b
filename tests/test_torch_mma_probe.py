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


def test_probe_flop_counts_every_product():
    assert mp.probe_flop(512, 1156, 128, 48, 100) == 2 * 512 * 1156 * 128 * 48 * 100
    assert mp.SOURCE.endswith("csrc/mma_probe.cu")
    assert mp.REPLACES == "benchmarks/mxu_probe.py:34"

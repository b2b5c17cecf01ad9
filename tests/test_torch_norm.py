"""The port's rms_norm against the JAX package's, on the CPU (the plain
version, which the kernel csrc/rms_norm.cu is held to on the card).

Same inputs from a seed with numpy, f32 and bf16, with and without Gemma's
one_offset weights. f32: within 2^-20 of each output's magnitude (the mean
of N squares summed in another order; rsqrt's rounding). bf16: at most one
bf16 step of each output (a different f32 rounding of the mean can move the
final rounding across a bf16 boundary), and equal for almost every element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu_torch.models import transformer as tt
from llm_inference_lab_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain


@pytest.mark.parametrize("one_offset", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype, one_offset):
    rng = np.random.default_rng(11)
    N = 1024
    x = (rng.normal(0, 3, (37, N)) + rng.normal(0, 1, (37, 1))).astype(np.float32)
    w = rng.normal(0 if one_offset else 1, 0.1, (N,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jt.rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), 1e-6,
                                 one_offset).astype(jnp.float32))
    got = tt.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), 1e-6,
                      one_offset)
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -20, atol=0)
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= step)
        assert np.mean(got != ref) < 0.01


def test_rms_norm_dispatches_by_device():
    """On a CPU tensor the wrapper is the plain version, bit for bit, and
    counts no launch (the count is for the kernel on the card)."""
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (5, 64)).astype(np.float32))
    w = torch.ones(64)
    before = rms_norm.launches
    assert torch.equal(rms_norm(x.bfloat16(), w.bfloat16(), 1e-5),
                       rms_norm_plain(x.bfloat16(), w.bfloat16(), 1e-5))
    assert rms_norm.launches == before
    assert tt.rms_norm is rms_norm

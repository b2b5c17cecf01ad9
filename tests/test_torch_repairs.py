"""The two repairs that come before the seq, stage and expert axes, held to
the JAX package on the CPU.

int8 weights under the model axis: a row-parallel projection's int8 partial
sum (ops/quant.py dense_f32) is kernel B's f32 instantiation, whose plain
version returns the scaled f32 product unrounded, so the ranks add f32
partials and the sum is rounded once, as JAX's kernel over the whole K
rounds its sum once. Held here to x @ w * scale in f64 within the f32
summation bound (K 2^-24 sum_k |x_k w_kn| scale_n); a partial rounded to
bf16 first (2^-9 of its size) is far outside it.

LayerNorm (GPT-2, OPT): the plain version of the LayerNorm kernels
(ops/rms_norm.py layer_norm_plain, add_layer_norm_plain) against JAX's
models/transformer.py layer_norm on the same bf16 rows: the f32 mean and
variance summed in other orders leave a row's bf16 output equal to JAX's
but for at most one bf16 step on a few elements (measured: 2e-5 to 4e-5 of
them at widths 768 to 2048), or, where w x_hat and b nearly cancel, by the
f32 terms' rounding (1.5e-8 at an output of 1.3e-6); asserted: every element
within one step of the larger magnitude plus 2^-16, and under 1e-3 of them
off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.models.transformer import layer_norm as jax_layer_norm
from llm_inference_lab_tpu_torch.ops.quant import dense_f32, quantize_int4, quantize_int8
from llm_inference_lab_tpu_torch.ops.quant_matmul import unpack_int4
from llm_inference_lab_tpu_torch.ops.rms_norm import add_layer_norm_plain, layer_norm_plain
from test_torch_decode_loop import one_thread  # noqa: F401


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 5, 160])
def test_dense_f32_partial_is_the_unrounded_product(bits, M):
    g = torch.Generator().manual_seed(M + bits)
    K, N = 1024, 384
    w = torch.randn((K, N), generator=g) * 0.05
    qt = quantize_int8(w) if bits == 8 else quantize_int4(w)
    x = torch.randn((M, K), generator=g).bfloat16()
    got = dense_f32(x, qt)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    wint = (qt.data if bits == 8 else unpack_int4(qt.data)).double()
    exact = (x.double() @ wint) * qt.scale.double()
    bound = K * 2.0 ** -24 * (x.double().abs() @ wint.abs()) * qt.scale.double()
    err = (got.double() - exact).abs()
    assert torch.all(err <= bound + 1e-30)
    # A partial rounded to bf16 first would not pass: its error is ~2^-9 of
    # the product, far above the bound.
    rounded = (got.bfloat16().double() - exact).abs()
    assert bool((rounded > bound).any())


def _bf16_rows(N, seed):
    g = np.random.default_rng(seed)
    x = g.normal(0.3, 2.0, (256, N)).astype(np.float32)
    a = g.normal(0.0, 1.0, (256, N)).astype(np.float32)
    w = g.normal(1.0, 0.1, N).astype(np.float32)
    b = g.normal(0.0, 0.1, N).astype(np.float32)
    return [jnp.asarray(v, jnp.bfloat16) for v in (x, a, w, b)]


def _torch(v):
    return torch.from_numpy(np.asarray(v.astype(jnp.float32))).bfloat16()


def _within_one_step(got, want):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    big = np.maximum(np.abs(got), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step + 2.0 ** -16)
    assert np.mean(got != want) < 1e-3


@pytest.mark.parametrize("N", [768, 1024, 2048])
def test_layer_norm_plain_equals_jax(N):
    x, a, w, b = _bf16_rows(N, N)
    _within_one_step(layer_norm_plain(_torch(x), _torch(w), _torch(b), 1e-5),
                     jax_layer_norm(x, w, b, 1e-5))
    s, n = add_layer_norm_plain(_torch(x), _torch(a), _torch(w), _torch(b), 1e-5)
    assert torch.equal(s, _torch(x + a))  # the add in the model dtype, as JAX's
    _within_one_step(n, jax_layer_norm(x + a, w, b, 1e-5))

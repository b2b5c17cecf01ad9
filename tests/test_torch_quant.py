"""Port parity: quantization formats and the int4 dequantizing matmul.

The same numpy inputs (fixed seeds) go through the JAX package and through
llm_inference_lab_tpu_torch on the CPU, where every op runs its plain
PyTorch version. The CUDA kernel itself is held to the plain version on the
card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu.ops.pallas.quant_matmul import quant_matmul_pallas
from llm_inference_lab_tpu_torch.convert import params_from_jax, to_tensor
from llm_inference_lab_tpu_torch.ops import quant as tq
from llm_inference_lab_tpu_torch.ops.quant_matmul import (
    DECODE_BN,
    DECODE_KTILE,
    decode_plan,
    quant_matmul,
    quant_matmul_plain,
)
from test_torch_decode_loop import one_thread  # noqa: F401


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.is_floating_point() else t.numpy()


@pytest.mark.parametrize("shape", [(512, 256), (2, 256, 128)])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_bytes_identical(shape, mode):
    """(a) identical bytes and scales; both round half to even. Stacked
    [L, d_in, d_out] weights quantize per layer (the JAX side vmaps)."""
    w = np.random.default_rng(1).normal(0, 0.02, shape).astype(np.float32)
    # Exact ties at .5 after scaling exercise the half-to-even rounding.
    w.reshape(-1, shape[-1])[0, :4] = [0.5, -0.5, 1.5, -2.5]
    fn = jq.quantize_int8 if mode == "int8" else jq.quantize_int4
    ref = jax.vmap(fn)(jnp.asarray(w)) if len(shape) == 3 else fn(jnp.asarray(w))
    got = tq.quantize(torch.from_numpy(w), mode)
    assert got.data.dtype == torch.int8
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.shape == tuple(ref.shape) if len(shape) == 2 else got.shape == shape


def test_quantize_embed_and_unpack_identical():
    """(a) EmbedQuant bytes/scales, the int4 unpack and dequantize agree
    exactly; the embedding lookup and head match in f32."""
    rng = np.random.default_rng(2)
    e = rng.normal(0, 0.02, (512, 128)).astype(np.float32)
    ref = jq.quantize_embed(jnp.asarray(e))
    got = tq.quantize_embed(torch.from_numpy(e))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    toks = rng.integers(0, 512, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(got.lookup(torch.from_numpy(toks), torch.float32)),
        np.asarray(ref.lookup(jnp.asarray(toks), jnp.float32)))
    x = rng.normal(0, 1, (3, 128)).astype(np.float32)
    # f32 head: same products, summed in another order (rtol 1e-5).
    np.testing.assert_allclose(_np(got.head_logits(torch.from_numpy(x))),
                               np.asarray(ref.head_logits(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    w = rng.normal(0, 0.02, (256, 128)).astype(np.float32)
    qt = jq.quantize_int4(jnp.asarray(w))
    packed = to_tensor(qt.data)
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), np.asarray(jq.unpack_int4(qt.data)))
    np.testing.assert_array_equal(
        _np(tq.dequantize(tq.QuantTensor(packed, torch.from_numpy(np.asarray(qt.scale)), 4),
                          torch.float32)),
        np.asarray(jq.dequantize(qt, jnp.float32)))


@pytest.mark.parametrize("K,N", [(256, 128), (512, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_matches_pallas_and_xla(K, N, dtype):
    """(b) the plain int4 matmul against quant_matmul_pallas(interpret=True)
    and quant_matmul_xla at M in {1, 2, 17}. Tolerances, relative to the
    output's largest magnitude: f32 1e-5 (summation order; the Pallas body
    refactors the nibbles into two dots); bf16 2e-2 (the Pallas prep rounds
    x_lo - x_hi/16 to bf16 and every output rounds to bf16, ~2^-8 each)."""
    rng = np.random.default_rng(K + N)
    w = rng.normal(0, 0.02, (K, N)).astype(np.float32)
    qt = jq.quantize_int4(jnp.asarray(w))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rtol = 1e-5 if dtype == "float32" else 2e-2
    tw = to_tensor(qt.data)
    ts = to_tensor(qt.scale)
    for M in (1, 2, 17):
        x = rng.normal(0, 1, (M, K)).astype(np.float32)
        jx = jnp.asarray(x).astype(jdt)
        got = quant_matmul(to_tensor(jx), tw, ts)
        assert got.dtype == tdt and got.shape == (M, N)
        got = _np(got)
        for ref in (quant_matmul_pallas(jx, qt, interpret=True), jq.quant_matmul_xla(jx, qt)):
            ref = np.asarray(ref.astype(jnp.float32))
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_dense_stacked_layer_view_matches_jax_dense(mode):
    """dense() on a per-layer view of a stacked int4 or int8 weight equals
    the JAX dense() on its QuantStackRef (the same layer of the same bytes).
    f32: rtol 1e-5 (summation order)."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.02, (3, 256, 128)).astype(np.float32)
    qt = jax.vmap(jq.quantize_int4 if mode == "int4" else jq.quantize_int8)(jnp.asarray(w))
    x = rng.normal(0, 1, (2, 4, 256)).astype(np.float32)
    port_qt = params_from_jax({"w": qt})["w"]
    for layer in range(3):
        ref = jq.dense(jnp.asarray(x), jq.QuantStackRef(qt, jnp.int32(layer)))
        view = port_qt.layer(layer)
        assert view.data.data_ptr() == port_qt.data[layer].data_ptr()  # no copy
        got = tq.dense(torch.from_numpy(x), view)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_quantize_params_matches_jax_tree():
    """quantize_params picks the same leaves and produces the same bytes."""
    rng = np.random.default_rng(6)
    tree = {
        "embed": rng.normal(0, 0.02, (64, 32)).astype(np.float32),
        "layers": {
            "attn_norm_scale": np.ones((2, 32), np.float32),
            "w_qkv": rng.normal(0, 0.02, (2, 32, 96)).astype(np.float32),
        },
    }
    ref = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree), "int4", min_size=0,
                             include_embed=True)
    got = tq.quantize_params(params_from_jax(tree), "int4", min_size=0, include_embed=True)
    np.testing.assert_array_equal(got["layers"]["w_qkv"].data.numpy(),
                                  np.asarray(ref["layers"]["w_qkv"].data))
    np.testing.assert_array_equal(got["embed"].q.numpy(), np.asarray(ref["embed"].q))
    assert isinstance(got["layers"]["attn_norm_scale"], torch.Tensor)


def test_convert_keeps_bf16_bits():
    x = jnp.asarray(np.random.default_rng(7).normal(0, 1, (5, 3)), jnp.bfloat16)
    t = to_tensor(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x.astype(jnp.float32)))


def test_ksplit_depends_on_shape_only():
    """The decode body's split of K (decode_plan) has no M to depend on (so
    M = 1 and M = 2 sum in the same order), cuts the 64-packed-row k-tiles
    into whole ranges, and fills the card, at every int4 shape of the main
    path."""
    assert list(inspect.signature(decode_plan).parameters) == ["K", "N", "bits"]
    for K, N in [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072),
                 (2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)]:
        ks = decode_plan(K, N)
        assert (K // 2) % DECODE_KTILE == 0 and 1 <= ks <= (K // 2) // DECODE_KTILE
        assert (N // DECODE_BN) * ks <= 2 * 132
        assert (N // DECODE_BN) * ks >= 96  # most of the 132 SMs get a block


def test_wrapper_uses_plain_version_only_for_cpu_tensors():
    rng = np.random.default_rng(8)
    w = tq.quantize_int4(torch.from_numpy(rng.normal(0, 0.02, (256, 256)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(0, 1, (2, 256)).astype(np.float32))
    before = quant_matmul.launches
    assert torch.equal(quant_matmul(x, w.data, w.scale), quant_matmul_plain(x, w.data, w.scale))
    assert quant_matmul.launches == before  # the counter counts kernel launches only

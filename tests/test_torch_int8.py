"""Port parity: int8 weights (kernel B's plain version and its routing), the
int8 KV cache writes, the admission splice of an int8 cache and
kv_alignment_report.

The same numpy inputs (fixed seeds) go through the JAX package (its Pallas
kernel in interpret mode, and its XLA reference) and through
llm_inference_lab_tpu_torch on the CPU, where every op runs its plain
PyTorch version. Kernel B itself is held to the plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.config import EnvFlags
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import base as jbase
from llm_inference_lab_tpu.models import paged as jpaged
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu.ops.pallas.quant_matmul import quant_matmul_pallas
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax, to_tensor
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.kv_verify import compute_kv_checksum, kv_alignment_report
from llm_inference_lab_tpu_torch.models.base import (
    KVCache,
    ModelConfig,
    cache_slots,
    quantize_rows,
    write_cache_layer,
)
from llm_inference_lab_tpu_torch.models.paged import (
    PagedKVCache,
    gather_pages,
    page_slots,
    write_paged_layer,
)
from llm_inference_lab_tpu_torch.ops import quant as tq
from llm_inference_lab_tpu_torch.ops.quant_matmul import (
    DECODE_BN,
    DECODE_KTILE,
    decode_plan,
    quant_matmul_int8,
    quant_matmul_plain_int8,
)

# (K, N) of every int8 projection of the int8 path: 3B target, 1B draft.
PATH_SHAPES = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072),
               (2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("K,N", [(256, 256), (512, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_pallas_and_xla(K, N, dtype, stacked):
    """quant_matmul_int8 (the plain version on the CPU) against
    quant_matmul_pallas on int8 weights (interpret=True) and
    quant_matmul_xla, flat [K, N] and a layer of a stacked [L, K, N] weight,
    at M = 1, 5, 40. Per element: f32 within 1e-5 of the largest output
    (summation order); bf16 within 2^-7 |ref| + 1e-5 of the largest (both
    sides round an f32 sum to bf16: one bf16 step apart where the sums
    straddle a rounding boundary)."""
    rng = np.random.default_rng(K + N)
    w = rng.normal(0, 0.02, (3, K, N) if stacked else (K, N)).astype(np.float32)
    qt = (jax.vmap(jq.quantize_int8) if stacked else jq.quantize_int8)(jnp.asarray(w))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    port = params_from_jax({"w": qt})["w"]
    for M in (1, 5, 40):
        x = jnp.asarray(rng.normal(0, 1, (M, K)).astype(np.float32)).astype(jdt)
        if stacked:
            layer = 2
            got = quant_matmul_int8(to_tensor(x), port.data[layer], port.scale[layer])
            refs = (quant_matmul_pallas(x, qt, layer_idx=layer, interpret=True),
                    jq.quant_matmul_xla(x, jq.QuantStackRef(qt, jnp.int32(layer))))
        else:
            got = quant_matmul_int8(to_tensor(x), port.data, port.scale)
            refs = (quant_matmul_pallas(x, qt, interpret=True), jq.quant_matmul_xla(x, qt))
        assert got.dtype == tdt and got.shape == (M, N)
        got = got.float().numpy()
        for ref in refs:
            ref = np.asarray(ref.astype(jnp.float32))
            assert np.abs(ref).max() > 0.1
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5 * np.abs(ref).max())


def test_int8_wrapper_uses_plain_version_only_for_cpu_tensors():
    """On CPU tensors the wrapper is the plain version, and its launch count
    (kernel launches only) does not move; dense routes int8 weights to it."""
    rng = np.random.default_rng(8)
    w = tq.quantize_int8(torch.from_numpy(rng.normal(0, 0.02, (256, 256)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 256)).astype(np.float32))
    before = quant_matmul_int8.launches
    plain = quant_matmul_plain_int8(x.reshape(6, 256), w.data, w.scale)
    assert torch.equal(quant_matmul_int8(x.reshape(6, 256), w.data, w.scale), plain)
    assert torch.equal(tq.dense(x, w), plain.reshape(2, 3, 256))
    assert quant_matmul_int8.launches == before


def test_int8_ksplit_depends_on_shape_only():
    """Kernel B's split of K at decode (decode_plan) has no M to depend on
    (so every M sums in the same order), cuts the 64-row k-tiles into whole
    ranges, and fills the card, at every shape of the int8 path."""
    for K, N in PATH_SHAPES:
        ks = decode_plan(K, N, bits=8)
        assert K % DECODE_KTILE == 0 and 1 <= ks <= K // DECODE_KTILE
        assert (N // DECODE_BN) * ks <= 2 * 132
        assert (N // DECODE_BN) * ks >= 96
        assert ks == decode_plan(K, N)  # the split follows the column tiles, as int4's


def _rows(rng, shape, dtype):
    """Rows of N(0, 1) values with a zero row (the 1e-8 floor) and exact .5
    ties after scaling (a row whose amax is 127 has scale 1)."""
    x = rng.normal(0, 1, shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1, :4] = [127.0, 0.5, -2.5, 3.5]
    return jnp.asarray(x).astype(dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_rows_bit_exact(dtype):
    """quantize_rows gives JAX _quantize_rows' bytes and scales exactly,
    including a zero row and half-way ties (round half to even)."""
    x = _rows(np.random.default_rng(1), (2, 7, 3, 64), dtype)
    ref_q, ref_s = jbase._quantize_rows(x)
    got_q, got_s = quantize_rows(to_tensor(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert list(got_q.numpy().reshape(-1, 64)[1, :4]) == [127, 0, -2, 4]


def test_caches_carry_scales_only_when_int8():
    cfg = ModelConfig(n_layers=2, n_heads=4, n_kv_heads=2, d_model=64, dtype=torch.float32)
    c = KVCache.create(cfg, 3, 32, "cpu", dtype=torch.int8)
    assert c.k.dtype == torch.int8 and c.k_scale.shape == (2, 3, 2, 32)
    assert torch.all(c.k_scale == 1) and torch.all(c.v_scale == 1)
    assert c.k_scale.data_ptr() != c.v_scale.data_ptr()
    assert KVCache.create(cfg, 3, 32, "cpu").k_scale is None
    p = PagedKVCache.create(cfg, 3, 32, "cpu", page_size=16, dtype=torch.int8)
    assert p.k.shape == (2, 6, 2, 16, 16) and p.v_scale.shape == (2, 6, 2, 16)
    assert PagedKVCache.create(cfg, 3, 32, "cpu", page_size=16).v_scale is None


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_write_cache_layer_int8_bit_exact(dtype):
    """Two writes per layer into an int8 cache (a 5-row prefill, then a
    2-row chunk at other offsets per sequence): values and scales equal JAX
    update_cache_layer's bit for bit, untouched scales stay 1."""
    rng = np.random.default_rng(2)
    L, B, KVH, T, D = 2, 2, 2, 16, 64
    cfg = ModelConfig(n_layers=L, n_heads=4, n_kv_heads=KVH, d_model=4 * D, dtype=torch.float32)
    cache = KVCache.create(cfg, B, T, "cpu", dtype=torch.int8)
    ref = [[jnp.zeros((B, KVH, T, D), jnp.int8)] * 2 + [jnp.ones((B, KVH, T), jnp.float32)] * 2
           for _ in range(L)]
    for S, start in ((5, [0, 3]), (2, [7, 11])):
        start = np.array(start, np.int32)
        slots = cache_slots(torch.from_numpy(start), S, T)
        for layer in range(L):
            k_new, v_new = (_rows(rng, (B, S, KVH, D), dtype) for _ in range(2))
            write_cache_layer(cache, layer, to_tensor(k_new), to_tensor(v_new), slots)
            ref[layer] = jbase.update_cache_layer(*ref[layer], k_new, v_new, jnp.asarray(start))
    for layer in range(L):
        for got, want in zip((cache.k, cache.v, cache.k_scale, cache.v_scale), ref[layer]):
            np.testing.assert_array_equal(got[layer].numpy(), np.asarray(want))
    assert cache.k_scale[0, 0, 0, 5] == 1.0  # a row never written keeps its 1


def test_write_paged_layer_int8_bit_exact():
    """Two writes per layer (a 5-row prefill, then a 2-row chunk that
    crosses a page boundary) through shuffled tables into int8 pools: the
    pools and scale pools equal JAX update_paged_layer's bit for bit, and
    the gathered scales equal gather_scale_pages."""
    rng = np.random.default_rng(0)
    L, N, KVH, P, D, B, M = 2, 9, 2, 8, 64, 2, 3
    cfg = ModelConfig(n_layers=L, n_heads=4, n_kv_heads=KVH, d_model=4 * D, dtype=torch.float32)
    table = (rng.permutation(N - 1)[: B * M].reshape(B, M) + 1).astype(np.int32)
    cache = PagedKVCache.create(cfg, B, M * P, "cpu", n_pages=N, page_size=P,
                                table=torch.from_numpy(table), dtype=torch.int8)
    ref = [[jnp.zeros((N, KVH, P, D), jnp.int8)] * 2 + [jnp.ones((N, KVH, P), jnp.float32)] * 2
           for _ in range(L)]
    for S, start in ((5, [0, 3]), (2, [7, 15])):
        start = np.array(start, np.int32)
        slots = page_slots(cache.table, torch.from_numpy(start), S, P)
        for layer in range(L):
            k_new, v_new = (_rows(rng, (B, S, KVH, D), jnp.float32) for _ in range(2))
            write_paged_layer(cache, layer, to_tensor(k_new), to_tensor(v_new), slots)
            ref[layer] = jpaged.update_paged_layer(*ref[layer], k_new, v_new, jnp.asarray(start),
                                                   jnp.asarray(table))
    for layer in range(L):
        for got, want in zip((cache.k, cache.v, cache.k_scale, cache.v_scale), ref[layer]):
            np.testing.assert_array_equal(got[layer].numpy(), np.asarray(want))
        got = gather_pages(cache.k_scale[layer], cache.table)
        assert got.shape == (B, KVH, M * P)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jpaged.gather_scale_pages(ref[layer][2], jnp.asarray(table))))


@functools.lru_cache(maxsize=1)
def _tiny_int8():
    """llama-tiny target and draft from the JAX factory, weights x10 (the
    draft mixes in a second model), every projection quantized to int8 by
    the JAX package (as tests/test_torch_kvint8.py)."""
    def make(s):
        m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(s), dtype=jnp.float32)
        return jax.tree_util.tree_map(lambda a: a * 10 if a.ndim >= 2 else a, m.params)

    target = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(0), dtype=jnp.float32)
    draft = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(0), dtype=jnp.float32)
    target.params = jq.quantize_params(make(0), "int8", min_size=0)
    mixed = jax.tree_util.tree_map(lambda a, b: 0.95 * a + 0.05 * b, make(0), make(1))
    draft.params = jq.quantize_params(mixed, "int8", min_size=0)
    return target, draft


COMMON = dict(base_model="llama-tiny", draft_model="llama-tiny", max_new_tokens=24,
              max_seq_len=256, dtype="float32", kv_quantization="int8")
PROMPT = "The quick brown fox jumps over the lazy dog."


def _port_engine(target, draft, **kw):
    return Engine(EngineConfig(**{**COMMON, **kw}), device="cpu",
                  target_params=params_from_jax(target.params),
                  draft_params=params_from_jax(draft.params))


def test_int8_admission_splices_generate_cache():
    """An admitted request's int8 cache equals Engine.generate's: after the
    admission wave, the slot's committed rows (values and scales, through
    its pages) are bit-identical to a B=1 prefill of the same prompt."""
    target, draft = _tiny_int8()
    eng = _port_engine(target, draft, max_draft=2, kv_layout="paged", kv_page_size=16)
    b = ContinuousBatcher(eng, n_slots=2)
    prompts = ["splice check " * 3, "splice " * 9]
    for p in prompts:
        b.submit(p, max_new_tokens=4)
    b._admit_pending()
    cache = b.state.target_cache
    for slot, req in enumerate(b._slots):
        n = len(req.ids)
        alone = eng.target.init_cache(1, 64, "cpu", dtype=torch.int8)
        with torch.inference_mode():
            eng.target.forward(torch.tensor([req.ids], dtype=torch.int32),
                               torch.arange(n, dtype=torch.int32)[None], alone,
                               torch.zeros(1, dtype=torch.int32))
        table = cache.table[slot:slot + 1]
        for name in ("k", "v", "k_scale", "v_scale"):
            pool = getattr(cache, name)
            got = torch.stack([gather_pages(pool[i], table) for i in range(pool.shape[0])])
            assert torch.equal(got[:, :, :, :n], getattr(alone, name)[:, :, :, :n]), (slot, name)


def test_kv_alignment_report_matches_jax():
    """kv_alignment_report on the final state of an int8-KV run, against the
    JAX engine's report (EnvFlags(debug_kv_verify=True)) on the same
    committed tokens: both aligned, the same committed rows, checksums
    within 1e-5 relative (f32 sums of the same dequantized rows, in another
    order, over rows that may differ by a rounding step). A corrupted cache
    is reported misaligned, and uncommitted rows never count."""
    target, draft = _tiny_int8()
    jr = JaxEngine(JaxEngineConfig(implementation="hf", max_draft=2, **COMMON),
                   target_model=target, draft_model=draft,
                   flags=EnvFlags(debug_kv_verify=True)).generate(PROMPT)
    eng = _port_engine(target, draft, max_draft=2)
    state, plens, _, _ = eng.decode([PROMPT])
    n = int(state.lengths[0]) - int(plens[0])
    assert state.tokens[0, int(plens[0]):int(state.lengths[0])].tolist() == jr["generated_ids"]
    rep, ref = kv_alignment_report(eng.target, state), jr["kv_verify"]
    assert rep["aligned"] and ref["aligned"] and n > 0
    assert rep["committed_rows"] == ref["committed_rows"]
    assert rep["max_rel_diff_k"] <= 5e-2 and rep["max_rel_diff_v"] <= 5e-2
    for key in ("checksum_live", "checksum_fresh"):
        np.testing.assert_allclose(rep[key], ref[key], rtol=1e-5)
    with torch.inference_mode():
        state.target_cache.k[:, 0, :, 3] += 7  # a committed row
    assert not kv_alignment_report(eng.target, state)["aligned"]
    cache = KVCache(k=torch.zeros(1, 1, 2, 16, 4, dtype=torch.int8),
                    v=torch.zeros(1, 1, 2, 16, 4, dtype=torch.int8),
                    k_scale=torch.ones(1, 1, 2, 16), v_scale=torch.ones(1, 1, 2, 16))
    cache.k[:, :, :, 10:] = 99
    assert compute_kv_checksum(cache, torch.tensor([5])) == 0.0

"""Port parity for the int8 KV cache: attention over int8 caches and pools
(kernels D, E and F's int8 variants, by their plain versions), the int8
forward, Engine.generate and the continuous batcher. The int8 cache writes,
the admission splice and kv_alignment_report are in tests/test_torch_int8.py.

The same numpy inputs (fixed seeds) go through the JAX package (its Pallas
kernels in interpret mode, its XLA references and its engine) and through
llm_inference_lab_tpu_torch on the CPU, where each op runs its plain
PyTorch version. Weights are made by the JAX package and carried over with
convert.params_from_jax, so both sides compute with the same int8 bytes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import KVCache as JaxKVCache
from llm_inference_lab_tpu.models.base import ModelConfig as JaxModelConfig
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu.ops.attention import attend_xla
from llm_inference_lab_tpu.ops.paged_attention import paged_attend_xla
from llm_inference_lab_tpu.ops.pallas.flash_decode import flash_decode_attention
from llm_inference_lab_tpu.ops.pallas.flash_prefill import flash_prefill_attention
from llm_inference_lab_tpu.ops.pallas.paged_flash import paged_flash_attention
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import transformer as tt
from llm_inference_lab_tpu_torch.models.base import KVCache, ModelConfig, quantize_rows
from llm_inference_lab_tpu_torch.ops import attention
from llm_inference_lab_tpu_torch.ops import flash_decode as fd
from llm_inference_lab_tpu_torch.ops import flash_prefill as fp
from llm_inference_lab_tpu_torch.ops import paged_flash as pf

# Attention outputs are O(1) averages of dequantized N(0, 1) rows; the two
# sides sum the softmax in another order: 2e-5 absolute.
ATOL = 2e-5


def _int8(rng, shape):
    """N(0, 1) rows quantized per row: (int8 values, f32 scales) as numpy."""
    q, s = quantize_rows(torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)))
    return q.numpy(), s.numpy()


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _cache_inputs(S, seed, B=2, H=6, KVH=2, T=256, D=128, base=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k, ks = _int8(rng, (B, KVH, T, D))
    v, vs = _int8(rng, (B, KVH, T, D))
    base = rng.integers(0, T - S, (B,)) if base is None else np.asarray(base)
    pos = (base[:, None] + np.arange(S)[None]).astype(np.int32)
    return q, k, v, pos, ks, vs


@pytest.mark.parametrize("S", [1, 5])
def test_int8_decode_plain_matches_pallas_on_live_rows(S):
    """flash_decode on an int8 cache (flash_decode_int8's plain version)
    against flash_decode_attention's int8 variant (interpret=True): D=128,
    T=256, GQA group 3, f32 q."""
    q, k, v, pos, ks, vs = _cache_inputs(S, seed=S)
    ref = flash_decode_attention(*_j(q, k, v, pos, ks, vs), interpret=True, block_t=128)
    got = fd.flash_decode(*_t(q, k, v, pos, ks, vs))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [1, 5, 40])
def test_int8_attend_matches_attend_xla_with_dead_row(S):
    """attend on an int8 cache against attend_xla (dequantize, then attend)
    everywhere, including a dead row (position -1) that is exactly zero;
    S = 40 takes the prefill route."""
    q, k, v, pos, ks, vs = _cache_inputs(S, seed=10 + S, base=[30, 150])
    pos[1, 0] = -1
    ref = np.asarray(attend_xla(*_j(q, k, v, pos, ks, vs)))
    got = attention.attend(*_t(q, k, v, pos, ks, vs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.all(got[1, 0] == 0.0)


@pytest.mark.parametrize("group", [1, 2])
def test_int8_prefill_plain_matches_pallas(group):
    """flash_prefill on an int8 cache against flash_prefill_attention's int8
    variant (interpret=True, block_s=block_t=128): B=2, S=256, T=512,
    D=128; row 0 prefills from 0, row 1 resumes at base 128."""
    rng = np.random.default_rng(5)
    B, KVH, D, S, T = 2, 2, 128, 256, 512
    q = rng.normal(0, 1, (B, S, KVH * group, D)).astype(np.float32)
    k, ks = _int8(rng, (B, KVH, T, D))
    v, vs = _int8(rng, (B, KVH, T, D))
    pos = np.stack([np.arange(S), 128 + np.arange(S)]).astype(np.int32)
    ref = flash_prefill_attention(*_j(q, k, v, pos, ks, vs), interpret=True, block_s=128,
                                  block_t=128)
    got = fp.flash_prefill(*_t(q, k, v, pos, ks, vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def _pool_inputs(S, P, seed, B=2, KVH=2, group=2, D=128, span=96):
    """int8 pools of N pages with scale pools, a shuffled table of
    M = span / P pages per sequence (page 0 never used), queries at
    different depths per sequence."""
    rng = np.random.default_rng(seed)
    M = span // P
    N = B * M + 3
    q = rng.normal(0, 1, (B, S, KVH * group, D)).astype(np.float32)
    kp, ksp = _int8(rng, (N, KVH, P, D))
    vp, vsp = _int8(rng, (N, KVH, P, D))
    table = (rng.permutation(N - 1)[: B * M].reshape(B, M) + 1).astype(np.int32)
    pos = (np.array([[40], [span - S - 3]]) + np.arange(S)[None]).astype(np.int32)
    return q, kp, vp, pos, table, ksp, vsp


@pytest.mark.parametrize("P", [32, 64])
@pytest.mark.parametrize("S", [1, 5])
def test_int8_paged_plain_matches_pallas_on_live_rows(S, P):
    """paged_flash on int8 pools (paged_flash_int8's plain version) against
    paged_flash_attention's int8 variant (interpret=True), shuffled
    tables."""
    q, kp, vp, pos, table, ksp, vsp = _pool_inputs(S, P, seed=S * 100 + P)
    ref = paged_flash_attention(*_j(q, kp, vp, pos, ksp, vsp), table=jnp.asarray(table),
                                interpret=True)
    got = pf.paged_flash(*_t(q, kp, vp, pos, table, ksp, vsp))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [1, 5, 40])
def test_int8_paged_attend_matches_xla_with_dead_row(S):
    """paged_attend on int8 pools against paged_attend_xla, with a dead row
    that is exactly zero; S = 40 gathers the pages and scales and takes the
    prefill route."""
    q, kp, vp, pos, table, ksp, vsp = _pool_inputs(S, 32, seed=7 + S)
    pos[0, 0] = -1
    ref = np.asarray(paged_attend_xla(*_j(q, kp, vp, pos, ksp, vsp), table=jnp.asarray(table)))
    got = attention.paged_attend(*_t(q, kp, vp, pos, table, ksp, vsp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.all(got[0, 0] == 0.0)


def test_int8_caches_route_to_the_int8_variants(monkeypatch):
    """An int8 cache reaches flash_decode_int8 (S <= 32) and
    flash_prefill_int8 (S > 32); int8 pools reach paged_flash_int8, and a
    paged prefill gathers pages and scales into flash_prefill_int8. A bf16
    cache reaches none of them."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a):
            calls.append((name, a[0].shape[1]))
            return fn(*a)
        monkeypatch.setattr(module, name, wrapped)

    spy(fd, "flash_decode_int8")
    spy(fp, "flash_prefill_int8")
    spy(pf, "paged_flash_int8")
    for S in (1, 33):
        q, k, v, pos, ks, vs = _cache_inputs(S, seed=20 + S, D=64)
        attention.attend(*_t(q, k, v, pos, ks, vs))
        attention.attend(*_t(q, k.astype(np.float32), v.astype(np.float32), pos))
        q, kp, vp, pos, table, ksp, vsp = _pool_inputs(S, 32, seed=30 + S, D=64)
        attention.paged_attend(*_t(q, kp, vp, pos, table, ksp, vsp))
    assert calls == [("flash_decode_int8", 1), ("paged_flash_int8", 1),
                     ("flash_prefill_int8", 33), ("flash_prefill_int8", 33)]


def test_int8_forward_matches_jax():
    """A small Llama (2 layers, d_model 256, 2 heads of 128, 1 KV head,
    vocab 512) with int8 weights and an int8 KV cache, f32 activations: the
    prefill logits and then K+1 = 5 verify-chunk logits over the cache match
    the JAX forward within 5e-5 of the largest logit (f32 sums in another
    order, as test_torch_slice's int4 forward), and the dequantized cached
    keys within 1e-3 of the largest (a row's byte may round the other way
    where the two f32 keys straddle a step: 1/127 of that row's amax)."""
    kw = dict(vocab_size=512, n_layers=2, n_heads=2, n_kv_heads=1, d_model=256, d_ff=512,
              rope_theta=500000.0, rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192))
    jcfg = JaxModelConfig(name="t", arch="llama", dtype=jnp.float32, **kw)
    tcfg = ModelConfig(name="t", dtype=torch.float32, **kw)
    params = jt.init_params(jcfg, jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(lambda a: a * 10 if a.ndim >= 2 else a, params)
    params = jq.quantize_params(params, "int8", min_size=0)
    tparams = params_from_jax(params)
    assert tparams["layers"]["w_qkv"].bits == 8

    T, P = 128, 32
    rng = np.random.default_rng(0)
    jcache = JaxKVCache.create(jcfg, 1, T, quantized=True)
    tcache = KVCache.create(tcfg, 1, T, "cpu", dtype=torch.int8)
    calls = [(rng.integers(0, 512, (1, P)), np.arange(P)[None], 0),
             (rng.integers(0, 512, (1, 5)), np.arange(P, P + 5)[None], P)]
    for toks, pos, start in calls:
        toks, pos = toks.astype(np.int32), pos.astype(np.int32)
        lens = np.array([start], np.int32)
        jl, jcache = jt.forward(jcfg, params, *_j(toks, pos), jcache, jnp.asarray(lens))
        tl, tcache = tt.forward(tcfg, tparams, *_t(toks, pos), tcache, torch.from_numpy(lens))
        ref = np.asarray(jl)
        assert np.abs(ref).max() > 0.5
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0, atol=5e-5 * np.abs(ref).max())
    assert tcache.k.dtype == torch.int8
    ref_k = np.asarray(jcache.k).astype(np.float32) * np.asarray(jcache.k_scale)[..., None]
    got_k = tcache.k.float() * tcache.k_scale[..., None]
    np.testing.assert_allclose(got_k.numpy()[:, :, :, :P + 5], ref_k[:, :, :, :P + 5], rtol=0,
                               atol=1e-3 * np.abs(ref_k).max())


@functools.lru_cache(maxsize=1)
def _tiny_int8():
    """llama-tiny target and draft from the JAX factory, weights x10 (so
    greedy generation is not a constant token; the draft mixes in a second
    model, so it agrees with the target only some of the time), every
    projection quantized to int8 by the JAX package."""
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
                  draft_params=params_from_jax(draft.params) if draft is not None else None)


@pytest.mark.parametrize("k", [1, 4])
def test_int8_engine_generated_ids_equal_jax(k):
    """The JAX Engine and the port's, int8 weights and int8 KV, llama-tiny,
    f32, greedy: generated ids, accepted, proposed and steps equal; token
    logprobs within 1e-4; spec ids equal the port's baseline ids."""
    target, draft = _tiny_int8()
    jr = JaxEngine(JaxEngineConfig(implementation="hf", max_draft=k, **COMMON),
                   target_model=target, draft_model=draft).generate(PROMPT)
    eng = _port_engine(target, draft, max_draft=k)
    tr = eng.generate(PROMPT)
    assert tr["kv_quantization"] == "int8" and eng.target.params["layers"]["wo"].bits == 8
    assert tr["generated_ids"] == jr["generated_ids"]
    assert len(set(tr["generated_ids"])) > 3
    assert (tr["accepted"], tr["proposed"], tr["steps"]) == (jr["accepted"], jr["proposed"],
                                                             jr["steps"])
    assert tr["accepted"] > 0
    np.testing.assert_allclose(tr["token_logprobs"], jr["token_logprobs"], rtol=0, atol=1e-4)
    base = _port_engine(target, None, max_draft=k, draft_model=None).generate(PROMPT)
    assert base["generated_ids"] == tr["generated_ids"]


REQUESTS = [("serving parity " * n, m) for n, m in ((1, 5), (4, 16), (10, 9), (2, 12), (7, 20),
                                                    (3, 7))]


def _drive(b, step, retire):
    """Both batchers on one schedule: admit, then one decode step per poll,
    retire, admit, until every slot is empty (as test_torch_serving)."""
    for prompt, budget in REQUESTS:
        b.submit(prompt, max_new_tokens=budget)
    b._admit_pending()
    for _ in range(200):
        if not any(s is not None for s in b._slots):
            break
        step()
        retire()
        b._admit_pending()
    assert not b.scheduler.pending()
    return {r["req_id"]: r for r in (b._done[i].result for i in sorted(b._done))}


@pytest.mark.parametrize("layout,page_size", [("contiguous", 64), ("paged", 16)])
def test_int8_batcher_matches_jax(layout, page_size):
    """test_torch_serving's batcher parity with kv_quantization="int8" and
    int8 weights (K=2, 3 slots, 6 requests): per request, generated ids,
    proposed, accepted, generated tokens and finish reason equal the JAX
    batcher's, token logprobs within 1e-4, prompt logprobs within
    1e-4 + 3e-5 |lp| (the f32 forwards' gap measured for that test)."""
    target, draft = _tiny_int8()
    kw = dict(COMMON, max_draft=2, max_new_tokens=16, kv_layout=layout, kv_page_size=page_size)
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", kv_lazy_pages=False, **kw),
                     target_model=target, draft_model=draft)
    jb = JaxBatcher(jeng, n_slots=3)
    want = _drive(jb, lambda: jb.step_chunk(1), jb._retire_finished)
    b = ContinuousBatcher(_port_engine(target, draft, **kw), n_slots=3)
    assert b.state.target_cache.k.dtype == torch.int8
    got = _drive(b, lambda: b.step_chunk(1), lambda: None)
    assert sorted(got) == sorted(want) == list(range(len(REQUESTS)))
    for rid, r in got.items():
        w = want[rid]
        for key in ("generated_ids", "proposed", "accepted", "generated_tokens", "finish_reason"):
            assert r[key] == w[key], (rid, key, r[key], w[key])
        np.testing.assert_allclose(r["token_logprobs"], w["token_logprobs"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["prompt_logprobs"][1:], w["prompt_logprobs"][1:],
                                   rtol=3e-5, atol=1e-4)
    assert sum(r["accepted"] for r in got.values()) > 0
    assert b.stats.report()["admit_waves"] >= 2

"""Port parity for Mistral and the rolling-buffer KV cache (kv_ring): the
configs, the ring write, the ring mask of attention (kernels D and E's
plain versions with ring_len), the chunked prefill, the untied head, and
Engine.generate on mistral-tiny with a ring, against the JAX package and
against the port's own full cache.

The same numpy inputs (fixed seeds) go through the JAX package (its Pallas
kernels in interpret mode, its XLA references and its engine) and through
llm_inference_lab_tpu_torch on the CPU, where each op runs its plain
PyTorch version. Weights are made by the JAX package and carried over with
convert.params_from_jax, so both sides compute with the same bytes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import KVCache as JaxKVCache
from llm_inference_lab_tpu.models.base import update_cache_layer
from llm_inference_lab_tpu.models.mistral import MISTRAL_CONFIGS as JAX_MISTRAL_CONFIGS
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops.attention import attend_xla
from llm_inference_lab_tpu.ops.pallas.flash_decode import flash_decode_attention
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.kv_verify import kv_alignment_report
from llm_inference_lab_tpu_torch.models import registry
from llm_inference_lab_tpu_torch.models import transformer as tt
from llm_inference_lab_tpu_torch.models.base import (
    KVCache,
    cache_slots,
    quantize_rows,
    write_cache_layer,
)
from llm_inference_lab_tpu_torch.models.mistral import MISTRAL_CONFIGS
from llm_inference_lab_tpu_torch.ops import attention
from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash

# Ring attention inputs: a ring of R slots, a window W, the group of 2
# query heads a KV head that mistral-tiny has.
R, W = 256, 48
# f32 and int8 caches: outputs are O(1) averages of (dequantized) N(0, 1)
# rows, summed in another order on the two sides: 2e-5 absolute. bf16: the
# Pallas body rounds its running p to bf16 before P.V and its output, the
# plain version the normalized probabilities (attend_xla's order): 2^-7 of
# |ref| plus 2^-7, as tests/test_torch_gemma.py holds the other options.
ATOL = 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -7


# ---------------------------------------------------------------- (a) configs
@pytest.mark.parametrize("name", sorted(JAX_MISTRAL_CONFIGS))
def test_mistral_configs_equal_jax(name):
    """Every field the port's ModelConfig has equals the JAX preset's (the
    dtype aside: a torch dtype there, a JAX one here), and the registry
    resolves the hub name as JAX's does."""
    jcfg, tcfg = JAX_MISTRAL_CONFIGS[name], MISTRAL_CONFIGS[name]
    assert set(MISTRAL_CONFIGS) == set(JAX_MISTRAL_CONFIGS)
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.head_dim == jcfg.head_dim
    assert registry.model_key(f"mistralai/{name.upper()}") == name


# ------------------------------------------------------------ (b) ring write
def _write_inputs(kind, S, starts, B=2, KVH=2, D=16, T=R, seed=0):
    rng = np.random.default_rng(seed + S)
    k_new = rng.normal(0, 1, (B, S, KVH, D)).astype(np.float32)
    v_new = rng.normal(0, 1, (B, S, KVH, D)).astype(np.float32)
    dt = np.int8 if kind == "int8" else np.float32
    k0 = (rng.integers(-127, 128, (B, KVH, T, D)) if kind == "int8"
          else rng.normal(0, 1, (B, KVH, T, D))).astype(dt)
    v0 = (rng.integers(-127, 128, (B, KVH, T, D)) if kind == "int8"
          else rng.normal(0, 1, (B, KVH, T, D))).astype(dt)
    s0 = rng.uniform(0.01, 0.02, (B, KVH, T)).astype(np.float32)
    return k_new, v_new, k0, v0, s0, np.array(starts, np.int32)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("S,starts", [(5, (R - 3, 2 * R + 7)), (R + 40, (0, R - 10)),
                                      (32, (96, 3 * R - 16))])
def test_ring_write_matches_jax(kind, S, starts):
    """write_cache_layer with cache_slots(ring_len=R) against JAX
    update_cache_layer(ring_len=R): bytes and scales exactly equal, for a
    block that wraps the ring (S = 5 from R - 3), one longer than the ring
    (S = R + 40: only its last R rows land) and a chunk ending at a wrap."""
    k_new, v_new, k0, v0, s0, start = _write_inputs(kind, S, starts)
    jdt = jnp.int8 if kind == "int8" else jnp.bfloat16
    tdt = torch.int8 if kind == "int8" else torch.bfloat16
    jk, jv, jks, jvs = update_cache_layer(
        jnp.asarray(k0, jdt), jnp.asarray(v0, jdt), jnp.asarray(s0), jnp.asarray(s0 * 2),
        jnp.asarray(k_new, jnp.bfloat16), jnp.asarray(v_new, jnp.bfloat16), jnp.asarray(start),
        ring_len=R)
    cache = KVCache(*(torch.from_numpy(x.copy())[None].to(tdt) for x in (k0, v0)),
                    torch.from_numpy(s0.copy())[None], torch.from_numpy(s0 * 2)[None])
    slots = cache_slots(torch.from_numpy(start), S, R, ring_len=R)
    write_cache_layer(cache, 0, torch.from_numpy(k_new).bfloat16(),
                      torch.from_numpy(v_new).bfloat16(), slots)
    for got, ref in ((cache.k[0], jk), (cache.v[0], jv)):
        if kind == "bf16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(ref).view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if kind == "int8":
        np.testing.assert_array_equal(cache.k_scale[0].numpy(), np.asarray(jks))
        np.testing.assert_array_equal(cache.v_scale[0].numpy(), np.asarray(jvs))
    # The block really moved the slots it names, and left the rest alone.
    want = torch.zeros(2, R, dtype=torch.bool)
    for b in range(2):
        want[b, [p % R for p in range(start[b], start[b] + S)]] = True
    moved = (cache.k[0].float() != torch.from_numpy(k0).to(tdt).float()).any(-1).any(1)
    assert torch.equal(moved | want, want) and moved.sum() > 0.9 * want.sum()


# ---------------------------------------------------------- (c) ring attention
def _ring_caches(rng, kind, B, KVH, T, D):
    if kind == "int8":
        out = []
        for _ in range(2):
            q, s = quantize_rows(torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D))
                                                  .astype(np.float32)))
            out += [q.numpy(), s.numpy()]
        return out[0], out[2], out[1], out[3]
    k, v = (rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32) for _ in range(2))
    return k, v, None, None


def _to(kind, *arrays):
    """numpy -> (jax, torch) pairs in the kind's compute type (bf16 or f32;
    int8 caches keep their bytes and f32 scales)."""
    out = []
    for a in arrays:
        if a is None:
            out.append((None, None))
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        if kind == "bf16" and a.dtype == np.float32:
            out.append((jnp.asarray(a, jnp.bfloat16), t.bfloat16()))
        else:
            out.append((jnp.asarray(a), t))
    return out


def _check(kind, got, ref):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    if kind == "bf16":
        assert np.all(np.abs(got - ref) <= BF16_RTOL * np.abs(ref) + BF16_ATOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T,window", [(R, W), (128, W), (128, 200)])
def test_ring_decode_matches_pallas(kind, T, window):
    """flash_decode's plain version with ring_len=R against
    flash_decode_attention(interpret=True, ring_len=R) on a 3-row verify
    block: sequence 0 at positions 300..302 (its window wraps the ring),
    sequence 1 at 20..22 (no wrap). T = R, and T = 128 < R (a cache shorter
    than the ring: slots 0..44 hold positions 256..300, and with window 200
    slots 101..127 are seen too, holding positions 101..127)."""
    rng = np.random.default_rng(T + window)
    B, S, H, KVH, D = 2, 3, 4, 2, 128
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k, v, ks, vs = _ring_caches(rng, kind, B, KVH, T, D)
    pos = (np.array([[300], [20]]) + np.arange(S)[None]).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv), (jp, tp), (jks, tks), (jvs, tvs) = _to(kind, q, k, v, pos, ks, vs)
    opts = dict(window=window, ring_len=R)
    ref = flash_decode_attention(jq, jk, jv, jp, jks, jvs, interpret=True, block_t=64, **opts)
    got = attention.attend(tq, tk, tv, tp, tks, tvs, **opts)
    _check(kind, got, ref)
    # The ring mask is not the position mask over these slots.
    assert not torch.allclose(got.float(), attention.attend(tq, tk, tv, tp, tks, tvs,
                                                            window=window).float())


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_ring_prefill_matches_attend_xla(kind):
    """A 64-row prefill chunk (S > 32: flash_prefill's plain version) over
    the ring at positions 224..287, which cross the wrap at R, and a second
    sequence's chunk at 0..63 with a dead row, against attend_xla's ring
    branch (JAX sends ring prefill chunks there; for bf16 on f32 copies of
    the bf16 inputs, within the bf16 tolerance)."""
    rng = np.random.default_rng(5)
    B, S, H, KVH, D = 2, 64, 4, 2, 128
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k, v, ks, vs = _ring_caches(rng, kind, B, KVH, R, D)
    pos = np.stack([224 + np.arange(S), np.arange(S)]).astype(np.int32)
    pos[1, -1] = -1
    (jq, tq), (jk, tk), (jv, tv), (jp, tp), (jks, tks), (jvs, tvs) = _to(kind, q, k, v, pos, ks, vs)
    # JAX's CPU dot takes no bf16 x bf16 -> f32: the bf16 values go in as f32.
    jq, jk, jv = (x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x for x in (jq, jk, jv))
    ref = attend_xla(jq, jk, jv, jp, jks, jvs, window=W, ring_len=R)
    got = attention.attend(tq, tk, tv, tp, tks, tvs, window=W, ring_len=R)
    _check(kind, got, ref)
    assert torch.all(got[1, -1] == 0)


def test_attend_routes_the_ring(monkeypatch):
    """attend with ring_len sends S <= 32 to flash_decode and S > 32 to
    flash_prefill, both with the ring and the window (kept although T <=
    window: the modular mask needs it); a ring without a window, or on
    pages, is refused."""
    calls = []
    for name in ("flash_decode", "flash_prefill"):
        def spy(*a, _fn=getattr(attention, name), _n=name, **kw):
            calls.append((_n, kw))
            return _fn(*a, **kw)

        monkeypatch.setattr(attention, name, spy)
    rng = np.random.default_rng(0)
    k, v = (torch.from_numpy(rng.normal(0, 1, (1, 2, 64, 16)).astype(np.float32)) for _ in "kv")
    for S in (1, 32, 33):
        q = torch.from_numpy(rng.normal(0, 1, (1, S, 4, 16)).astype(np.float32))
        pos = torch.arange(100, 100 + S, dtype=torch.int32)[None]
        attention.attend(q, k, v, pos, window=200, ring_len=64)
    assert calls == [("flash_decode", dict(window=200, ring_len=64))] * 2 + [
        ("flash_prefill", dict(window=200, ring_len=64))]
    with pytest.raises(ValueError, match="window"):
        attention.attend(q, k, v, pos, ring_len=64)
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash(q, k, v, pos, torch.zeros((1, 1), dtype=torch.int32), window=16, ring_len=64)


# --------------------------------------------------------- (d) model, head
def _jax_params(name, seed, mult=10, untied=False):
    """The JAX factory's random init in f32, projections times mult and
    norms jittered (N(0, 0.3)), so that every op matters; untied=True adds
    an lm_head of its own."""
    m = get_model(name, "hf", rng=jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = m.params
    if untied:
        m.config = dataclasses.replace(m.config, tie_word_embeddings=False)
        params = dict(params, lm_head=jax.random.normal(jax.random.PRNGKey(seed + 100),
                                                        (m.config.d_model, m.config.vocab_size),
                                                        jnp.float32) * 0.02)
    rng = np.random.default_rng(seed)

    def scale(path, a):
        if "norm" in jax.tree_util.keystr(path):
            return a + jnp.asarray(rng.normal(0, 0.3, a.shape), a.dtype)
        return a * mult if a.ndim >= 2 else a

    m.params = jax.tree_util.tree_map_with_path(scale, params)
    return m


def test_untied_head_carried_and_forward_matches_jax():
    """params_from_jax carries an untied lm_head across (f32, and as an int4
    QuantTensor after quantize_params), and a ring forward of mistral-tiny
    with it (a 40-token prompt in chunks of 32 over a ring of 64 slots, then
    a 3-row verify) gives JAX's logits within 5e-5 of the largest (f32 sums
    in another order, as tests/test_torch_slice.py holds the Llama forward)."""
    from llm_inference_lab_tpu.ops.quant import quantize_params as jax_quantize

    m = _jax_params("mistral-tiny", 3, untied=True)
    for quant in (None, "int4"):
        params = m.params
        if quant:  # quantize_params replaces (and donates) leaves: give it a copy
            params = jax_quantize(jax.tree_util.tree_map(jnp.array, m.params), quant, min_size=0)
        tparams = params_from_jax(params)
        assert "lm_head" in tparams
        jcfg = dataclasses.replace(m.config, kv_ring_len=64)
        tcfg = dataclasses.replace(registry.create("mistral-tiny", device="cpu",
                                                   dtype=torch.float32, params=tparams).config,
                                   tie_word_embeddings=False, kv_ring_len=64)
        jcache, tcache = JaxKVCache.create(jcfg, 1, 64), KVCache.create(tcfg, 1, 64, "cpu")
        rng = np.random.default_rng(4)
        toks = rng.integers(0, 256, (1, 67)).astype(np.int32)
        for lo, hi in ((0, 32), (32, 64), (64, 67)):
            pos = np.arange(lo, hi, dtype=np.int32)[None]
            lens = np.array([lo], np.int32)
            jl, jcache = jt.forward(jcfg, params, jnp.asarray(toks[:, lo:hi]), jnp.asarray(pos),
                                    jcache, jnp.asarray(lens))
            tl, tcache = tt.forward(tcfg, tparams, torch.from_numpy(toks[:, lo:hi]),
                                    torch.from_numpy(pos), tcache, torch.from_numpy(lens))
            ref = np.asarray(jl, np.float32)
            assert np.abs(ref).max() > 1.0  # the comparison is not vacuous
            np.testing.assert_allclose(tl.float().numpy(), ref, rtol=0,
                                       atol=5e-5 * np.abs(ref).max())


# ----------------------------------------------------- (e) Engine, the ring
COMMON = dict(base_model="mistral-tiny", max_seq_len=512, max_new_tokens=48, prefill_chunk=32,
              dtype="float32")
# 119 tokens (P = 128, 4 chunks): the window of 16 binds, and the decode
# wraps the ring of 128 slots.
PROMPT = "ring cache check " * 7
LONG = "the quick brown fox jumps over the lazy dog " * 12  # 528 tokens: past the ring
# Engine runs: (name, engine settings, prompt).
RUNS = {
    "baseline": (dict(draft_model=None), PROMPT),
    "spec": (dict(draft_model="mistral-tiny", max_draft=3), PROMPT),
    "int8": (dict(draft_model=None, kv_quantization="int8"), PROMPT),
    "long": (dict(draft_model=None, max_seq_len=1024), LONG),
}


@functools.lru_cache(maxsize=1)
def _models():
    """The target, and a draft that mixes a second model into it so that it
    agrees with the target only some of the time."""
    target = _jax_params("mistral-tiny", 1)
    draft = _jax_params("mistral-tiny", 1)
    other = _jax_params("mistral-tiny", 11)
    draft.params = jax.tree_util.tree_map(lambda a, b: 0.9 * a + 0.1 * b, draft.params,
                                          other.params)
    return target, draft


def _port_engine(run, ring):
    target, draft = _models()
    kw, _ = RUNS[run]
    return Engine(EngineConfig(**{**COMMON, **kw}, kv_ring=ring), device="cpu",
                  target_params=params_from_jax(target.params),
                  draft_params=params_from_jax(draft.params) if kw["draft_model"] else None)


@pytest.fixture(scope="module")
def ring_runs():
    """Each run's results: the JAX Engine's with the ring, the port's with
    the ring and the port's with its full cache; and the port's ring
    engines."""
    target, draft = _models()
    out = {}
    for run, (kw, prompt) in RUNS.items():
        jeng = JaxEngine(JaxEngineConfig(implementation="hf", **{**COMMON, **kw}, kv_ring=True),
                         target_model=target, draft_model=draft if kw["draft_model"] else None)
        eng = _port_engine(run, True)
        out[run] = dict(jax=jeng.generate(prompt), ring=eng.generate(prompt),
                        full=_port_engine(run, False).generate(prompt), engine=eng)
    return out


@pytest.mark.parametrize("run", sorted(RUNS))
def test_ring_generate_equals_jax_and_full_cache(ring_runs, run):
    """mistral-tiny with kv_ring, prefill_chunk 32 (f32, greedy): a ring of
    round_up(16 + 32 + K + 2, 128) = 128 slots on both models, which the
    decode of the 119-token prompt wraps. Generated
    ids equal the JAX ring engine's and the port's full cache's, for the
    baseline, spec at K = 3 (partial acceptance: the ring absorbs K+1
    scratch rows a step), an int8 cache and a prompt longer than the ring;
    acceptance and steps equal JAX's. Prompt and token logprobs within 2e-5
    of JAX's and of the full cache's (the results are rounded to 6
    decimals; the gap measured 6e-6 at most): the plain mask sums over the
    ring's 128 slots, the full cache's over 256 or 640, in another order.
    With the int8 cache that order moves a K or V value by ~1e-7 across an
    int8 rounding step (1/127 of its row's largest value) now and then, so
    ring and full cache are held within 1e-3 there (measured 1.7e-4)."""
    r = ring_runs[run]
    eng, jr, tr, fr = r["engine"], r["jax"], r["ring"], r["full"]
    assert eng.target.config.kv_ring_len == 128
    assert eng.draft is None or eng.draft.config.kv_ring_len == 128
    state_T = eng.target.init_cache(1, eng.config.max_seq_len, "cpu").k.shape[3]
    assert state_T == 128
    assert tr["generated_ids"] == jr["generated_ids"] == fr["generated_ids"]
    assert len(set(tr["generated_ids"])) > 3  # not a constant stream
    assert (tr["accepted"], tr["proposed"], tr["steps"]) == (jr["accepted"], jr["proposed"],
                                                             jr["steps"])
    if run == "spec":
        assert 0 < tr["acceptance_rate"] < 1
    if run == "long":
        assert len(eng.encode(LONG, 48, 1024)) > 128  # longer than the ring
    got = np.array(tr["token_logprobs"] + tr["prompt_logprobs"][1:])
    for other, atol in ((jr, 2e-5), (fr, 1e-3 if run == "int8" else 2e-5)):
        ref = np.array(other["token_logprobs"] + other["prompt_logprobs"][1:])
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_ring_kv_report_is_skipped(ring_runs):
    """kv_alignment_report on a ring engine's final state says it was
    skipped, as the JAX engine's debug report does."""
    eng = ring_runs["baseline"]["engine"]
    state, _, _, _ = eng.decode([PROMPT])
    assert kv_alignment_report(eng.target, state) == {"aligned": True, "skipped": "kv_ring"}


def test_ring_refusals():
    """A ring needs prefill_chunk, a multiple of 32, and the contiguous
    layout; it stays off where it would not shrink the cache; the batcher
    refuses a ring engine (it needs incremental admission)."""
    for kw, match in ((dict(prefill_chunk=None), "prefill_chunk"),
                      (dict(prefill_chunk=48), "multiple of 32"),
                      (dict(kv_layout="paged"), "contiguous")):
        with pytest.raises(ValueError, match=match):
            Engine(EngineConfig(**dict(COMMON, draft_model=None, kv_ring=True, **kw)),
                   device="cpu")
    small = Engine(EngineConfig(**dict(COMMON, draft_model=None, kv_ring=True, max_seq_len=128)),
                   device="cpu")
    assert small.target.config.kv_ring_len is None
    ring = Engine(EngineConfig(**dict(COMMON, draft_model=None, kv_ring=True)), device="cpu")
    with pytest.raises(NotImplementedError, match="admit_chunk"):
        ContinuousBatcher(ring, n_slots=2)
    assert ContinuousBatcher(small, n_slots=2).n_slots == 2


# ------------------------------------------------ (f) chunked prefill, no ring
def test_chunked_prefill_matches_jax_on_llama_tiny():
    """prefill_chunk without a ring (llama-tiny, no window): a 135-token
    prompt prefills in 5 chunks of 32 (P = 160). Ids equal the JAX engine's
    with the same chunk, prompt and token logprobs within 1e-4 + 3e-5 |lp|
    of JAX's and of the port's single-shot prefill."""
    m = _jax_params("llama-tiny", 2)
    cfg = dict(base_model="llama-tiny", draft_model=None, max_seq_len=512, max_new_tokens=16,
               dtype="float32")
    prompt = "The quick brown fox jumps over the lazy dog. " * 3
    jr = JaxEngine(JaxEngineConfig(implementation="hf", prefill_chunk=32, **cfg),
                   target_model=m).generate(prompt)
    tparams = params_from_jax(m.params)
    tr = Engine(EngineConfig(prefill_chunk=32, **cfg), device="cpu",
                target_params=tparams).generate(prompt)
    one = Engine(EngineConfig(**cfg), device="cpu", target_params=tparams).generate(prompt)
    assert tr["generated_ids"] == jr["generated_ids"] == one["generated_ids"]
    got = np.array(tr["prompt_logprobs"][1:] + tr["token_logprobs"])
    assert len(tr["prompt_logprobs"]) == 135
    for other in (jr, one):
        ref = np.array(other["prompt_logprobs"][1:] + other["token_logprobs"])
        assert np.all(np.abs(got - ref) <= 1e-4 + 3e-5 * np.abs(ref))

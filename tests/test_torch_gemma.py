"""Port parity for the Gemma families: the configs, attention with Gemma-2's
options (kernels D, E and F's plain versions with scale, softcap and
window), the per-layer routing of the window, the Gemma and Gemma-2
forwards, Engine.generate and the continuous batcher.

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
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import KVCache as JaxKVCache
from llm_inference_lab_tpu.models.base import ModelConfig as JaxModelConfig
from llm_inference_lab_tpu.models.gemma import GEMMA_CONFIGS as JAX_GEMMA_CONFIGS
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops.attention import attend_xla
from llm_inference_lab_tpu.ops.paged_attention import paged_attend_xla
from llm_inference_lab_tpu.ops.pallas.flash_decode import flash_decode_attention
from llm_inference_lab_tpu.ops.pallas.flash_prefill import flash_prefill_attention
from llm_inference_lab_tpu.ops.pallas.paged_flash import paged_flash_attention
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import registry
from llm_inference_lab_tpu_torch.models import transformer as tt
from llm_inference_lab_tpu_torch.models.base import KVCache, quantize_rows
from llm_inference_lab_tpu_torch.models.gemma import GEMMA_CONFIGS
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache
from llm_inference_lab_tpu_torch.ops import attention
from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode_plain
from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash_plain

PROMPT = "The quick brown fox jumps over the lazy dog."
# Attention options of the kernel checks: a score scale other than D**-0.5,
# a softcap small enough that tanh bends the scores (|s| reaches ~5), and a
# window of 48 that the positions below cross.
OPTS = dict(scale=0.3, softcap=2.0, window=48)
# f32 and int8 caches: outputs are O(1) averages of (dequantized) N(0, 1)
# rows; the two sides sum the softmax in another order: 2e-5 absolute. bf16
# caches: the Pallas body rounds its running, unnormalized p to bf16 before
# P.V and its output to bf16, the plain version (attend_xla's order) the
# normalized probabilities and its output: 2^-7 of |ref| plus 2^-7. Over
# these inputs the gap passed 2^-7 |ref| by at most 3.7e-3, in prefill rows
# that see few keys (|ref| up to 3.3, where a bf16 step is 2^-6).
ATOL = 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -7


# ---------------------------------------------------------------- (a) configs
@pytest.mark.parametrize("name", sorted(JAX_GEMMA_CONFIGS))
def test_gemma_configs_equal_jax(name):
    """Every field of the port's config equals JAX's (dtype aside), head_dim
    included (256 for gemma-2-9b, not 3584 / 16 = 224); every JAX field the
    port has no field for holds its default, so nothing is lost."""
    ours, ref = GEMMA_CONFIGS[name], JAX_GEMMA_CONFIGS[name]
    port_fields = {f.name for f in dataclasses.fields(ours)} - {"dtype"}
    for f in port_fields:
        assert getattr(ours, f) == getattr(ref, f), (name, f)
    assert ours.head_dim == ref.head_dim
    for f in dataclasses.fields(JaxModelConfig):
        if f.name not in port_fields and f.name != "dtype":
            assert getattr(ref, f.name) == f.default, (name, f.name)
    assert set(GEMMA_CONFIGS) == set(JAX_GEMMA_CONFIGS)


def test_registry_resolves_names_as_jax_does():
    """Hub prefixes and case are stripped as in JAX get_model; an unknown
    name raises ValueError."""
    assert registry.model_key("google/Gemma-2-9B") == "gemma-2-9b"
    m = registry.create("google/gemma2-tiny", device="cpu", dtype=torch.float32)
    assert m.config.name == "gemma2-tiny" and m.config.head_dim == 32
    assert registry.create("meta-llama/llama-tiny", device="cpu").config.name == "llama-tiny"
    with pytest.raises(ValueError, match="unknown model"):
        registry.create("gemma-3-1b", device="cpu")


# ------------------------------------------------------- (b) attention kernels
def _caches(rng, kind, B, KVH, T, D):
    """K and V [B, KVH, T, D] of N(0, 1) rows as numpy: f32, bf16 (as f32
    values and a bf16 flag) or int8 with per-row scales."""
    if kind == "int8":
        out = []
        for _ in range(2):
            q, s = quantize_rows(torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D))
                                                  .astype(np.float32)))
            out += [q.numpy(), s.numpy()]
        k, ks, v, vs = out
        return k, v, ks, vs
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


def _decode_inputs(kind, D, S=2, B=2, H=4, KVH=2, T=256, seed=0):
    """Positions near 100 and 200: each row sees 48 keys of 256."""
    rng = np.random.default_rng(seed + D)
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k, v, ks, vs = _caches(rng, kind, B, KVH, T, D)
    pos = (np.array([[100], [200]]) + np.arange(S)[None]).astype(np.int32)
    return q, k, v, pos, ks, vs


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("D", [128, 256])
def test_decode_options_match_pallas(kind, D):
    """flash_decode's plain version with scale, softcap and window against
    flash_decode_attention(interpret=True) with the same options, GQA group
    2 (Gemma-2's), live rows whose windows cut the cache."""
    q, k, v, pos, ks, vs = _decode_inputs(kind, D)
    (jq, tq), (jk, tk), (jv, tv), (jp, tp), (jks, tks), (jvs, tvs) = _to(kind, q, k, v, pos, ks, vs)
    ref = flash_decode_attention(jq, jk, jv, jp, jks, jvs, interpret=True, block_t=64, **OPTS)
    _check(kind, flash_decode_plain(tq, tk, tv, tp, tks, tvs, **OPTS), ref)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("D", [128, 256])
def test_prefill_options_match_pallas(kind, D):
    """flash_prefill (its plain version) with the options against
    flash_prefill_attention(interpret=True, block_s=block_t=64): sequence 0
    prefills from 0 (its rows past 47 lose keys to the window), sequence 1
    is a chunk at 100..227; the window-skipped tiles differ per row."""
    rng = np.random.default_rng(D)
    B, S, H, KVH, T = 2, 128, 4, 2, 256
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k, v, ks, vs = _caches(rng, kind, B, KVH, T, D)
    pos = np.stack([np.arange(S), 100 + np.arange(S)]).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv), (jp, tp), (jks, tks), (jvs, tvs) = _to(kind, q, k, v, pos, ks, vs)
    ref = flash_prefill_attention(jq, jk, jv, jp, jks, jvs, interpret=True, block_s=64,
                                  block_t=64, **OPTS)
    _check(kind, attention.attend(tq, tk, tv, tp, tks, tvs, **OPTS), ref)


def _pool_inputs(kind, D, S=2, B=2, H=4, KVH=2, P=32, seed=0):
    """The decode inputs' keys in a shuffled pool of P-row pages (page 0
    unused), 8 pages a sequence: its gathered view is the contiguous cache."""
    q, k, v, pos, ks, vs = _decode_inputs(kind, D, S, B, H, KVH, seed=seed)
    M = k.shape[2] // P
    N = B * M + 1
    table = (np.random.default_rng(seed).permutation(N - 1)[: B * M].reshape(B, M) + 1)
    table = table.astype(np.int32)

    def pool(x):
        if x is None:
            return None
        tail = x.shape[3:]
        out = np.zeros((N, KVH, P, *tail), x.dtype)
        out[table.reshape(-1)] = (x.reshape(B, KVH, M, P, *tail).swapaxes(1, 2)
                                  .reshape(B * M, KVH, P, *tail))
        return out

    return q, pool(k), pool(v), pos, table, pool(ks), pool(vs)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("D", [128, 256])
def test_paged_options_match_pallas(kind, D):
    """paged_flash's plain version with the options against
    paged_flash_attention(interpret=True) over shuffled 32-row pages (the
    window's page sweep starts past the first pages)."""
    q, kp, vp, pos, table, ksp, vsp = _pool_inputs(kind, D)
    conv = _to(kind, q, kp, vp, pos, table, ksp, vsp)
    (jq, tq), (jk, tk), (jv, tv), (jp, tp), (jt_, tt_), (jks, tks), (jvs, tvs) = conv
    ref = paged_flash_attention(jq, jk, jv, jp, jks, jvs, jt_, interpret=True, **OPTS)
    _check(kind, paged_flash_plain(tq, tk, tv, tp, tt_, tks, tvs, **OPTS), ref)


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_options_match_xla_with_dead_row(kind, paged):
    """attend / paged_attend with the options against attend_xla /
    paged_attend_xla at D=256, with a dead row (position -1) that must be
    exactly zero."""
    if paged:
        q, kp, vp, pos, table, ksp, vsp = _pool_inputs(kind, 256, S=5, seed=3)
        pos[1, 0] = -1
        ref = paged_attend_xla(*(jnp.asarray(a) if a is not None else None
                                 for a in (q, kp, vp, pos, ksp, vsp, table)), **OPTS)
        got = attention.paged_attend(*(torch.from_numpy(a) if a is not None else None
                                       for a in (q, kp, vp, pos, table, ksp, vsp)), **OPTS)
    else:
        q, k, v, pos, ks, vs = _decode_inputs(kind, 256, S=5, seed=3)
        pos[1, 0] = -1
        args = (q, k, v, pos, ks, vs)
        ref = attend_xla(*(jnp.asarray(a) if a is not None else None for a in args), **OPTS)
        got = attention.attend(*(torch.from_numpy(a) if a is not None else None for a in args),
                               **OPTS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    assert np.all(got.numpy()[1, 0] == 0.0)


def test_window_binds_only_past_the_window():
    """A window no shorter than the cache changes nothing (the wrappers drop
    it); a shorter one masks exactly the keys at or below p - window."""
    q, k, v, pos, _, _ = _decode_inputs("f32", 128, S=1)
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, k, v, pos))
    full = flash_decode_plain(tq, tk, tv, tp)
    assert torch.equal(flash_decode_plain(tq, tk, tv, tp, window=256), full)
    # Positions 100 and 200, window 200: row 0 sees [0, 100] as before, row 1
    # sees (0, 200], which is the cache without key 0 at position 199.
    win = flash_decode_plain(tq, tk, tv, tp, window=200)
    assert torch.equal(win[:1], full[:1])
    cut = flash_decode_plain(tq, tk[:, :, 1:], tv[:, :, 1:], tp - 1)
    np.testing.assert_allclose(win[1:].numpy(), cut[1:].numpy(), rtol=0, atol=1e-6)
    assert not np.allclose(win[1:].numpy(), full[1:].numpy(), rtol=0, atol=1e-4)


# ----------------------------------------------------------------- (c) routing
def _spy_attention(monkeypatch):
    calls = []
    for name in ("flash_decode", "flash_prefill", "paged_flash"):
        fn = getattr(attention, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, a[0].shape[1], kw))
            return _fn(*a, **kw)
        monkeypatch.setattr(attention, name, wrapped)
    return calls


@pytest.mark.parametrize("paged", [False, True])
def test_gemma2_layers_route_the_window(monkeypatch, paged):
    """gemma2-tiny over a 128-position cache: even layers pass the window
    (16), odd layers do not; every layer passes the scale 24**-0.5 and the
    softcap 50. Over a 16-position cache the window cannot bind and no layer
    passes it."""
    calls = _spy_attention(monkeypatch)
    model = registry.create("gemma2-tiny", device="cpu", dtype=torch.float32)
    cfg = model.config
    for T in (128, 16):
        calls.clear()
        cache = (PagedKVCache.create(cfg, 1, T, "cpu", page_size=16) if paged
                 else KVCache.create(cfg, 1, T, "cpu"))
        S = 12
        toks = torch.arange(S, dtype=torch.int32)[None]
        model.forward(toks, toks, cache, torch.zeros(1, dtype=torch.int32))
        assert [c[0] for c in calls] == ["paged_flash" if paged else "flash_decode"] * 4
        for layer, (_, s, kw) in enumerate(calls):
            assert s == S and kw["scale"] == 24.0 ** -0.5 and kw["softcap"] == 50.0
            assert kw.get("window") == (16 if layer % 2 == 0 and T > 16 else None)


def test_unported_options_still_raise():
    """The tree mask with a window that can bind raises, as JAX's forward
    refuses it (attend_xla's tree branch has no window), on a contiguous
    cache and on pages. The ring cache runs on a contiguous cache
    (tests/test_torch_mistral.py holds it to JAX) and is refused on pages,
    as in JAX."""
    q, k, v, pos, _, _ = (torch.from_numpy(a) if a is not None else None
                          for a in _decode_inputs("f32", 128, S=1))
    assert torch.isfinite(attention.attend(q, k, v, pos, window=16, ring_len=64)).all()
    tree = dict(tree_mask=torch.ones(1, 1, dtype=torch.bool),
                chunk_start=torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        attention.attend(q, k, v, pos, window=16, **tree)
    pool = k.reshape(-1, 2, 32, 128)[:9]
    table = torch.arange(1, 9, dtype=torch.int32)[None].repeat(2, 1)
    with pytest.raises(NotImplementedError):
        attention.paged_attend(q, pool, pool, pos, table, window=16, **tree)
    with pytest.raises(TypeError):  # paged_attend takes no ring_len
        attention.paged_attend(q, pool, pool, pos, table, window=16, ring_len=64)


# ----------------------------------------------------------------- (d) forward
def _jax_params(name, seed, dtype=jnp.float32, mult=10):
    """The JAX factory's random init, projections times mult and norms
    jittered (N(0, 0.3) on their (w - 1) storage), so that every op
    matters."""
    m = get_model(name, "hf", rng=jax.random.PRNGKey(seed), dtype=dtype)
    rng = np.random.default_rng(seed)

    def scale(path, a):
        if "norm" in jax.tree_util.keystr(path):
            return a + jnp.asarray(rng.normal(0, 0.3, a.shape), a.dtype)
        return a * mult if a.ndim >= 2 else a

    return m, jax.tree_util.tree_map_with_path(scale, m.params)


def test_convert_carries_the_gemma2_tree_unchanged():
    """params_from_jax keeps every leaf of the gemma2 tree (the post-norm
    stacks and the bf16 tied embedding included) with the same bits."""
    _, params = _jax_params("gemma2-tiny", 0, jnp.bfloat16)
    tparams = params_from_jax(params)
    assert set(tparams["layers"]) >= {"post_attn_norm_scale", "post_mlp_norm_scale"}
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16))


@pytest.mark.parametrize("name", ["gemma2-tiny", "gemma-tiny"])
def test_gemma_forward_matches_jax(name):
    """f32 forward of a 40-token prompt (gemma2-tiny's window of 16 binds,
    its query_pre_attn_scalar 24 is not its head_dim 32) and then a 3-row
    verify chunk over the cache: logits within 5e-5 of the largest logit
    (f32 sums in another order, as tests/test_torch_slice.py holds the Llama
    forward), and the cached keys within 1e-5 of the largest."""
    m, params = _jax_params(name, 1)
    jcfg, tparams = m.config, params_from_jax(params)
    tcfg = registry.create(name, device="cpu", dtype=torch.float32, params=tparams).config
    T, P = 128, 40
    rng = np.random.default_rng(2)
    jcache, tcache = JaxKVCache.create(jcfg, 1, T), KVCache.create(tcfg, 1, T, "cpu")
    for toks, start in ((rng.integers(0, 256, (1, P)), 0), (rng.integers(0, 256, (1, 3)), P)):
        toks = toks.astype(np.int32)
        pos = (start + np.arange(toks.shape[1], dtype=np.int32))[None]
        lens = np.array([start], np.int32)
        jl, jcache = jt.forward(jcfg, params, jnp.asarray(toks), jnp.asarray(pos), jcache,
                                jnp.asarray(lens))
        tl, tcache = tt.forward(tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos),
                                tcache, torch.from_numpy(lens))
        ref = np.asarray(jl)
        assert np.abs(ref).max() > 2.0  # the comparison is not vacuous
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0, atol=5e-5 * np.abs(ref).max())
    ref_k = np.asarray(jcache.k)[:, :, :, : P + 3]
    np.testing.assert_allclose(tcache.k.numpy()[:, :, :, : P + 3], ref_k, rtol=0,
                               atol=1e-5 * np.abs(ref_k).max())


def test_gemma2_bf16_forward_gap():
    """The same forward in bf16: the two libraries round at other places
    (JAX's gelu on bf16 rounds inside its tanh formula, torch's computes in
    f32 and rounds once). Both heads keep their logits in f32. Measured gap:
    1.31% of the largest logit for gemma2-tiny (the same with the head's
    logits in f32 as with them rounded to bf16: the gelu rounding is the
    gap), so the tolerance is 2.0% of the largest logit (1.5x the
    measurement), with the same greedy token at every row."""
    m, params = _jax_params("gemma2-tiny", 1, jnp.bfloat16)
    tparams = params_from_jax(params)
    tcfg = registry.create("gemma2-tiny", device="cpu", params=tparams).config
    toks = np.random.default_rng(2).integers(0, 256, (1, 40)).astype(np.int32)
    pos = np.arange(40, dtype=np.int32)[None]
    lens = np.zeros(1, np.int32)
    jl, _ = jt.forward(m.config, params, jnp.asarray(toks), jnp.asarray(pos),
                       JaxKVCache.create(m.config, 1, 128), jnp.asarray(lens))
    tl, _ = tt.forward(tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos),
                       KVCache.create(tcfg, 1, 128, "cpu"), torch.from_numpy(lens))
    ref, got = np.asarray(jl, np.float32), tl.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0e-2 * np.abs(ref).max())
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# ------------------------------------------------------------ (e) generate
def _tiny(seed, mix_with=None):
    """gemma2-tiny from the JAX factory with jittered norms and unscaled
    projections (at x10 the Gemma-2 head makes greedy decoding repeat one
    token); the draft mixes in a second model so it agrees with the target
    only some of the time."""
    m, params = _jax_params("gemma2-tiny", seed, mult=1)
    if mix_with is not None:
        other = _jax_params("gemma2-tiny", mix_with, mult=1)[1]
        params = jax.tree_util.tree_map(lambda a, b: 0.9 * a + 0.1 * b, params, other)
    m.params = params
    return m


@functools.lru_cache(maxsize=1)
def _pair():
    return _tiny(1), _tiny(1, mix_with=11)


@pytest.mark.parametrize("k", [1, 4, None])
def test_gemma2_generate_equals_jax(k):
    """Engine.generate on gemma2-tiny (f32, greedy) with a 44-token prompt,
    so the window of 16 binds in the prompt's prefill and at every step:
    generated ids, steps and acceptance equal the JAX Engine's at K = 1 and
    4 and as a baseline (k None), token logprobs within 1e-4."""
    target, draft = _pair()
    cfg = dict(base_model="gemma2-tiny", draft_model="gemma2-tiny" if k else None,
               max_draft=k or 1, max_new_tokens=24, max_seq_len=256, dtype="float32")
    jr = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                   draft_model=draft if k else None).generate(PROMPT)
    eng = Engine(EngineConfig(**cfg), device="cpu", target_params=params_from_jax(target.params),
                 draft_params=params_from_jax(draft.params) if k else None)
    tr = eng.generate(PROMPT)
    assert len(eng.encode(PROMPT, 24, 256)) > eng.target.config.sliding_window
    assert tr["generated_ids"] == jr["generated_ids"]
    assert len(set(tr["generated_ids"])) > 3  # not a constant stream
    assert (tr["accepted"], tr["proposed"], tr["steps"]) == (jr["accepted"], jr["proposed"],
                                                             jr["steps"])
    if k:
        assert 0 < tr["acceptance_rate"] < 1  # partial acceptance: bonus paths run
    np.testing.assert_allclose(tr["token_logprobs"], jr["token_logprobs"], rtol=0, atol=1e-4)


# ------------------------------------------------------------- (f) serving
SERVE = dict(base_model="gemma2-tiny", draft_model="gemma2-tiny", max_draft=2,
             max_new_tokens=16, max_seq_len=256, dtype="float32")
# Six requests of 15 to 150 byte tokens (the window binds in all but the
# first's prefill): three queue behind the three slots.
REQUESTS = [("serving parity " * n, m) for n, m in ((1, 5), (4, 16), (10, 9), (2, 12), (7, 20),
                                                    (3, 7))]


def _drive(b, step, retire):
    """Admit, then one decode step per poll, retire, admit, until every slot
    is empty (the schedule tests/test_torch_serving.py gives both
    batchers)."""
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
def test_gemma2_batcher_matches_jax(layout, page_size):
    """The port's ContinuousBatcher against the JAX one on gemma2-tiny, K=2,
    3 slots, 6 requests, one step per poll: per request, generated ids,
    proposed, accepted and finish reason are equal; token logprobs within
    1e-4 and prompt logprobs within 1e-4 + 3e-5 |lp| (the f32 gap of the two
    forwards, tests/test_torch_serving.py)."""
    target, draft = _pair()
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", kv_layout=layout,
                                     kv_page_size=page_size, kv_lazy_pages=False, **SERVE),
                     target_model=target, draft_model=draft)
    jb = JaxBatcher(jeng, n_slots=3)
    want = _drive(jb, lambda: jb.step_chunk(1), jb._retire_finished)
    eng = Engine(EngineConfig(kv_layout=layout, kv_page_size=page_size, **SERVE), device="cpu",
                 target_params=params_from_jax(target.params),
                 draft_params=params_from_jax(draft.params))
    b = ContinuousBatcher(eng, n_slots=3)
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

"""Port parity for the five families beside Llama, Gemma and Mistral: Qwen2
(q/k/v bias, a GQA group of 7), Phi-3 (untied head), Mixtral (routed
experts), GPT-2 and OPT (LayerNorm with biases, learned positions with
OPT's offset of 2, a plain gelu or relu MLP with biases), against the JAX
package on the CPU.

Tiny variants: phi3-tiny and mixtral-tiny are presets of both packages;
qwen2.5-0.5b, gpt2 and opt-125m are cut to 2 layers and narrow widths
with dataclasses.replace (qwen2-test keeps 14 query heads over 2 KV heads
and the bias, opt-test its position offset), registered under test names in
both packages' preset tables for the duration of a test. Weights are the
JAX factory's f32 init with every projection times 10 and every norm,
bias and router jittered (so each op matters), carried over with
convert.params_from_jax.
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
from llm_inference_lab_tpu.models import gpt2 as j_gpt2
from llm_inference_lab_tpu.models import mixtral as j_mixtral
from llm_inference_lab_tpu.models import opt as j_opt
from llm_inference_lab_tpu.models import phi3 as j_phi3
from llm_inference_lab_tpu.models import qwen2 as j_qwen2
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import KVCache as JaxKVCache
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops.quant import quantize_params as jax_quantize
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import gpt2, mixtral, opt, phi3, qwen2, registry
from llm_inference_lab_tpu_torch.models import transformer as tt
from llm_inference_lab_tpu_torch.models.base import KVCache
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_lazy_pages import drive, same_results

# (port table, JAX table) of each new family.
TABLES = {"qwen2": (qwen2.QWEN2_CONFIGS, j_qwen2.QWEN2_CONFIGS),
          "phi3": (phi3.PHI3_CONFIGS, j_phi3.PHI3_CONFIGS),
          "mixtral": (mixtral.MIXTRAL_CONFIGS, j_mixtral.MIXTRAL_CONFIGS),
          "gpt2": (gpt2.GPT2_CONFIGS, j_gpt2.GPT2_CONFIGS),
          "opt": (opt.OPT_CONFIGS, j_opt.OPT_CONFIGS)}
NARROW = dict(n_layers=2, d_ff=128, vocab_size=256, max_position_embeddings=512)
# Test variant -> (family, preset it is cut from, the cut).
VARIANTS = {
    "qwen2-test": ("qwen2", "qwen2.5-0.5b", dict(NARROW, n_heads=14, n_kv_heads=2, d_model=112)),
    "gpt2-test": ("gpt2", "gpt2", dict(NARROW, n_heads=4, n_kv_heads=4, d_model=64)),
    "opt-test": ("opt", "opt-125m", dict(NARROW, n_heads=4, n_kv_heads=4, d_model=64)),
}
FAMILY_OF = {"phi3-tiny": "phi3", "mixtral-tiny": "mixtral",
             **{name: v[0] for name, v in VARIANTS.items()}}
MODELS = ["qwen2-test", "phi3-tiny", "mixtral-tiny", "gpt2-test", "opt-test"]


@pytest.fixture(autouse=True)
def variants(monkeypatch):
    """The test variants in both packages' preset tables (removed after the
    test)."""
    for name, (family, base, cut) in VARIANTS.items():
        for table in TABLES[family]:
            monkeypatch.setitem(table, name, dataclasses.replace(table[base], name=name, **cut))


# ------------------------------------------------------------- (a) configs
PRESETS = sorted((family, name) for family, (_, jtable) in TABLES.items() for name in jtable
                 if name not in VARIANTS)


@pytest.mark.parametrize("family,name", PRESETS)
def test_presets_equal_jax(family, name):
    """Every field of the port's preset equals JAX's (the dtype aside), and
    so do the properties use_layernorm, gated_mlp, moe and head_dim; the
    registry finds the preset by its hub name as JAX does."""
    table, jtable = TABLES[family]
    assert set(table) == set(jtable)
    tcfg, jcfg = table[name], jtable[name]
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for prop in ("use_layernorm", "gated_mlp", "moe", "head_dim"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    hub = {"qwen2": "Qwen/", "phi3": "microsoft/", "mixtral": "mistralai/",
           "gpt2": "openai-community/", "opt": "facebook/"}[family]
    assert registry.model_key(hub + name.upper()) == name


def test_registry_has_jax_families_in_order():
    """The eight families in JAX's order (registry.py), and an unknown name
    raises naming every preset."""
    from llm_inference_lab_tpu_torch.models import gemma, llama, mistral

    assert [c for c, _ in registry.FAMILIES] == [
        gpt2.GPT2_CONFIGS, llama.LLAMA_CONFIGS, opt.OPT_CONFIGS, qwen2.QWEN2_CONFIGS,
        mistral.MISTRAL_CONFIGS, mixtral.MIXTRAL_CONFIGS, gemma.GEMMA_CONFIGS, phi3.PHI3_CONFIGS]
    with pytest.raises(ValueError, match="phi-3-mini-4k-instruct"):
        registry.create("no-such-model", device="cpu")


# ------------------------------------------------------------- (b) weights
def _jitter(params, seed, mult=10):
    """Projections (and every other leaf of 2 or more axes) times mult; norm
    scales, all biases and the router plus N(0, 0.3) (JAX inits biases at
    zero)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "b_" in key or "bo" in key or "router" in key:
            return a + jnp.asarray(rng.normal(0, 0.3, a.shape), a.dtype)
        return a * mult if a.ndim >= 2 else a

    return jax.tree_util.tree_map_with_path(f, params)


@functools.lru_cache(maxsize=None)
def _jax_params(name, seed):
    return _jitter(jt.init_params(_jax_cfg(name), jax.random.PRNGKey(seed)), seed)


def _jax_cfg(name):
    family = FAMILY_OF[name]
    jtable = TABLES[family][1]
    if name in VARIANTS:
        _, base, cut = VARIANTS[name]
        return dataclasses.replace(jtable[base], name=name, dtype=jnp.float32, **cut)
    return dataclasses.replace(jtable[name], dtype=jnp.float32)


def _port_cfg(name):
    return registry.create(name, device="cpu", dtype=torch.float32, params={}).config


def _jax_model(name, seed):
    m = get_model(name, "hf", rng=jax.random.PRNGKey(seed), dtype=jnp.float32)
    m.params = _jax_params(name, seed)
    return m


def _pair(name):
    """A target, and a draft that mixes a second model into it (it agrees
    with the target some of the time)."""
    target, draft = _jax_model(name, 1), _jax_model(name, 1)
    other = _jax_params(name, 11)
    draft.params = jax.tree_util.tree_map(lambda a, b: 0.9 * a + 0.1 * b, draft.params, other)
    return target, draft


def test_variants_keep_what_the_families_need():
    """The cuts keep the wrinkles: Qwen2's bias and a group of 7, OPT's
    offset and relu, GPT-2's gelu and learned table; the port's config of
    each test model equals JAX's."""
    cfgs = {name: _port_cfg(name) for name in MODELS}
    q = cfgs["qwen2-test"]
    assert q.qkv_bias and q.n_heads // q.n_kv_heads == 7 and not q.use_learned_pos
    assert cfgs["opt-test"].pos_offset == 2 and cfgs["opt-test"].act == "relu"
    assert cfgs["gpt2-test"].act == "gelu" and cfgs["gpt2-test"].use_layernorm
    assert cfgs["mixtral-tiny"].moe and not cfgs["phi3-tiny"].tie_word_embeddings
    for name, cfg in cfgs.items():
        jcfg = _jax_cfg(name)
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, f.name)


def _leaves(tree, prefix=""):
    """{path: shape} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}{name}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("name", MODELS)
def test_init_params_leaves_match_jax(name):
    """init_params makes JAX's leaves at JAX's shapes for every family; with
    use_bias off, GPT-2 and OPT keep their LayerNorm biases and lose every
    projection bias, and the forward runs without them."""
    tcfg = _port_cfg(name)
    got = _leaves(tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert got == _leaves(jt.init_params(_jax_cfg(name), jax.random.PRNGKey(0)))
    if not tcfg.use_bias:
        return
    cfg = dataclasses.replace(tcfg, use_bias=False)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(got) - set(_leaves(params)) == {f"layers/{b}" for b in
                                               ("b_qkv", "bo", "b_fc", "b_proj")}
    toks = torch.arange(6, dtype=torch.int32).reshape(1, 6)
    logits, _ = tt.forward(cfg, params, toks, toks.clone(), KVCache.create(cfg, 1, 16, "cpu"),
                           torch.zeros(1, dtype=torch.int32))
    assert logits.shape == (1, 6, cfg.vocab_size) and torch.isfinite(logits).all()


def _forwards(name, params, quant=None):
    """A 40-token prompt in chunks of 16, 16 and 8 rows, then a 3-row verify
    chunk at rows 40..42 of 2 sequences (the second's first row dead, at
    position -1): JAX's and the port's f32 logits of each forward."""
    jcfg, tcfg = _jax_cfg(name), _port_cfg(name)
    if quant:
        params = jax_quantize(jax.tree_util.tree_map(jnp.array, params), quant, min_size=1000)
    tparams = params_from_jax(params)
    jcache, tcache = JaxKVCache.create(jcfg, 2, 64), KVCache.create(tcfg, 2, 64, "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 43)).astype(np.int32)
    out = []
    for lo, hi in ((0, 16), (16, 32), (32, 40), (40, 43)):
        pos = np.tile(np.arange(lo, hi, dtype=np.int32), (2, 1))
        if hi == 43:
            pos[1, 0] = -1
        lens = np.array([lo, lo], np.int32)
        jl, jcache = jt.forward(jcfg, params, jnp.asarray(toks[:, lo:hi]), jnp.asarray(pos),
                                jcache, jnp.asarray(lens))
        tl, tcache = tt.forward(tcfg, tparams, torch.from_numpy(toks[:, lo:hi]),
                                torch.from_numpy(pos), tcache, torch.from_numpy(lens))
        out.append((np.asarray(jl, np.float32), tl.numpy()))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name):
    """Chunked prefill and a verify chunk (contiguous cache, f32): logits
    within 5e-5 of the largest (f32 sums in another order, as
    tests/test_torch_slice.py holds the Llama forward), on every live row.
    The dead row of the learned-position families reads the table's row
    -1 + offset as jnp.take does: equal there too."""
    for ref, got in _forwards(name, _jax_params(name, 3)):
        assert np.abs(ref).max() > 1.0  # not vacuous
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name,quant", [("qwen2-test", "int4"), ("gpt2-test", "int8"),
                                        ("opt-test", "int4")])
def test_quantized_forward_matches_jax(name, quant):
    """JAX's quantize_params (min_size 1000: every projection, no bias) and
    its bytes carried over: dense adds the bias to the quantized product
    rounded to the compute dtype, as JAX's does; logits within 5e-5 of the
    largest."""
    for ref, got in _forwards(name, _jax_params(name, 3), quant):
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * np.abs(ref).max())


def test_learned_table_rows_as_jnp_take():
    """take_rows gives jnp.take's rows (its fill mode): positions -1 and -n
    count from the end, past the table (n, n + 5, -n - 1) NaN rows, in f32
    and bf16."""
    rng = np.random.default_rng(0)
    n = 12
    table = rng.normal(0, 1, (n, 8)).astype(np.float32)
    idx = np.array([[-1, 0, 5, n - 1], [n, n + 5, -n, -n - 1]], np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jnp.take(jnp.asarray(table, jdt), jnp.asarray(idx), axis=0), np.float32)
        got = tt.take_rows(torch.from_numpy(table).to(tdt), torch.from_numpy(idx)).float()
        np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isnan(ref[1, :2]).all() and np.isnan(ref[1, 3]).all()


def test_plain_mlp_gelu_is_the_tanh_approximation():
    """GPT-2's gelu is jax.nn.gelu's default, the tanh approximation (not
    torch's default erf): the port's MLP block equals JAX's to f32
    rounding, and differs from the erf form by more."""
    cfg = _port_cfg("gpt2-test")
    rng = np.random.default_rng(1)
    p = {"w_fc": rng.normal(0, 1, (64, 128)).astype(np.float32),
         "b_fc": rng.normal(0, 1, (128,)).astype(np.float32),
         "w_proj": rng.normal(0, 0.1, (128, 64)).astype(np.float32),
         "b_proj": np.zeros(64, np.float32)}
    x = rng.normal(0, 1, (1, 3, 64)).astype(np.float32)
    ref = np.asarray(jt._mlp_block(_jax_cfg("gpt2-test"),
                                   {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tt._mlp_block(cfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    erf = (torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w_fc"] + tp["b_fc"])
           @ tp["w_proj"]).numpy()
    assert np.abs(erf - ref).max() > 1e-4


# ----------------------------------------------------------- (c) the Engine
COMMON = dict(max_seq_len=256, max_new_tokens=16, dtype="float32")
PROMPT = "the cat sat on the mat. the cat sat on the mat. the cat"
RUNS = {
    "qwen2-test baseline": ("qwen2-test", dict(draft_model=None)),
    "qwen2-test vanilla K=2": ("qwen2-test", dict(draft_model="qwen2-test", max_draft=2)),
    "phi3-tiny ngram K=3": ("phi3-tiny", dict(draft_model=None, draft_mode="ngram",
                                              max_draft=3)),
    "mixtral-tiny ngram K=3": ("mixtral-tiny", dict(draft_model=None, draft_mode="ngram",
                                                    max_draft=3)),
    "gpt2-test baseline": ("gpt2-test", dict(draft_model=None)),
    "opt-test baseline": ("opt-test", dict(draft_model=None)),
}


def _engines(run, **extra):
    name, kw = RUNS[run]
    target, draft = _pair(name)
    cfg = dict(COMMON, base_model=name, **kw, **extra)
    vanilla = kw["draft_model"] is not None
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                     draft_model=draft if vanilla else None)
    eng = Engine(EngineConfig(**cfg), device="cpu", target_params=params_from_jax(target.params),
                 draft_params=params_from_jax(draft.params) if vanilla else None)
    return jeng, eng


@pytest.mark.parametrize("run", list(RUNS))
def test_generate_matches_jax(run, one_thread):  # noqa: F811
    """Engine.generate (the port on its decode loop) against JAX's Engine on
    the same weights: generated ids, accepted, proposed and steps exact;
    token and prompt logprobs within 1e-4 + 3e-5 |lp| (tests/
    test_torch_serving.py's tolerance for two f32 forwards); ngram on
    the repeating prompt accepts."""
    jeng, eng = _engines(run)
    jr, tr = jeng.generate(PROMPT), eng.generate(PROMPT)
    assert tr["generated_ids"] == jr["generated_ids"]
    assert len(set(tr["generated_ids"])) > 1  # not one token throughout
    assert (tr["accepted"], tr["proposed"], tr["steps"]) == (jr["accepted"], jr["proposed"],
                                                             jr["steps"])
    if "ngram" in run:
        assert tr["accepted"] > 0
    got = np.array(tr["token_logprobs"] + tr["prompt_logprobs"][1:])
    ref = np.array(jr["token_logprobs"] + jr["prompt_logprobs"][1:])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 + 3e-5 * np.abs(ref).max())
    assert tr["weights_source"] == "given"


def test_paged_batcher_matches_jax_and_generate(one_thread):  # noqa: F811
    """qwen2-test with its K=2 draft over 16-row pages, 3 requests through 2
    slots: the port's batcher against JAX's through the same admit /
    step_chunk / retire calls (slots' page ids, pool, stats, ids exact,
    logprobs as test_torch_lazy_pages.py's same_results), and each
    request's ids against the start of a B=1 generate of its prompt."""
    reqs = [(PROMPT, 12), ("a different prompt here", 9), ("one more: " * 3, 14)]
    jeng, eng = _engines("qwen2-test vanilla K=2", kv_layout="paged", kv_page_size=16,
                         eos_token_id=-1)
    jb, b = JaxBatcher(jeng, n_slots=2), ContinuousBatcher(eng, n_slots=2)
    want, jtrace = drive(jb, reqs)
    got, trace = drive(b, reqs)
    same_results(got, want, trace, jtrace, jb, b)
    for (prompt, budget), r in zip(reqs, (got[rid] for rid in sorted(got))):
        assert len(r["generated_ids"]) == budget
        assert r["generated_ids"] == eng.generate(prompt)["generated_ids"][:budget]


def test_moe_quantization_is_refused():
    """JAX's quantize_params quantizes Mixtral's router once it passes
    min_size (a real Mixtral's [32, 4096, 8] does), and its routing then
    fails; the port's Engine refuses weight quantization on a MoE model,
    and quantized random init of the experts as JAX does."""
    params = _jax_params("mixtral-tiny", 3)
    q = jax_quantize(jax.tree_util.tree_map(jnp.array, params), "int8", min_size=0)
    jcfg = _jax_cfg("mixtral-tiny")
    with pytest.raises(Exception):
        jt.forward(jcfg, q, jnp.zeros((1, 2), jnp.int32), jnp.zeros((1, 2), jnp.int32),
                   JaxKVCache.create(jcfg, 1, 8), jnp.zeros((1,), jnp.int32))
    for kw in (dict(quantization="int8"), dict(quantization="int4", quantized_init=True)):
        with pytest.raises(NotImplementedError):
            Engine(EngineConfig(base_model="mixtral-tiny", draft_model=None, **COMMON, **kw),
                   device="cpu")

"""The port's fused residual add + rms_norm against the JAX package, on the
CPU (the plain version, which the kernel csrc/rms_norm.cu is held to bit for
bit on the card), and the forward that uses it.

add_rms_norm(x, a, w, eps, one_offset, post_w) is JAX's layer-loop step
`x = x + a; n = rms_norm(x, w)` (transformer.py:424-435), with Gemma-2's
sandwich norm `a = rms_norm(a, post_w)` before the add. Inputs from a numpy
seed, f32 and bf16, with and without Gemma's one_offset weights. The
residual: exact (both libraries round the sum once to the dtype); with a
post norm, torch's add of JAX's a' is JAX's residual exactly, the port's
a' is held to the norm's tolerance, and the norm is compared with JAX's norm
of the port's residual. The norm: f32 within
2^-20 of each output's magnitude, bf16 within one bf16 step and equal for
at least 99% of elements, as tests/test_torch_norm.py holds rms_norm (the
mean of N squares is summed in another order).

Then the restructured forward: for a small int4 Llama and gemma2-tiny it
equals the unfused layer loop (every norm by itself, torch's residual adds)
bit for bit, calls rms_norm once and add_rms_norm twice a layer, and stays
within tests/test_torch_slice.py's and tests/test_torch_gemma.py's
tolerances of the JAX forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import KVCache as JaxKVCache
from llm_inference_lab_tpu.models.base import ModelConfig as JaxModelConfig
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.models import registry
from llm_inference_lab_tpu_torch.models import transformer as tt
from llm_inference_lab_tpu_torch.models.base import KVCache, ModelConfig, cache_slots
from llm_inference_lab_tpu_torch.ops import rms_norm as rn
from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant


def _within_norm_tolerance(dtype, got, ref):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -20, atol=0)
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= step)
        assert np.mean(got != ref) < 0.01


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("one_offset", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rms_norm_plain_matches_jax(dtype, one_offset, post):
    rng = np.random.default_rng(12 + 2 * one_offset + post)
    M, N = 37, 1024
    x = (rng.normal(0, 3, (M, N)) + rng.normal(0, 1, (M, 1))).astype(np.float32)
    a = rng.normal(0, 2, (M, N)).astype(np.float32)
    w = rng.normal(0 if one_offset else 1, 0.1, (N,)).astype(np.float32)
    pw = rng.normal(0 if one_offset else 1, 0.3, (N,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, ja, jw, jpw = (jnp.asarray(v).astype(jdt) for v in (x, a, w, pw))
    if post:
        ja = jt.rms_norm(ja, jpw, 1e-6, one_offset)
    jres = jx + ja
    jnorm = jt.rms_norm(jres, jw, 1e-6, one_offset)
    tx, ta, tw, tpw = (torch.from_numpy(v).to(tdt) for v in (x, a, w, pw))
    res, norm = rn.add_rms_norm(tx, ta, tw, 1e-6, one_offset, tpw if post else None)
    assert res.dtype == norm.dtype == tdt and res.shape == norm.shape == x.shape
    if post:  # torch's add of JAX's a' is JAX's residual; the port's a' is within tolerance
        ja_t = torch.from_numpy(np.asarray(ja.astype(jnp.float32))).to(tdt)
        jres_t = torch.from_numpy(np.asarray(jres.astype(jnp.float32))).to(tdt)
        assert torch.equal(tx + ja_t, jres_t)
        a_port = rn.rms_norm_plain(ta, tpw, 1e-6, one_offset)
        assert torch.equal(res, tx + a_port)
        _within_norm_tolerance(dtype, a_port.float().numpy(), np.asarray(ja.astype(jnp.float32)))
        # The norm against JAX's norm of the port's residual (the two
        # residuals part where the a' do, by far more than the norm's
        # rounding wherever x + a' nearly cancels).
        jnorm = jt.rms_norm(jnp.asarray(res.float().numpy()).astype(jdt), jw, 1e-6, one_offset)
    else:
        np.testing.assert_array_equal(res.float().numpy(), np.asarray(jres.astype(jnp.float32)))
    _within_norm_tolerance(dtype, norm.float().numpy(), np.asarray(jnorm.astype(jnp.float32)))


def test_add_rms_norm_dispatches_by_device():
    """On a CPU tensor the wrapper is the plain version, which is the
    unfused composition bit for bit, and counts no launch."""
    rng = np.random.default_rng(3)
    x, a = (torch.from_numpy(rng.normal(0, 1, (5, 64)).astype(np.float32)).bfloat16()
            for _ in "xa")
    w, pw = torch.ones(64).bfloat16(), torch.full((64,), 0.5).bfloat16()
    before = rn.add_rms_norm.launches
    for post_w in (None, pw):
        res, norm = rn.add_rms_norm(x, a, w, 1e-5, False, post_w)
        a2 = a if post_w is None else rn.rms_norm_plain(a, pw, 1e-5)
        assert torch.equal(res, x + a2)
        assert torch.equal(norm, rn.rms_norm_plain(x + a2, w, 1e-5))
    assert rn.add_rms_norm.launches == before
    assert tt.add_rms_norm is rn.add_rms_norm


def _unfused_forward(cfg, params, tokens, positions, cache, cache_lens):
    """The port's layer loop before the fusion: every norm on its own,
    torch's residual adds, Gemma-2's sandwich norms between."""
    embed = params["embed"]
    x = embed.lookup(tokens, cfg.dtype) if isinstance(embed, EmbedQuant) else \
        embed[tokens].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * tt._embed_multiplier(cfg.d_model, cfg.dtype)
    cos, sin = tt.rope_tables(cfg, positions)
    slots = cache_slots(cache_lens, tokens.shape[1], cache.max_seq_len, cfg.kv_ring_len)

    def norm(h, w):
        return rn.rms_norm(h, w, cfg.rms_norm_eps, cfg.rms_one_offset)

    for i in range(cfg.n_layers):
        p = tt._layer_params(params["layers"], i)
        a = tt._attn_block(cfg, p, norm(x, p["attn_norm_scale"]), positions, cos, sin, cache, i,
                           slots)
        if cfg.post_norms:
            a = norm(a, p["post_attn_norm_scale"])
        x = x + a
        h = tt._mlp_block(cfg, p, norm(x, p["mlp_norm_scale"]))
        if cfg.post_norms:
            h = norm(h, p["post_mlp_norm_scale"])
        x = x + h
    return tt.lm_head_logits(cfg, params, norm(x, params["final_norm_scale"]))


def _llama_int4():
    """tests/test_torch_slice.py's small int4 Llama (x10 weights, int8
    embedding and tied head), f32 activations."""
    kw = dict(vocab_size=512, n_layers=2, n_heads=2, n_kv_heads=1, d_model=256, d_ff=512,
              rope_theta=500000.0, rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192))
    jcfg = JaxModelConfig(name="t", arch="llama", dtype=jnp.float32, **kw)
    params = jt.init_params(jcfg, jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(lambda a: a * 10 if a.ndim >= 2 else a, params)
    params = jq.quantize_params(params, "int4", min_size=0)
    params["embed"] = jq.quantize_embed(params["embed"])
    return jcfg, params, ModelConfig(name="t", dtype=torch.float32, **kw), params_from_jax(params)


def _gemma2_tiny(dtype):
    """tests/test_torch_gemma.py's gemma2-tiny: x10 projections, jittered norms."""
    m = get_model("gemma2-tiny", "hf", rng=jax.random.PRNGKey(1), dtype=dtype)
    rng = np.random.default_rng(1)

    def scale(path, a):
        if "norm" in jax.tree_util.keystr(path):
            return a + jnp.asarray(rng.normal(0, 0.3, a.shape), a.dtype)
        return a * 10 if a.ndim >= 2 else a

    params = jax.tree_util.tree_map_with_path(scale, m.params)
    tparams = params_from_jax(params)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tcfg = registry.create("gemma2-tiny", device="cpu", dtype=tdt, params=tparams).config
    return m.config, params, tcfg, tparams


@pytest.mark.parametrize("model", ["llama int4", "gemma2-tiny", "gemma2-tiny bf16"])
def test_forward_is_the_unfused_loop_and_matches_jax(model, monkeypatch):
    """A prefill (32 tokens for the Llama, 40 for gemma2-tiny, whose window
    of 16 binds) and a 3-row verify chunk over the cache: logits
    bit for bit those of the unfused loop; one rms_norm and 2 * n_layers
    add_rms_norm calls a forward; f32 logits within 5e-5 of the largest JAX
    logit (tests/test_torch_slice.py, tests/test_torch_gemma.py), bf16
    within 2.0% with the same greedy token (test_gemma2_bf16_forward_gap)."""
    if model == "llama int4":
        jcfg, params, tcfg, tparams = _llama_int4()
    else:
        jcfg, params, tcfg, tparams = _gemma2_tiny(
            jnp.bfloat16 if model.endswith("bf16") else jnp.float32)
    calls = {"rms_norm": 0, "add_rms_norm": 0}

    def spy(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(tt, "rms_norm", spy("rms_norm", tt.rms_norm))
    monkeypatch.setattr(tt, "add_rms_norm", spy("add_rms_norm", tt.add_rms_norm))
    # Each model's inputs as the file it comes from makes them.
    T, P, seed, vocab = (128, 32, 0, 512) if model == "llama int4" else (128, 40, 2, 256)
    rng = np.random.default_rng(seed)
    jcache = JaxKVCache.create(jcfg, 1, T)
    tcache, ucache = (KVCache.create(tcfg, 1, T, "cpu") for _ in "tu")
    for toks, start in ((rng.integers(0, vocab, (1, P)), 0), (rng.integers(0, vocab, (1, 3)), P)):
        toks = toks.astype(np.int32)
        pos = (start + np.arange(toks.shape[1], dtype=np.int32))[None]
        lens = np.array([start], np.int32)
        calls.update(rms_norm=0, add_rms_norm=0)
        tl, tcache = tt.forward(tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos),
                                tcache, torch.from_numpy(lens))
        assert calls == {"rms_norm": 1, "add_rms_norm": 2 * tcfg.n_layers}, calls
        ul = _unfused_forward(tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos),
                              ucache, torch.from_numpy(lens))
        assert torch.equal(tl, ul)
        assert torch.equal(tcache.k, ucache.k) and torch.equal(tcache.v, ucache.v)
        jl, jcache = jt.forward(jcfg, params, jnp.asarray(toks), jnp.asarray(pos), jcache,
                                jnp.asarray(lens))
        ref, got = np.asarray(jl, np.float32), tl.numpy()
        assert np.abs(ref).max() > 0.5  # the comparison is not vacuous
        if model.endswith("bf16"):
            np.testing.assert_allclose(got, ref, rtol=0, atol=2.0e-2 * np.abs(ref).max())
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * np.abs(ref).max())

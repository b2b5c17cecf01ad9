"""Port parity for the whole slice: the Llama forward, Engine.generate, and
the port's own rules (no JAX imports, no silent CPU fallback).

Parameters made by the JAX package are carried over with
convert.params_from_jax, so both sides compute with the same weights.
"""

import re
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import KVCache as JaxKVCache
from llm_inference_lab_tpu.models.base import ModelConfig as JaxModelConfig
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import transformer as tt
from llm_inference_lab_tpu_torch.models.base import KVCache, ModelConfig

ROOT = Path(__file__).resolve().parent.parent
PROMPT = "The quick brown fox jumps over the lazy dog."


def test_rope_frequencies_identical():
    for D, theta, scaling in [(128, 500000.0, ("llama3", 32.0, 1.0, 4.0, 8192)),
                              (64, 500000.0, ("llama3", 32.0, 1.0, 4.0, 8192)),
                              (16, 10000.0, None)]:
        np.testing.assert_array_equal(tt._rope_inv_freq_np(D, theta, scaling),
                                      jt._rope_inv_freq(D, theta, scaling))


def test_int4_forward_matches_jax():
    """(e) a small int4 Llama (2 layers, d_model 256, 2 heads of 128, 1 KV
    head, d_ff 512, vocab 512, llama3 rope) with an int8 embedding/tied
    head, f32 activations: prefill logits and then K+1 = 3 verify-chunk
    logits over the cache match the JAX forward. Tolerance 5e-5 of the
    largest logit (|logit| up to ~13): f32 sums in another order, amplified
    through two layers of x10 weights; XLA's CPU dot changes its order with
    the load on the machine, and differences of 1.4e-5 of it were seen."""
    kw = dict(vocab_size=512, n_layers=2, n_heads=2, n_kv_heads=1, d_model=256, d_ff=512,
              rope_theta=500000.0, rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192))
    jcfg = JaxModelConfig(name="t", arch="llama", dtype=jnp.float32, **kw)
    tcfg = ModelConfig(name="t", dtype=torch.float32, **kw)
    params = jt.init_params(jcfg, jax.random.PRNGKey(3))
    # Larger weights than the 0.02 init so attention and the MLP matter.
    params = jax.tree_util.tree_map(lambda a: a * 10 if a.ndim >= 2 else a, params)
    params = jq.quantize_params(params, "int4", min_size=0)
    params["embed"] = jq.quantize_embed(params["embed"])
    tparams = params_from_jax(params)
    assert tparams["layers"]["w_qkv"].bits == 4

    T, P = 128, 32
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 512, (1, P)).astype(np.int32)
    chunk = rng.integers(0, 512, (1, 3)).astype(np.int32)
    jcache = JaxKVCache.create(jcfg, 1, T)
    tcache = KVCache.create(tcfg, 1, T, "cpu")
    calls = [(prompt, np.arange(P, dtype=np.int32)[None], 0),
             (chunk, np.arange(P, P + 3, dtype=np.int32)[None], P)]
    for toks, pos, start in calls:
        lens = np.array([start], np.int32)
        jl, jcache = jt.forward(jcfg, params, jnp.asarray(toks), jnp.asarray(pos), jcache,
                                jnp.asarray(lens))
        tl, tcache = tt.forward(tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos),
                                tcache, torch.from_numpy(lens))
        assert tl.dtype == torch.float32 and tl.shape == (1, toks.shape[1], 512)
        ref = np.asarray(jl)
        assert np.abs(ref).max() > 0.5  # the comparison is not vacuous
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0, atol=5e-5 * np.abs(ref).max())
    # Cached keys reach O(50) at this weight scale: tolerance 1e-5 of the
    # largest magnitude (f32 sums in another order).
    ref_k = np.asarray(jcache.k)[:, :, :, : P + 3]
    np.testing.assert_allclose(tcache.k.numpy()[:, :, :, : P + 3], ref_k, rtol=0,
                               atol=1e-5 * np.abs(ref_k).max())


def _tiny(seed: int, mix_with: int = None):
    """llama-tiny from the JAX factory, weights scaled x10 so greedy
    generation is not a constant token; the draft mixes in a second model so
    it agrees with the target only some of the time."""
    def make(s):
        m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(s), dtype=jnp.float32)
        return jax.tree_util.tree_map(lambda a: a * 10 if a.ndim >= 2 else a, m.params)

    m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(seed), dtype=jnp.float32)
    m.params = make(seed)
    if mix_with is not None:
        other = make(mix_with)
        m.params = jax.tree_util.tree_map(lambda a, b: 0.95 * a + 0.05 * b, m.params, other)
    return m


@pytest.mark.parametrize("k", [1, 2, 4])
def test_engine_generated_ids_equal_jax(k):
    """(f) the JAX Engine and the port's Engine on llama-tiny target and
    draft, f32, greedy, same params: generated_ids are equal, and the port's
    speculative output equals its own baseline (draft_model=None) output."""
    target, draft = _tiny(0), _tiny(0, mix_with=1)
    cfg = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=k,
               max_new_tokens=24, max_seq_len=256, dtype="float32")
    jr = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                   draft_model=draft).generate(PROMPT)
    tparams, dparams = params_from_jax(target.params), params_from_jax(draft.params)
    eng = Engine(EngineConfig(**cfg), device="cpu", target_params=tparams, draft_params=dparams)
    tr = eng.generate(PROMPT)
    assert tr["generated_ids"] == jr["generated_ids"]
    assert len(set(tr["generated_ids"])) > 3  # not a constant stream
    assert (tr["accepted"], tr["proposed"], tr["steps"]) == (jr["accepted"], jr["proposed"],
                                                             jr["steps"])
    assert 0 < tr["acceptance_rate"] < 1  # partial acceptance: bonus paths run
    np.testing.assert_allclose(tr["token_logprobs"], jr["token_logprobs"], rtol=0, atol=1e-4)
    base = Engine(EngineConfig(**{**cfg, "draft_model": None}), device="cpu",
                  target_params=tparams).generate(PROMPT)
    assert base["generated_ids"] == tr["generated_ids"]
    assert set(tr) >= {"generated_tokens", "tokens_per_sec", "acceptance_rate", "device",
                       "prompt_logprobs", "batch_metrics", "device_peak_mb"}
    assert tr["device"] == "cpu"


def test_engine_quantized_random_init_runs():
    """int4 quantized_init with the int8 embedding on the CPU: the main
    path's configuration at tiny size; speculative output equals baseline."""
    cfg = EngineConfig(base_model="llama-tiny", draft_model="llama-tiny", max_draft=1,
                       max_new_tokens=8, max_seq_len=256, quantization="int4",
                       quantized_init=True, quantize_embed=True)
    r = Engine(cfg, device="cpu").generate(PROMPT)
    b = Engine(replace(cfg, draft_model=None), device="cpu").generate(PROMPT)
    assert r["generated_ids"] == b["generated_ids"]
    assert r["generated_tokens"] >= 1 and np.all(np.isfinite(r["token_logprobs"]))


def test_config_rejects_unported_settings():
    with pytest.raises(ValueError):
        EngineConfig(embed_bits=6).validate()
    with pytest.raises(NotImplementedError):
        EngineConfig(quantize_embed=True, embed_bits=4).validate()
    with pytest.raises(ValueError):
        EngineConfig(quantization="int2").validate()
    with pytest.raises(ValueError):
        EngineConfig(kv_quantization="int4").validate()


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|llm_inference_lab_tpu)(\.|\s|$)",
                        re.MULTILINE)


def test_port_imports_no_jax():
    """(g) no module of the port and no line of chip_smoke.py imports JAX or
    the JAX package (checked on the source text)."""
    files = sorted((ROOT / "llm_inference_lab_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert names >= {f"llm_inference_lab_tpu_torch/{m}.py" for m in (
        "ops/sampling", "core/policies", "core/controllers", "models/fake", "core/state",
        "core/specstep", "core/engine", "core/batching", "config", "core/treespec",
        "core/head_training", "models/llama", "ops/attention", "ops/flash_decode",
        "ops/paged_flash", "convert")}
    for f in files:
        text = f.read_text()
        assert not _FORBIDDEN.search(text), f"{f} imports JAX or the JAX package"
        assert "__import__(" not in text and "importlib" not in text, f


def test_default_device_without_cuda_raises(monkeypatch):
    """(h) the entry point defaults to CUDA; without it, it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(EngineConfig(base_model="llama-tiny", draft_model=None))

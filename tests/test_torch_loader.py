"""Port parity for the loader (models/loader.py) and the port's own
safetensors reader and writer (utils/safetensors.py), against the
`safetensors` package and the JAX package's models/loader.py on the CPU:
synthetic HF-layout snapshots of every family, written here, load to the
same params in both packages; config.json maps to the same config; the
local HF cache (a temporary HF_HOME) is found the same way, and an engine
of each package decodes the same ids from it.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import loader as jloader
from llm_inference_lab_tpu.models.gemma import GEMMA_CONFIGS as J_GEMMA
from llm_inference_lab_tpu.models.gpt2 import GPT2_CONFIGS as J_GPT2
from llm_inference_lab_tpu.models.llama import LLAMA_CONFIGS as J_LLAMA
from llm_inference_lab_tpu.models.mixtral import MIXTRAL_CONFIGS as J_MIXTRAL
from llm_inference_lab_tpu.models.opt import OPT_CONFIGS as J_OPT
from llm_inference_lab_tpu.models.phi3 import PHI3_CONFIGS as J_PHI3
from llm_inference_lab_tpu.models.qwen2 import QWEN2_CONFIGS as J_QWEN2
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import loader, registry
from llm_inference_lab_tpu_torch.utils import safetensors as st
from test_torch_checkpoint import _same
from test_torch_decode_loop import one_thread  # noqa: F401

# ------------------------------------------------------- (a) the file format
DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.uint8, torch.int32,
          torch.int64, torch.bool]


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), (1, 1)][i % 4]
        raw = torch.randint(-(1 << 30), 1 << 30, shape, generator=g, dtype=torch.int64)
        if dt.is_floating_point:
            t = torch.randn(shape, generator=g).to(dt)
        elif dt == torch.bool:
            t = raw % 2 == 0
        else:
            t = raw.to(dt)
        out[f"t/{dt}".replace("torch.", "")] = t
    out["empty"] = torch.zeros((0, 4), dtype=torch.float32)
    return out


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_reader_reads_the_package_files(tmp_path):
    """Files written by the safetensors package (torch API, with metadata):
    every dtype of the reader's list byte for byte, the metadata, lazily
    one tensor at a time."""
    tensors = _tensors(0)
    path = str(tmp_path / "pkg.safetensors")
    safetensors.torch.save_file(tensors, path, metadata={"a": "1", "int4_fmt": "v2"})
    f = st.SafeFile(path)
    assert sorted(f.keys()) == sorted(tensors)
    assert f.metadata() == {"a": "1", "int4_fmt": "v2"}
    for name, t in tensors.items():
        _bits_equal(f.get(name), t)


def test_package_reads_the_writer_files(tmp_path):
    """The port's writer: the package reads every tensor byte for byte, and
    its metadata; the header is padded to 8 bytes."""
    tensors = _tensors(1)
    path = str(tmp_path / "port.safetensors")
    st.save_file(tensors, path, metadata={"quant": "{}"})
    got = safetensors.torch.load_file(path)
    assert sorted(got) == sorted(tensors)
    for name, t in tensors.items():
        _bits_equal(got[name], t)
    with safetensors.safe_open(path, framework="pt") as f:
        assert f.metadata() == {"quant": "{}"}
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    shards = st.Shards(str(tmp_path))  # a directory of one shard
    assert "t/int8" in shards and torch.equal(shards["t/int8"], tensors["t/int8"])


def test_reader_refuses_a_dtype_outside_its_list(tmp_path):
    path = str(tmp_path / "f64.safetensors")
    safetensors.numpy.save_file({"x": np.zeros(3, np.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        st.SafeFile(path).get("x")


# ------------------------------------------------- (b) HF-layout snapshots
def _hf_tensors(kind, cfg, rng):
    """HF names and layouts of a checkpoint of `cfg` (f32, N(0, 1))."""
    D, F, H, KV, Dh, L, V = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             cfg.n_layers, cfg.vocab_size)
    t = {}

    def put(name, *shape):
        t[name] = rng.normal(0, 1, shape).astype(np.float32)

    if kind == "gpt2":
        pre = "transformer."  # GPT-2 checkpoints come with and without it
        put(pre + "wte.weight", V, D)
        put(pre + "wpe.weight", cfg.max_position_embeddings, D)
        put(pre + "ln_f.weight", D), put(pre + "ln_f.bias", D)
        for i in range(L):
            h = f"{pre}h.{i}."
            for n in ("ln_1", "ln_2"):
                put(h + n + ".weight", D), put(h + n + ".bias", D)
            put(h + "attn.c_attn.weight", D, 3 * D), put(h + "attn.c_attn.bias", 3 * D)
            put(h + "attn.c_proj.weight", D, D), put(h + "attn.c_proj.bias", D)
            put(h + "mlp.c_fc.weight", D, F), put(h + "mlp.c_fc.bias", F)
            put(h + "mlp.c_proj.weight", F, D), put(h + "mlp.c_proj.bias", D)
        return t
    if kind == "opt":
        pre = "model.decoder."
        put(pre + "embed_tokens.weight", V, D)
        put(pre + "embed_positions.weight", cfg.max_position_embeddings + 2, D)
        put(pre + "final_layer_norm.weight", D), put(pre + "final_layer_norm.bias", D)
        for i in range(L):
            h = f"{pre}layers.{i}."
            for n in ("self_attn_layer_norm", "final_layer_norm"):
                put(h + n + ".weight", D), put(h + n + ".bias", D)
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                put(h + f"self_attn.{n}.weight", D, D), put(h + f"self_attn.{n}.bias", D)
            put(h + "fc1.weight", F, D), put(h + "fc1.bias", F)
            put(h + "fc2.weight", D, F), put(h + "fc2.bias", D)
        return t
    put("model.embed_tokens.weight", V, D)
    put("model.norm.weight", D)
    if not cfg.tie_word_embeddings:
        put("lm_head.weight", V, D)
    for i in range(L):
        h = f"model.layers.{i}."
        norms = ["input_layernorm", "post_attention_layernorm"]
        if cfg.post_norms:
            norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
        for n in norms:
            put(h + n + ".weight", D)
        put(h + "self_attn.o_proj.weight", D, H * Dh)
        if kind == "phi3":
            put(h + "self_attn.qkv_proj.weight", (H + 2 * KV) * Dh, D)
            put(h + "mlp.gate_up_proj.weight", 2 * F, D), put(h + "mlp.down_proj.weight", D, F)
            continue
        put(h + "self_attn.q_proj.weight", H * Dh, D)
        put(h + "self_attn.k_proj.weight", KV * Dh, D)
        put(h + "self_attn.v_proj.weight", KV * Dh, D)
        if cfg.qkv_bias:
            put(h + "self_attn.q_proj.bias", H * Dh)
            put(h + "self_attn.k_proj.bias", KV * Dh), put(h + "self_attn.v_proj.bias", KV * Dh)
        if kind == "mixtral":
            m = h + "block_sparse_moe."
            put(m + "gate.weight", cfg.n_experts, D)
            for e in range(cfg.n_experts):
                put(m + f"experts.{e}.w1.weight", F, D), put(m + f"experts.{e}.w3.weight", F, D)
                put(m + f"experts.{e}.w2.weight", D, F)
        else:
            put(h + "mlp.gate_proj.weight", F, D), put(h + "mlp.up_proj.weight", F, D)
            put(h + "mlp.down_proj.weight", D, F)
    return t


SMALL = dict(n_layers=2, d_ff=48, vocab_size=96, max_position_embeddings=64)
# Family -> (its loader in each package, the JAX config of the snapshot).
SNAPSHOTS = {
    "llama": ("load_llama_checkpoint", J_LLAMA["llama-tiny"]),
    "qwen2": ("load_llama_checkpoint",
              dataclasses.replace(J_QWEN2["qwen2.5-0.5b"], n_heads=14, n_kv_heads=2, d_model=112,
                                  tie_word_embeddings=False, **SMALL)),
    "phi3": ("load_phi3_checkpoint", J_PHI3["phi3-tiny"]),
    "mixtral": ("load_mixtral_checkpoint", dataclasses.replace(J_MIXTRAL["mixtral-tiny"],
                                                               tie_word_embeddings=False)),
    "gemma": ("load_llama_checkpoint", J_GEMMA["gemma-tiny"]),
    "gemma2": ("load_llama_checkpoint", J_GEMMA["gemma2-tiny"]),
    "gpt2": ("load_gpt2_checkpoint", dataclasses.replace(J_GPT2["gpt2"], n_heads=4, n_kv_heads=4,
                                                         d_model=32, **SMALL)),
    "opt": ("load_opt_checkpoint", dataclasses.replace(J_OPT["opt-125m"], n_heads=4, n_kv_heads=4,
                                                       d_model=32, **SMALL)),
}


def _port_config(jcfg, dtype):
    from llm_inference_lab_tpu_torch.models.base import ModelConfig

    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)
                          if f.name != "dtype"}, dtype=dtype)


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("family", list(SNAPSHOTS))
def test_snapshot_loads_as_jax_loads_it(tmp_path, family, shards):
    """A synthetic HF snapshot of each family (f32, split over `shards`
    files, written by the safetensors package) loads with the port's
    loader to the params JAX's loader gives, cast to bf16, bit for bit:
    GPT-2's Conv1D untransposed, Phi-3's fused projections, Qwen2's q/k/v
    biases concatenated, Mixtral's experts stacked, Gemma-2's norms."""
    fn, jcfg = SNAPSHOTS[family]
    kind = "mixtral" if family == "mixtral" else family
    tensors = _hf_tensors(kind, jcfg, np.random.default_rng(len(family)))
    names = sorted(tensors)
    for s in range(shards):
        safetensors.numpy.save_file({n: tensors[n] for n in names[s::shards]},
                                    str(tmp_path / f"model-{s:05d}.safetensors"))
    ref = getattr(jloader, fn)(str(tmp_path), dataclasses.replace(jcfg, dtype=jnp.bfloat16))
    got = getattr(loader, fn)(str(tmp_path), _port_config(jcfg, torch.bfloat16), "cpu")
    _same(got, params_from_jax(ref))


HF_CONFIGS = {
    "gpt2": dict(model_type="gpt2", vocab_size=50257, n_layer=12, n_head=12, n_embd=768,
                 n_positions=1024, layer_norm_epsilon=1e-5),
    "opt": dict(model_type="opt", vocab_size=50272, num_hidden_layers=12,
                num_attention_heads=12, hidden_size=768, ffn_dim=3072,
                max_position_embeddings=2048, activation_function="relu"),
    "phi3": dict(model_type="phi3", vocab_size=32064, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=32, hidden_size=3072,
                 intermediate_size=8192, max_position_embeddings=4096, sliding_window=2047),
    "llama": dict(model_type="llama", vocab_size=128256, num_hidden_layers=28,
                  num_attention_heads=24, num_key_value_heads=8, hidden_size=3072,
                  intermediate_size=8192, rope_theta=500000.0, tie_word_embeddings=True,
                  rope_scaling=dict(rope_type="llama3", factor=32.0, low_freq_factor=1.0,
                                    high_freq_factor=4.0, original_max_position_embeddings=8192)),
    "qwen2": dict(model_type="qwen2", vocab_size=151936, num_hidden_layers=24,
                  num_attention_heads=14, num_key_value_heads=2, hidden_size=896,
                  intermediate_size=4864, rope_theta=1e6, rms_norm_eps=1e-6,
                  tie_word_embeddings=True, sliding_window=32768, use_sliding_window=False),
    "mistral": dict(model_type="mistral", vocab_size=32000, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8, hidden_size=4096,
                    intermediate_size=14336, sliding_window=4096),
    "mixtral": dict(model_type="mixtral", vocab_size=32000, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8, hidden_size=4096,
                    intermediate_size=14336, num_local_experts=8, num_experts_per_tok=2,
                    rope_theta=1e6),
    "gemma": dict(model_type="gemma", vocab_size=256000, num_hidden_layers=18,
                  num_attention_heads=8, num_key_value_heads=1, hidden_size=2048,
                  intermediate_size=16384, head_dim=256),
    "gemma2": dict(model_type="gemma2", vocab_size=256000, num_hidden_layers=42,
                   num_attention_heads=16, num_key_value_heads=8, hidden_size=3584,
                   intermediate_size=14336, head_dim=256, query_pre_attn_scalar=256),
}


@pytest.mark.parametrize("mt", list(HF_CONFIGS))
def test_config_from_hf_equals_jax(mt):
    """config_from_hf gives JAX's config, field for field (the dtype aside),
    for every model type either takes; an unknown type and opt-350m's
    projections raise in both."""
    got = loader.config_from_hf(HF_CONFIGS[mt], "m", torch.bfloat16)
    ref = jloader.config_from_hf(HF_CONFIGS[mt], "m", jnp.bfloat16)
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.dtype == torch.bfloat16
    for bad in (dict(model_type="bert"), dict(HF_CONFIGS["opt"], word_embed_proj_dim=512)):
        with pytest.raises(ValueError):
            loader.config_from_hf(bad, "m", torch.bfloat16)
        with pytest.raises(ValueError):
            jloader.config_from_hf(bad, "m", jnp.bfloat16)


# --------------------------------------------------- (c) the local HF cache
QWEN_TINY_HF = dict(HF_CONFIGS["qwen2"], num_hidden_layers=2, hidden_size=112, vocab_size=256,
                    intermediate_size=128, max_position_embeddings=512)


def _snapshot(home, repo, hf, kind, scale=1.0):
    """A snapshot of `repo` under home/hub: config.json and one shard of
    synthetic weights (N(0, scale^2), norms near 1)."""
    d = os.path.join(home, "hub", f"models--{repo.replace('/', '--')}", "snapshots", "0123abc")
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    cfg = loader.config_from_hf(hf, "x", torch.float32)
    tensors = _hf_tensors(kind, cfg, np.random.default_rng(5))
    tensors = {n: (1 + 0.3 * t if "norm" in n else scale * t) for n, t in tensors.items()}
    st.save_file({n: torch.from_numpy(t) for n, t in tensors.items()},
                 os.path.join(d, "model.safetensors"))
    return d


def test_find_cached_checkpoint(tmp_path, monkeypatch):
    """Under a temporary HF_HOME both packages find a preset's snapshot by
    its hub repo (the newest snapshot directory holding .safetensors), and
    None where there is none; nothing is fetched."""
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert loader.find_cached_checkpoint("qwen2.5-0.5b") is None
    assert jloader.find_cached_checkpoint("qwen2.5-0.5b") is None
    d = _snapshot(str(tmp_path), "Qwen/Qwen2.5-0.5B-Instruct", QWEN_TINY_HF, "qwen2")
    assert loader.find_cached_checkpoint("qwen2.5-0.5b") == d
    assert jloader.find_cached_checkpoint("qwen2.5-0.5b") == d
    assert loader.resolve_hf_dir("Qwen/Qwen2.5-0.5B") is None
    for key in jloader.HF_REPO_IDS:
        assert loader.HF_REPO_IDS[key] == jloader.HF_REPO_IDS[key]
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty"))
    assert loader.find_cached_checkpoint("qwen2.5-0.5b") is None


def test_engines_decode_the_cached_snapshot_alike(tmp_path, monkeypatch):
    """Engine(base_model="qwen2.5-0.5b") with no params finds the snapshot in
    a temporary HF_HOME (its config.json: 2 layers, d_model 112), as JAX's
    does: weights_source is the snapshot's path in both, and the greedy ids
    are equal (f32, baseline). With quantized_init, or params given, the
    cache is not read."""
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    d = _snapshot(str(tmp_path), "Qwen/Qwen2.5-0.5B", QWEN_TINY_HF, "qwen2", scale=0.5)
    cfg = dict(base_model="qwen2.5-0.5b", draft_model=None, max_seq_len=128, max_new_tokens=12,
               dtype="float32")
    eng = Engine(EngineConfig(**cfg), device="cpu")
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg))
    assert eng.target.weights_source == d
    assert eng.target.config.d_model == 112 and eng.target.config.n_layers == 2
    tr, jr = eng.generate("cached weights"), jeng.generate("cached weights")
    assert tr["weights_source"] == jr["weights_source"] == d
    assert tr["generated_ids"] == jr["generated_ids"]
    given = registry.create("qwen2.5-0.5b", device="cpu", dtype=torch.float32,
                            params=params_from_jax(jeng.target.params))
    assert given.weights_source == "given"

    def read(key):
        raise AssertionError(f"the cache was read for {key}")

    monkeypatch.setattr(loader, "find_cached_checkpoint", read)
    assert registry.create("llama-tiny", device="cpu",
                           quantized_init="int8").weights_source == "random"
    assert registry.create("qwen2.5-0.5b", device="cpu", params={}).weights_source == "given"

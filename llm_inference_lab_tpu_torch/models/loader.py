"""HF safetensors checkpoints -> the port's stacked-layer params, on the
device, and the local HF cache.

Port of llm_inference_lab_tpu/models/loader.py: the per-family loaders
(Llama, Qwen2, Mistral and Gemma through ``load_llama_checkpoint``; Phi-3's
pre-fused projections; Mixtral's experts; GPT-2's Conv1D; OPT),
``HF_REPO_IDS``, ``resolve_hf_dir``, ``find_cached_checkpoint``,
``load_hf_config`` and ``config_from_hf``, with the same names, layouts
and casts: torch Linear weights [out, in] are transposed to [in, out],
GPT-2's Conv1D weights are already [in, out], per-layer tensors stack on a
leading layer axis, q/k/v and gate/up concatenate on the output axis.

The shards are read with the port's own reader (utils/safetensors.py),
tensor by tensor: each goes into its slice of a stacked tensor already on
the device before the next is read, so a model never has two host copies.
Nothing here downloads: real weights come from a local path or a snapshot
already in the local HF cache (``HF_HOME``, by default
~/.cache/huggingface).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import torch

from llm_inference_lab_tpu_torch.models.base import ModelConfig
from llm_inference_lab_tpu_torch.utils.safetensors import Shards


class _Loader:
    """Stacks named HF tensors of a checkpoint into params on `device`."""

    def __init__(self, path: str, cfg: ModelConfig, device):
        self.w = Shards(path)
        self.dt, self.L, self.device = cfg.dtype, cfg.n_layers, device

    def one(self, name: str, transpose: bool = False) -> torch.Tensor:
        t = self.w[name]
        return (t.t() if transpose else t).to(device=self.device, dtype=self.dt)

    def stack(self, fmts: List[str], transpose: bool = True,
              get: Optional[Callable[[str, int], torch.Tensor]] = None) -> torch.Tensor:
        """[L, .., sum of out] from the tensors fmts[j].format(i=layer),
        each transposed when 2-D and `transpose`, concatenated on the last
        axis in fmts' order."""
        get = get or (lambda f, i: self.w[f.format(i=i)])
        out = None
        for i in range(self.L):
            parts = [get(f, i) for f in fmts]  # one layer's parts on the host
            parts = [t.t() if transpose and t.dim() == 2 else t for t in parts]
            if out is None:
                width = sum(t.shape[-1] for t in parts)
                out = torch.empty((self.L, *parts[0].shape[:-1], width), dtype=self.dt,
                                  device=self.device)
            col = 0
            for t in parts:
                out[i, ..., col:col + t.shape[-1]].copy_(t)
                col += t.shape[-1]
        return out


def _llama_layers(ld: _Loader, cfg: ModelConfig, mlp: bool = True) -> Dict[str, torch.Tensor]:
    pre = "model.layers.{i}."
    # Gemma-2's sandwich norms rename them: the pre-MLP norm is
    # pre_feedforward_layernorm (post_attention_layernorm is then the
    # attention output's norm); everyone else's post_attention is pre-MLP.
    mlp_norm = "pre_feedforward_layernorm" if cfg.post_norms else "post_attention_layernorm"
    layers = {
        "attn_norm_scale": ld.stack([pre + "input_layernorm.weight"]),
        "mlp_norm_scale": ld.stack([pre + mlp_norm + ".weight"]),
        "w_qkv": ld.stack([pre + f"self_attn.{x}_proj.weight" for x in "qkv"]),
        "wo": ld.stack([pre + "self_attn.o_proj.weight"]),
    }
    if mlp:
        layers["w_gate_up"] = ld.stack([pre + "mlp.gate_proj.weight", pre + "mlp.up_proj.weight"])
        layers["w_down"] = ld.stack([pre + "mlp.down_proj.weight"])
    if cfg.post_norms:
        layers["post_attn_norm_scale"] = ld.stack([pre + "post_attention_layernorm.weight"])
        layers["post_mlp_norm_scale"] = ld.stack([pre + "post_feedforward_layernorm.weight"])
    if cfg.qkv_bias:  # Qwen2: the q, k and v biases, concatenated as the fused QKV
        layers["b_qkv"] = ld.stack([pre + f"self_attn.{x}_proj.bias" for x in "qkv"])
    return layers


def _llama_params(ld: _Loader, cfg: ModelConfig, layers: dict) -> dict:
    params = {"embed": ld.one("model.embed_tokens.weight"), "layers": layers,
              "final_norm_scale": ld.one("model.norm.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = ld.one("lm_head.weight", transpose=True)
    return params


def load_llama_checkpoint(path: str, cfg: ModelConfig, device="cpu") -> dict:
    """HF Llama, Qwen2, Mistral, Gemma and Gemma-2 checkpoints."""
    ld = _Loader(path, cfg, device)
    return _llama_params(ld, cfg, _llama_layers(ld, cfg))


def load_phi3_checkpoint(path: str, cfg: ModelConfig, device="cpu") -> dict:
    """HF Phi-3: self_attn.qkv_proj ([q | k | v] rows) and mlp.gate_up_proj
    ([gate | up] rows) are fused in the checkpoint already: the transpose
    is the port's fused [D, out] layout."""
    ld = _Loader(path, cfg, device)
    pre = "model.layers.{i}."
    layers = {
        "attn_norm_scale": ld.stack([pre + "input_layernorm.weight"]),
        "mlp_norm_scale": ld.stack([pre + "post_attention_layernorm.weight"]),
        "w_qkv": ld.stack([pre + "self_attn.qkv_proj.weight"]),
        "wo": ld.stack([pre + "self_attn.o_proj.weight"]),
        "w_gate_up": ld.stack([pre + "mlp.gate_up_proj.weight"]),
        "w_down": ld.stack([pre + "mlp.down_proj.weight"]),
    }
    return _llama_params(ld, cfg, layers)


def load_mixtral_checkpoint(path: str, cfg: ModelConfig, device="cpu") -> dict:
    """HF Mixtral: Llama's attention, and block_sparse_moe's router
    (gate.weight -> [L, D, E]) and experts (w1 gate and w3 up -> [L, E, D,
    2F], w2 down -> [L, E, F, D])."""
    ld = _Loader(path, cfg, device)
    layers = _llama_layers(ld, cfg, mlp=False)
    pre = "model.layers.{i}.block_sparse_moe."
    layers["w_router"] = ld.stack([pre + "gate.weight"])
    E = cfg.n_experts

    def experts(fmts):
        # [L, E, in, out]: stack over E inside each layer's slice.
        def get(f, i):
            return torch.stack([ld.w[f.format(i=i, e=e)].t() for e in range(E)])
        return ld.stack(fmts, transpose=False, get=get)

    layers["w_gate_up"] = experts([pre + "experts.{e}.w1.weight", pre + "experts.{e}.w3.weight"])
    layers["w_down"] = experts([pre + "experts.{e}.w2.weight"])
    return _llama_params(ld, cfg, layers)


def _prefixed(w: Shards, prefixes, name: str) -> str:
    for prefix in prefixes:
        if prefix + name in w:
            return prefix + name
    raise KeyError(name)


def load_gpt2_checkpoint(path: str, cfg: ModelConfig, device="cpu") -> dict:
    """HF GPT-2: Conv1D weights are [in, out] already (no transpose), and
    c_attn is the fused QKV; names with or without "transformer."."""
    ld = _Loader(path, cfg, device)
    pfx = ("", "transformer.")

    def stack(name):
        return ld.stack([name], transpose=False,
                        get=lambda f, i: ld.w[_prefixed(ld.w, pfx, f"h.{i}.{f}")])

    layers = {
        "attn_norm_scale": stack("ln_1.weight"), "attn_norm_bias": stack("ln_1.bias"),
        "mlp_norm_scale": stack("ln_2.weight"), "mlp_norm_bias": stack("ln_2.bias"),
        "w_qkv": stack("attn.c_attn.weight"), "b_qkv": stack("attn.c_attn.bias"),
        "wo": stack("attn.c_proj.weight"), "bo": stack("attn.c_proj.bias"),
        "w_fc": stack("mlp.c_fc.weight"), "b_fc": stack("mlp.c_fc.bias"),
        "w_proj": stack("mlp.c_proj.weight"), "b_proj": stack("mlp.c_proj.bias"),
    }
    top = lambda name: ld.one(_prefixed(ld.w, pfx, name))  # noqa: E731
    return {"embed": top("wte.weight"), "pos_embed": top("wpe.weight"), "layers": layers,
            "final_norm_scale": top("ln_f.weight"), "final_norm_bias": top("ln_f.bias")}


def load_opt_checkpoint(path: str, cfg: ModelConfig, device="cpu") -> dict:
    """HF OPT: torch Linear layout (transposed), q/k/v and their biases
    fused here, LayerNorm with bias, the position table whole (max_pos + 2
    rows: the forward adds pos_offset); names under "model.decoder." or
    "decoder."."""
    ld = _Loader(path, cfg, device)
    pfx = ("model.decoder.", "decoder.")

    def stack(names, transpose=False):
        return ld.stack(names, transpose=transpose,
                        get=lambda f, i: ld.w[_prefixed(ld.w, pfx, f"layers.{i}.{f}")])

    qkv = [f"self_attn.{x}_proj" for x in "qkv"]
    layers = {
        "attn_norm_scale": stack(["self_attn_layer_norm.weight"]),
        "attn_norm_bias": stack(["self_attn_layer_norm.bias"]),
        # OPT's per-layer final_layer_norm is the pre-MLP norm.
        "mlp_norm_scale": stack(["final_layer_norm.weight"]),
        "mlp_norm_bias": stack(["final_layer_norm.bias"]),
        "w_qkv": stack([n + ".weight" for n in qkv], transpose=True),
        "b_qkv": stack([n + ".bias" for n in qkv]),
        "wo": stack(["self_attn.out_proj.weight"], transpose=True),
        "bo": stack(["self_attn.out_proj.bias"]),
        "w_fc": stack(["fc1.weight"], transpose=True), "b_fc": stack(["fc1.bias"]),
        "w_proj": stack(["fc2.weight"], transpose=True), "b_proj": stack(["fc2.bias"]),
    }
    top = lambda name: ld.one(_prefixed(ld.w, pfx, name))  # noqa: E731
    params = {"embed": top("embed_tokens.weight"), "pos_embed": top("embed_positions.weight"),
              "layers": layers, "final_norm_scale": top("final_layer_norm.weight"),
              "final_norm_bias": top("final_layer_norm.bias")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = ld.one("lm_head.weight", transpose=True)
    return params


def resolve_hf_dir(name: str) -> Optional[str]:
    """A hub repo's newest snapshot directory in the local HF cache
    ($HF_HOME/hub, by default ~/.cache/huggingface/hub), if present."""
    root = os.path.expanduser(os.environ.get("HF_HOME", "~/.cache/huggingface"))
    cand = os.path.join(root, "hub", f"models--{name.replace('/', '--')}", "snapshots")
    if not os.path.isdir(cand):
        return None
    snaps = sorted(os.listdir(cand))
    return os.path.join(cand, snaps[-1]) if snaps else None


# Preset name -> candidate HF hub repo ids, the first cached one wins
# (JAX's table, and Phi-3's and Mixtral's repos).
HF_REPO_IDS = {
    "gpt2": ["gpt2", "openai-community/gpt2"],
    "distilgpt2": ["distilgpt2", "distilbert/distilgpt2"],
    "gpt2-medium": ["gpt2-medium", "openai-community/gpt2-medium"],
    "llama-3.2-1b": ["meta-llama/Llama-3.2-1B", "meta-llama/Llama-3.2-1B-Instruct"],
    "llama-3.2-3b": ["meta-llama/Llama-3.2-3B", "meta-llama/Llama-3.2-3B-Instruct"],
    "llama-3.1-8b": ["meta-llama/Llama-3.1-8B", "meta-llama/Meta-Llama-3.1-8B",
                     "meta-llama/Llama-3.1-8B-Instruct"],
    "opt-125m": ["facebook/opt-125m"],
    "opt-1.3b": ["facebook/opt-1.3b"],
    "qwen2.5-0.5b": ["Qwen/Qwen2.5-0.5B", "Qwen/Qwen2.5-0.5B-Instruct"],
    "qwen2.5-1.5b": ["Qwen/Qwen2.5-1.5B", "Qwen/Qwen2.5-1.5B-Instruct"],
    "qwen2.5-7b": ["Qwen/Qwen2.5-7B", "Qwen/Qwen2.5-7B-Instruct"],
    "gemma-2b": ["google/gemma-2b", "google/gemma-1.1-2b-it"],
    "gemma-7b": ["google/gemma-7b", "google/gemma-1.1-7b-it"],
    "gemma-2-2b": ["google/gemma-2-2b", "google/gemma-2-2b-it"],
    "gemma-2-9b": ["google/gemma-2-9b", "google/gemma-2-9b-it"],
    "mistral-7b": ["mistralai/Mistral-7B-v0.1", "mistralai/Mistral-7B-v0.3",
                   "mistralai/Mistral-7B-Instruct-v0.3"],
    "phi-3-mini-4k-instruct": ["microsoft/Phi-3-mini-4k-instruct"],
    "mixtral-8x7b": ["mistralai/Mixtral-8x7B-v0.1", "mistralai/Mixtral-8x7B-Instruct-v0.1"],
}


def find_cached_checkpoint(key: str) -> Optional[str]:
    """The snapshot directory holding .safetensors for a preset name, if the
    local HF cache has one; None otherwise (nothing is fetched)."""
    for repo in HF_REPO_IDS.get(key, [key]):
        d = resolve_hf_dir(repo)
        if d and any(f.endswith(".safetensors") for f in os.listdir(d)):
            return d
    return None


def load_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def config_from_hf(hf: dict, name: str, dtype: torch.dtype) -> ModelConfig:
    """HF config.json -> ModelConfig (JAX's config_from_hf, field for field):
    the hyperparameters of the snapshot, not of the preset."""
    mt = hf.get("model_type", "")
    if mt == "gpt2":
        return ModelConfig(
            name=name, arch="gpt2", vocab_size=hf["vocab_size"], n_layers=hf["n_layer"],
            n_heads=hf["n_head"], n_kv_heads=hf["n_head"], d_model=hf["n_embd"],
            d_ff=hf.get("n_inner") or 4 * hf["n_embd"], max_position_embeddings=hf["n_positions"],
            layer_norm_eps=hf.get("layer_norm_epsilon", 1e-5), use_learned_pos=True,
            use_bias=True, act="gelu", tie_word_embeddings=hf.get("tie_word_embeddings", True),
            dtype=dtype)
    if mt == "opt":
        if hf.get("word_embed_proj_dim", hf["hidden_size"]) != hf["hidden_size"]:
            raise ValueError("OPT checkpoints with word_embed_proj_dim != hidden_size "
                             "(opt-350m) use embed in/out projections the port does not have")
        if not hf.get("do_layer_norm_before", True):
            raise ValueError("post-norm OPT (do_layer_norm_before=False) unsupported")
        return ModelConfig(
            name=name, arch="opt", vocab_size=hf["vocab_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            n_kv_heads=hf["num_attention_heads"], d_model=hf["hidden_size"], d_ff=hf["ffn_dim"],
            max_position_embeddings=hf["max_position_embeddings"], layer_norm_eps=1e-5,
            use_learned_pos=True, use_bias=True, act=hf.get("activation_function", "relu"),
            pos_offset=2, tie_word_embeddings=hf.get("tie_word_embeddings", True), dtype=dtype)
    if mt not in ("phi3", "llama", "qwen2", "mistral", "mixtral", "gemma", "gemma2"):
        raise ValueError(f"unsupported HF model_type {mt!r}")
    common = dict(
        name=name, arch="llama", vocab_size=hf["vocab_size"], n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        d_model=hf["hidden_size"], d_ff=hf["intermediate_size"],
        rope_theta=float(hf.get("rope_theta", 10000.0)), dtype=dtype)
    if mt == "phi3":
        return ModelConfig(
            **common, max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            sliding_window=hf.get("sliding_window"))
    if mt in ("llama", "qwen2", "mistral", "mixtral"):
        rs = hf.get("rope_scaling")
        rope_scaling = None
        if rs:
            rope_scaling = (rs.get("rope_type", rs.get("type", "llama3")), float(rs["factor"]),
                            float(rs.get("low_freq_factor", 1.0)),
                            float(rs.get("high_freq_factor", 4.0)),
                            int(rs.get("original_max_position_embeddings", 8192)))
        return ModelConfig(
            **common, max_position_embeddings=hf.get("max_position_embeddings", 2048),
            rope_scaling=rope_scaling, rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            # Qwen2's biases are on q, k and v only.
            qkv_bias=mt == "qwen2" and hf.get("qkv_bias", True),
            # Mistral's window is on whenever set; Qwen2 gates it behind
            # use_sliding_window (HF's default False).
            sliding_window=(hf.get("sliding_window")
                            if mt != "qwen2" or hf.get("use_sliding_window", False) else None),
            n_experts=hf.get("num_local_experts", 0) if mt == "mixtral" else 0,
            experts_per_token=hf.get("num_experts_per_tok", 2))
    gemma = dict(
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        tie_word_embeddings=hf.get("tie_word_embeddings", True),
        head_dim_override=hf.get("head_dim", 256), embed_scale=True, rms_one_offset=True,
        act="gelu_tanh")
    if mt == "gemma2":
        return ModelConfig(
            **common, **gemma, attn_logit_softcap=hf.get("attn_logit_softcapping", 50.0),
            final_logit_softcap=hf.get("final_logit_softcapping", 30.0),
            query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar", hf.get("head_dim", 256))),
            post_norms=True, alt_window=True, sliding_window=hf.get("sliding_window", 4096))
    return ModelConfig(**common, **gemma)  # Gemma-1

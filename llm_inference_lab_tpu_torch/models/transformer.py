"""Llama decoder: RMSNorm, llama3 RoPE, fused QKV, GQA attention over the
cache, gated SiLU MLP, tied (optionally int8) head.

Port of llm_inference_lab_tpu/models/transformer.py for the Llama family.
The JAX package scans one compiled layer over stacked params; the port runs
a Python loop over the same stacked tensors, taking each layer as a view
(no copy), and every projection goes through ``ops.quant.dense``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from llm_inference_lab_tpu_torch.models.base import (
    KVCache,
    ModelConfig,
    cache_slots,
    write_cache_layer,
)
from llm_inference_lab_tpu_torch.ops.attention import attend
from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, QuantTensor, dense


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    # A bf16 scale promotes to f32 inside the product: no separate cast.
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


@lru_cache(maxsize=32)
def _rope_inv_freq_np(head_dim: int, theta: float, rope_scaling: Optional[tuple]) -> np.ndarray:
    """Inverse rotary frequencies [head_dim//2] with optional llama3 scaling
    (HF _compute_llama3_parameters), computed in float64 as the JAX package
    does, returned as float32."""
    half = head_dim // 2
    inv = theta ** (-np.arange(0, half, dtype=np.float64) / half)
    if rope_scaling is not None:
        kind, factor, low_f, high_f, orig = rope_scaling
        if kind != "llama3":
            raise ValueError(f"unsupported rope_scaling type {kind!r}")
        wavelen = 2.0 * np.pi / inv
        low_wl = orig / low_f
        high_wl = orig / high_f
        scaled = np.where(wavelen > low_wl, inv / factor, inv)
        smooth = (orig / wavelen - low_f) / (high_f - low_f)
        smoothed = (1.0 - smooth) / factor * inv + smooth * inv
        medium = (wavelen >= high_wl) & (wavelen <= low_wl)
        inv = np.where(medium, smoothed, scaled)
    return np.asarray(inv, np.float32)


@lru_cache(maxsize=32)
def _rope_inv_freq(head_dim: int, theta: float, rope_scaling: Optional[tuple],
                   device: torch.device) -> torch.Tensor:
    # One host-to-device copy per (config, device), not one per forward: a
    # copy from pageable memory would wait for the stream.
    return torch.from_numpy(_rope_inv_freq_np(head_dim, theta, rope_scaling)).to(device)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos, sin [B, S, 1, head_dim//2] for positions [B, S] (f32)."""
    inv = _rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, positions.device)
    angles = positions[..., None].float() * inv
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split convention (HF Llama). x: [B, S, H, D]."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                cos, sin, cache: KVCache, layer: int, slots) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = dense(x, p["w_qkv"])  # fused QKV: one matmul instead of three
    # q and k heads rotate together: one pass of elementwise ops, not two.
    qk = rope(qkv[..., : (H + KV) * Dh].reshape(B, S, H + KV, Dh), cos, sin)
    v = qkv[..., (H + KV) * Dh:].reshape(B, S, KV, Dh)
    # Write the new KV at absolute positions BEFORE attending (ops/attention).
    write_cache_layer(cache, layer, qk[:, :, H:], v, slots)
    attn = attend(qk[:, :, :H].contiguous(), cache.k[layer], cache.v[layer], positions)
    return dense(attn.reshape(B, S, H * Dh), p["wo"])


def _mlp_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    gu = dense(x, p["w_gate_up"])  # gate and up fused into one matmul
    F_ = gu.shape[-1] // 2
    return dense(F.silu(gu[..., :F_]) * gu[..., F_:], p["w_down"])


def _layer_params(layers: dict, i: int) -> dict:
    return {name: (w.layer(i) if isinstance(w, QuantTensor) else w[i])
            for name, w in layers.items()}


def forward(cfg: ModelConfig, params: Any, tokens: torch.Tensor, positions: torch.Tensor,
            cache: KVCache, cache_lens: torch.Tensor):
    """tokens, positions: [B, S] (positions int32); cache written in place at
    cache_lens[b] + arange(S). Returns (logits [B, S, V] f32, cache)."""
    embed = params["embed"]
    if isinstance(embed, EmbedQuant):
        x = embed.lookup(tokens, cfg.dtype)
    else:
        x = embed[tokens].to(cfg.dtype)
    cos, sin = rope_tables(cfg, positions)
    slots = cache_slots(cache_lens, tokens.shape[1], cache.max_seq_len)
    eps = cfg.rms_norm_eps
    for i in range(cfg.n_layers):
        p = _layer_params(params["layers"], i)
        x = x + _attn_block(cfg, p, rms_norm(x, p["attn_norm_scale"], eps), positions,
                            cos, sin, cache, i, slots)
        x = x + _mlp_block(p, rms_norm(x, p["mlp_norm_scale"], eps))
    x = rms_norm(x, params["final_norm_scale"], eps)
    return lm_head_logits(cfg, params, x), cache


def lm_head_logits(cfg: ModelConfig, params: Any, x: torch.Tensor) -> torch.Tensor:
    """Hidden states [.., D] -> vocab logits, f32."""
    if cfg.tie_word_embeddings:
        embed = params["embed"]
        if isinstance(embed, EmbedQuant):
            return embed.head_logits(x)
        return torch.matmul(x, embed.to(x.dtype).t()).float()
    return dense(x, params["lm_head"]).float()


def _normal(g: torch.Generator, shape, dtype, device, std: float = 0.02) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=dtype, device=device) * std


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                skip_big: bool = False) -> dict:
    """Random init with the JAX package's shapes and N(0, 0.02^2) weights.
    skip_big leaves the projections out (init_params_quantized adds them)."""
    D, Fd, H, KV, Dh, L = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.n_layers)
    dt = cfg.dtype
    layers = {
        "attn_norm_scale": torch.ones((L, D), dtype=dt, device=device),
        "mlp_norm_scale": torch.ones((L, D), dtype=dt, device=device),
    }
    if not skip_big:
        layers.update(
            w_qkv=_normal(generator, (L, D, (H + 2 * KV) * Dh), dt, device),
            wo=_normal(generator, (L, H * Dh, D), dt, device),
            w_gate_up=_normal(generator, (L, D, 2 * Fd), dt, device),
            w_down=_normal(generator, (L, Fd, D), dt, device),
        )
    params = {
        "embed": _normal(generator, (cfg.vocab_size, D), dt, device),
        "layers": layers,
        "final_norm_scale": torch.ones((D,), dtype=dt, device=device),
    }
    if not cfg.tie_word_embeddings and not skip_big:
        params["lm_head"] = _normal(generator, (D, cfg.vocab_size), dt, device)
    return params


def init_params_quantized(cfg: ModelConfig, generator: torch.Generator, device,
                          mode: str = "int4", quantize_embed: bool = False) -> dict:
    """Random init directly in quantized form: random bytes straight into the
    packed layout, with scales that make the dequantized weights about
    N(0, 0.02^2)-sized (as the JAX package's init_params_quantized), so a
    full-size model never exists in bf16."""
    params = init_params(cfg, generator, device, skip_big=True)
    bits = 4 if mode == "int4" else 8
    maxq = 7 if bits == 4 else 127

    def rand_bytes(shape):
        return torch.randint(-128, 128, shape, generator=generator, dtype=torch.int8,
                             device=device)

    def rand_qt(d_in, d_out, layers=None):
        shape = (d_in // (2 if bits == 4 else 1), d_out)
        lead = (layers,) if layers is not None else ()
        scale = torch.full((*lead, d_out), 0.02 / maxq, dtype=torch.float32, device=device)
        return QuantTensor(rand_bytes((*lead, *shape)), scale, bits=bits)

    D, Fd, H, KV, Dh, L = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.n_layers)
    params["layers"]["w_qkv"] = rand_qt(D, (H + 2 * KV) * Dh, L)
    params["layers"]["wo"] = rand_qt(H * Dh, D, L)
    params["layers"]["w_gate_up"] = rand_qt(D, 2 * Fd, L)
    params["layers"]["w_down"] = rand_qt(Fd, D, L)
    if quantize_embed:
        params["embed"] = EmbedQuant(
            rand_bytes((cfg.vocab_size, D)),
            torch.full((cfg.vocab_size,), 0.02 / 127, dtype=torch.float32, device=device),
        )
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rand_qt(D, cfg.vocab_size)
    return params

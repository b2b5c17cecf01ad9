"""Llama-architecture decoder: RMSNorm, llama3 RoPE, fused QKV, GQA
attention over the cache, gated SiLU or GeGLU MLP, tied (optionally int8)
head; with Gemma's and Gemma-2's flags (embedding scale, (1 + w) norms,
sandwich norms, the per-layer sliding window, the score scale and the
attention and final logit softcaps) and Mistral's untied head and
rolling-buffer cache (ModelConfig.kv_ring_len: the rows land at position mod
ring and attention masks modulo the ring).

Port of llm_inference_lab_tpu/models/transformer.py for the Llama, Gemma and
Mistral families.
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
    ModelConfig,
    cache_slots,
    write_cache_layer,
)
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache, page_slots, write_paged_layer
from llm_inference_lab_tpu_torch.ops.attention import attend, paged_attend
from llm_inference_lab_tpu_torch.ops.flash_decode import tree_bits
from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, QuantTensor, dense, f32_logits
from llm_inference_lab_tpu_torch.ops.rms_norm import add_rms_norm, rms_norm


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


def attn_options(cfg: ModelConfig, layer: int) -> dict:
    """The attention options of one layer (JAX _attn_extras with the window
    gate): the window on every layer, or with alt_window on even layers
    only; the score scale and the softcap from the config."""
    local = not cfg.alt_window or layer % 2 == 0
    return dict(window=cfg.sliding_window if local else None,
                scale=(cfg.query_pre_attn_scalar ** -0.5
                       if cfg.query_pre_attn_scalar is not None else None),
                softcap=cfg.attn_logit_softcap)


def _attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                cos, sin, cache, layer: int, slots, tree: Optional[dict] = None) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = dense(x, p["w_qkv"])  # fused QKV: one matmul instead of three
    # q and k heads rotate together: one pass of elementwise ops, not two.
    qk = rope(qkv[..., : (H + KV) * Dh].reshape(B, S, H + KV, Dh), cos, sin)
    v = qkv[..., (H + KV) * Dh:].reshape(B, S, KV, Dh)
    q = qk[:, :, :H].contiguous()
    # Write the new KV at absolute positions BEFORE attending (ops/attention);
    # an int8 cache quantizes the rows and attends with the layer's scales.
    scales = ((cache.k_scale[layer], cache.v_scale[layer]) if cache.k_scale is not None
              else (None, None))
    options = dict(attn_options(cfg, layer), **(tree or {}))
    if isinstance(cache, PagedKVCache):
        write_paged_layer(cache, layer, qk[:, :, H:], v, slots)
        attn = paged_attend(q, cache.k[layer], cache.v[layer], positions, cache.table, *scales,
                            **options)
    else:
        write_cache_layer(cache, layer, qk[:, :, H:], v, slots)
        attn = attend(q, cache.k[layer], cache.v[layer], positions, *scales,
                      ring_len=cfg.kv_ring_len, **options)
    return dense(attn.reshape(B, S, H * Dh), p["wo"])


def _mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    gu = dense(x, p["w_gate_up"])  # gate and up fused into one matmul
    F_ = gu.shape[-1] // 2
    gate = gu[..., :F_]
    gate = F.gelu(gate, approximate="tanh") if cfg.act == "gelu_tanh" else F.silu(gate)
    return dense(gate * gu[..., F_:], p["w_down"])


def _layer_params(layers: dict, i: int) -> dict:
    return {name: (w.layer(i) if isinstance(w, QuantTensor) else w[i])
            for name, w in layers.items()}


def forward(cfg: ModelConfig, params: Any, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_lens: torch.Tensor, return_hidden: bool = False,
            tree_mask: Optional[torch.Tensor] = None):
    """tokens, positions: [B, S] (positions int32); cache (a KVCache or a
    PagedKVCache) written in place at cache_lens[b] + arange(S). Returns
    (logits [B, S, V] f32, cache), and with return_hidden the final
    post-norm hidden states [B, S, D] (the model dtype) third: the input of
    the head, which the Medusa and EAGLE heads read. tree_mask [S, S] bool
    (tree speculation): the chunk's rows are still written at cache_lens +
    arange(S), but attend by ancestry (row s sees the slots before the chunk
    and chunk row j iff tree_mask[s, j]) and take RoPE at `positions`, the
    caller's logical positions by depth. As in JAX, a sliding window that can
    bind and a ring refuse the tree mask. ``forward.calls`` and
    ``forward.layers`` count the forwards run and their layers."""
    tree = {}
    if tree_mask is not None:
        if cfg.kv_ring_len is not None:
            raise ValueError("the tree mask needs a cache without a ring")
        span = cache.k.shape[-2] * (cache.table.shape[-1] if isinstance(cache, PagedKVCache)
                                    else 1)
        if cfg.sliding_window is not None and span > cfg.sliding_window:
            raise NotImplementedError("sliding-window attention with tree caches longer than "
                                      "the window is not supported")
        # The kernels' form of the mask, once a forward (the card's tree
        # variants take S <= 32; the plain versions any S).
        tree = dict(tree_mask=tree_mask, chunk_start=cache_lens,
                    tree_bits=tree_bits(tree_mask) if tree_mask.is_cuda else None)
    forward.calls += 1
    forward.layers += cfg.n_layers
    embed = params["embed"]
    if isinstance(embed, EmbedQuant):
        x = embed.lookup(tokens, cfg.dtype)
    else:
        x = embed[tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # Gemma's input normalizer: sqrt(d_model) rounded to the compute
        # dtype, then multiplied (as the JAX package and HF round it).
        x = x * _embed_multiplier(cfg.d_model, cfg.dtype)
    cos, sin = rope_tables(cfg, positions)
    if isinstance(cache, PagedKVCache):
        slots = page_slots(cache.table, cache_lens, tokens.shape[1], cache.page_size)
    else:
        slots = cache_slots(cache_lens, tokens.shape[1], cache.max_seq_len, cfg.kv_ring_len)

    def add_norm(h, a, w, post):
        # h + a' and its norm in one launch, a' = Gemma-2's sandwich norm of a
        # (post_norms) or a: the norm after each residual add is the next
        # block's input norm, after the last layer the final norm.
        return add_rms_norm(h, a, w, cfg.rms_norm_eps, cfg.rms_one_offset,
                            p[post] if cfg.post_norms else None)

    layers = params["layers"]
    n = rms_norm(x, layers["attn_norm_scale"][0], cfg.rms_norm_eps, cfg.rms_one_offset)
    for i in range(cfg.n_layers):
        p = _layer_params(layers, i)
        a = _attn_block(cfg, p, n, positions, cos, sin, cache, i, slots, tree)
        x, n = add_norm(x, a, p["mlp_norm_scale"], "post_attn_norm_scale")
        h = _mlp_block(cfg, p, n)
        w_next = (layers["attn_norm_scale"][i + 1] if i + 1 < cfg.n_layers
                  else params["final_norm_scale"])
        x, n = add_norm(x, h, w_next, "post_mlp_norm_scale")
    if return_hidden:
        return lm_head_logits(cfg, params, n), cache, n
    return lm_head_logits(cfg, params, n), cache


forward.calls = 0
forward.layers = 0


@lru_cache(maxsize=8)
def _embed_multiplier(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to `dtype`, as a Python float (exact in f32, so
    multiplying by it rounds as the dtype's product does)."""
    return float(torch.tensor(d_model ** 0.5, dtype=dtype))


def lm_head_logits(cfg: ModelConfig, params: Any, x: torch.Tensor) -> torch.Tensor:
    """Hidden states [.., D] -> vocab logits, f32: a tied head or an
    unquantized untied one keeps its products and sums in f32 (JAX's
    preferred_element_type=f32), a quantized untied head goes through dense
    as JAX's does. Gemma-2 caps them
    (cap * tanh(logits / cap), in place on the f32 logits)."""
    if cfg.tie_word_embeddings:
        embed = params["embed"]
        if isinstance(embed, EmbedQuant):
            logits = embed.head_logits(x)
        else:
            logits = f32_logits(x, embed.to(x.dtype))
    elif isinstance(params["lm_head"], QuantTensor):
        logits = dense(x, params["lm_head"]).float()
    else:
        logits = f32_logits(x, params["lm_head"].to(x.dtype).t())
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = logits.div_(cap).tanh_().mul_(cap)
    return logits


def _normal(g: torch.Generator, shape, dtype, device, std: float = 0.02) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=dtype, device=device) * std


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                skip_big: bool = False) -> dict:
    """Random init with the JAX package's shapes and N(0, 0.02^2) weights.
    skip_big leaves the projections out (init_params_quantized adds them)."""
    D, Fd, H, KV, Dh, L = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.n_layers)
    dt = cfg.dtype
    # Gemma stores RMSNorm weights as (w - 1): the identity is zeros.
    norm_one = torch.zeros if cfg.rms_one_offset else torch.ones
    names = ["attn_norm_scale", "mlp_norm_scale"]
    if cfg.post_norms:  # Gemma-2's sandwich norms
        names += ["post_attn_norm_scale", "post_mlp_norm_scale"]
    layers = {n: norm_one((L, D), dtype=dt, device=device) for n in names}
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
        "final_norm_scale": norm_one((D,), dtype=dt, device=device),
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

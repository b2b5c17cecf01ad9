"""The decoder of the eight families: Llama's (RMSNorm, llama3 RoPE, fused
QKV, GQA attention over the cache, gated SiLU MLP, tied (optionally int8)
head), with Qwen2's QKV bias, Phi-3's and Mistral's untied heads and
windows, Mixtral's routed experts (ops/moe.py), Gemma's and Gemma-2's flags
(embedding scale, (1 + w) norms, GeGLU, sandwich norms, the per-layer
sliding window, the score scale and the attention and final logit
softcaps), GPT-2's and OPT's LayerNorm with biases, learned positions (no
rotary) and plain gelu or relu MLP with biases, and the rolling-buffer
cache (ModelConfig.kv_ring_len: the rows land at position mod ring and
attention masks modulo the ring). The embedding may be int8 (EmbedQuant)
or int4 (EmbedQuant4, its tied head through kernel A with an f32 output),
and a LoRA pack in params["layers"] (models/lora.py) adds each row's
adapter delta at the fused QKV, the output projection and the gated MLP's
gate/up and down projections when the forward is given ``lora_ids``.

Tensor parallelism (a rank's models/base.py RankConfig, its ``tp``): the rank
holds its heads' columns of the fused QKV, its columns of the MLP's input
projection and the matching rows of the output projections
(parallel/sharding.py); each output projection's partial sums are added
over the model group in f32 (``_out_proj``), the vocab-parallel embedding
is summed the same way and the head's logits are all-gathered. Attention
and the caches run at the rank's heads, unchanged. The other axes: ``sp``
(seq: the ring prefill under ``cp`` and caches split on T, attended slice
by slice), ``pp`` (stage: the forward is parallel/pipeline.py forward_pp
over the rank's layers, run by ``run_layers``) and ``ep`` (expert: a MoE
layer through ops/moe.py moe_expert, as under the model axis).

Port of llm_inference_lab_tpu/models/transformer.py. The JAX package scans
one compiled layer over stacked params; the port runs a Python loop over
the same stacked tensors, taking each layer as a view (no copy), and every
projection goes through ``ops.quant.dense``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from llm_inference_lab_tpu_torch.models.base import (
    ModelConfig,
    cache_slots,
    slice_slots,
    write_cache_layer,
)
from llm_inference_lab_tpu_torch.models.lora import adapter_mask, has_pack, lora_delta
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache, page_slots, write_paged_layer
from llm_inference_lab_tpu_torch.ops.attention import attend, attend_slices, paged_attend
from llm_inference_lab_tpu_torch.ops.flash_decode import tree_bits
from llm_inference_lab_tpu_torch.ops.moe import gated, moe_expert, moe_mlp
from llm_inference_lab_tpu_torch.ops.quant import (
    EmbedQuant,
    EmbedQuant4,
    QuantTensor,
    dense,
    dense_f32,
    f32_logits,
    repack_int4_rows,
)
from llm_inference_lab_tpu_torch.ops.rms_norm import (
    add_layer_norm,
    add_rms_norm,
    layer_norm,
    rms_norm,
)
from llm_inference_lab_tpu_torch.parallel.context import ring_attention_shard


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


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx of table [n, D] as jnp.take gives them (its "fill" mode): an
    index in [-n, 0) counts from the end, as numpy's does, and any other
    index outside the table gives a row of NaN. Branch-free, with no
    out-of-range gather (a device assert on the card), so a captured graph
    takes it: a dead row's position -1 reads the table's last row (GPT-2),
    or row pos_offset - 1 (OPT)."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)]
    return torch.where(inside[..., None], rows, torch.full_like(rows, float("nan")))


def attn_options(cfg: ModelConfig, layer: int) -> dict:
    """The attention options of one layer (JAX _attn_extras with the window
    gate): the window on every layer, or with alt_window on even layers
    only; the score scale and the softcap from the config."""
    local = not cfg.alt_window or layer % 2 == 0
    return dict(window=cfg.sliding_window if local else None,
                scale=(cfg.query_pre_attn_scalar ** -0.5
                       if cfg.query_pre_attn_scalar is not None else None),
                softcap=cfg.attn_logit_softcap)


def _lora(p: dict, site: str, mask: Optional[torch.Tensor], y: torch.Tensor,
          x: torch.Tensor) -> torch.Tensor:
    """y plus the rows' adapter deltas at `site` (JAX _lora), or y alone
    without a pack or without lora_ids (mask None). Under tensor
    parallelism a column site's B holds the rank's columns, so its delta is
    the rank's columns of the whole delta."""
    A = p.get(f"lora_A_{site}")
    if A is None or mask is None:
        return y
    return y + lora_delta(A, p[f"lora_B_{site}"], None, x, mask=mask)


def _row_lora(p: dict, site: str, mask: Optional[torch.Tensor]) -> Optional[tuple]:
    """A row site's (A, B, mask) for _out_proj, or None without a delta."""
    A = p.get(f"lora_A_{site}")
    return None if A is None or mask is None else (A, p[f"lora_B_{site}"], mask)


class Context(NamedTuple):
    """What every layer of a forward reads beside its params and input: the
    rows' positions, the rotary tables (None under learned positions), the
    cache and where the chunk's rows land in it, the tree's kernel options,
    the LoRA mask, and under the ring prefill its per-block cache slots."""

    positions: torch.Tensor
    cos: Optional[torch.Tensor]
    sin: Optional[torch.Tensor]
    cache: Any
    slots: Any
    tree: dict
    mask: Optional[torch.Tensor]
    ring: Optional[list] = None


def _attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                cos, sin, cache, layer: int, slots, tree: Optional[dict] = None,
                mask: Optional[torch.Tensor] = None, ring: Optional[list] = None) -> torch.Tensor:
    """One layer's attention block (a Context's pieces, layer: the cache's
    layer index); ring: under the ring prefill, each K/V block's slots."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tree = tree or {}
    # fused QKV: one matmul instead of three
    qkv = _lora(p, "qkv", mask, dense(x, p["w_qkv"], p.get("b_qkv")), x)
    # q and k heads rotate together: one pass of elementwise ops, not two.
    qk = qkv[..., : (H + KV) * Dh].reshape(B, S, H + KV, Dh)
    if cos is not None:  # rotary (not under learned positions)
        qk = rope(qk, cos, sin)
    v = qkv[..., (H + KV) * Dh:].reshape(B, S, KV, Dh)
    q = qk[:, :, :H].contiguous()
    # Write the new KV at absolute positions BEFORE attending (ops/attention);
    # an int8 cache quantizes the rows and attends with the layer's scales.
    scales = ((cache.k_scale[layer], cache.v_scale[layer]) if cache.k_scale is not None
              else (None, None))
    if ring is not None:
        # The ring prefill (JAX's cp branch): the rows of each K/V block the
        # rank holds that fall in its cache are written as the block passes.
        def write(src, k_blk, v_blk):
            write_cache_layer(cache, layer, k_blk, v_blk, ring[src])

        attn = ring_attention_shard(q, qk[:, :, H:], v, cfg.sp, on_block=write)
    elif isinstance(cache, PagedKVCache):
        options = dict(attn_options(cfg, cfg.layer0 + layer), **tree)
        write_paged_layer(cache, layer, qk[:, :, H:], v, slots)
        attn = paged_attend(q, cache.k[layer], cache.v[layer], positions, cache.table,
                            *scales, **options)
    else:
        options = dict(attn_options(cfg, cfg.layer0 + layer), **tree)
        write_cache_layer(cache, layer, qk[:, :, H:], v, slots)
        if cache.t0 is not None:  # a slice of T over the seq axis: merged over the ranks
            attn = attend_slices(q, cache.k[layer], cache.v[layer], positions, cache.t0,
                                 *scales, group=cfg.sp, span=cache.k.shape[3] * cfg.sp.size,
                                 **options)
        else:
            attn = attend(q, cache.k[layer], cache.v[layer], positions, *scales,
                          ring_len=cfg.kv_ring_len, **options)
    a = attn.reshape(B, S, H * Dh)
    return _out_proj(cfg, a, p["wo"], p.get("bo"), _row_lora(p, "o", mask))


def _out_proj(cfg: ModelConfig, x: torch.Tensor, w: Any, b: Optional[torch.Tensor] = None,
              lora: Optional[tuple] = None) -> torch.Tensor:
    """A row-parallel projection (wo, w_down, w_proj): dense, or under
    tensor parallelism the rank's partial sum in f32 (dense_f32), added
    over the model group in f32 and rounded to the model dtype once, as the
    unsharded kernel rounds its sum once; then the bias, which every rank
    holds whole and adds once, after the sum. lora: a row site's (A, B,
    mask) (_row_lora): the rows' adapter delta, added after the projection,
    or under tensor parallelism (A the rank's rows of its inputs) added to
    the rank's partial before the sum, which costs no collective of its
    own."""
    if cfg.tp is None:
        y = dense(x, w, b)
        return y if lora is None else y + lora_delta(lora[0], lora[1], None, x, mask=lora[2])
    part = dense_f32(x, w)
    if lora is not None:
        part = part + lora_delta(lora[0], lora[1], None, x, mask=lora[2]).float()
    y = cfg.tp.all_reduce(part).to(x.dtype)
    return y if b is None else y + b.to(y.dtype)


def _mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.moe:  # Mixtral: top-k routed gated-MLP experts
        B, S, D = x.shape
        if cfg.ep is not None or cfg.tp is not None:  # moe_dense's expert-parallel form
            return moe_expert(x.reshape(B * S, D), p["w_router"], p["w_gate_up"], p["w_down"],
                              top_k=cfg.experts_per_token, act=cfg.act, ep=cfg.ep,
                              tp=cfg.tp).reshape(B, S, D)
        return moe_mlp(x.reshape(B * S, D), p["w_router"], p["w_gate_up"], p["w_down"],
                       top_k=cfg.experts_per_token, act=cfg.act).reshape(B, S, D)
    if not cfg.gated_mlp:  # GPT-2's gelu (tanh-approximated, jax.nn.gelu's default), OPT's relu
        h = dense(x, p["w_fc"], p.get("b_fc"))
        h = F.gelu(h, approximate="tanh") if cfg.act == "gelu" else F.relu(h)
        return _out_proj(cfg, h, p["w_proj"], p.get("b_proj"))
    # gate and up fused into one matmul
    h = gated(_lora(p, "gate_up", mask, dense(x, p["w_gate_up"]), x), cfg.act)
    return _out_proj(cfg, h, p["w_down"], lora=_row_lora(p, "down", mask))


def _layer_params(layers: dict, i: int) -> dict:
    return {name: (w.layer(i) if isinstance(w, QuantTensor) else w[i])
            for name, w in layers.items()}


def _tree_options(cfg: ModelConfig, cache, cache_lens: torch.Tensor,
                  tree_mask: Optional[torch.Tensor]) -> dict:
    """The tree mask's kernel options of a forward ({} without a mask). As
    in JAX, a sliding window that can bind and a ring refuse the mask."""
    if tree_mask is None:
        return {}
    if cfg.kv_ring_len is not None:
        raise ValueError("the tree mask needs a cache without a ring")
    # The whole cache's T: the table's pages, or every rank's slice.
    span = cache.k.shape[-2] * (cache.table.shape[-1] if isinstance(cache, PagedKVCache)
                                else cfg.sp.size if cache.t0 is not None else 1)
    if cfg.sliding_window is not None and span > cfg.sliding_window:
        raise NotImplementedError("sliding-window attention with tree caches longer than "
                                  "the window is not supported")
    # The kernels' form of the mask (int32 words [S, ceil(S / 32)]), once a
    # forward; the plain versions take the bool mask.
    return dict(tree_mask=tree_mask, chunk_start=cache_lens,
                tree_bits=tree_bits(tree_mask) if tree_mask.is_cuda else None)


def _check_ring(cfg: ModelConfig, cache) -> None:
    """JAX's refusals of a ring (context-parallel) prefill: Gemma-2's
    attention options, and a window the cache is long enough to bind (the
    cache's global T)."""
    if cfg.sp is None:
        raise ValueError("a ring (context-parallel) prefill needs a seq axis above 1")
    if cfg.attn_logit_softcap is not None or cfg.query_pre_attn_scalar is not None:
        raise NotImplementedError(
            "gemma2 attention (softcap / query_pre_attn_scalar) is implemented on the "
            "contiguous and paged chain-decode paths (the ring-prefill variant is future work)")
    if isinstance(cache, PagedKVCache):
        raise NotImplementedError("the ring prefill writes a contiguous cache (a paged pool, "
                                  "whole on every seq rank, prefills unsplit)")
    max_t = cache.k.shape[-2] * (cfg.sp.size if cache.t0 is not None else 1)
    if cfg.sliding_window is not None and max_t > cfg.sliding_window:
        raise NotImplementedError("sliding-window attention with context-parallel / tree "
                                  "caches longer than the window is not supported")


def context(cfg: ModelConfig, params: Any, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_lens: torch.Tensor, tree_mask: Optional[torch.Tensor] = None,
            lora_ids: Optional[torch.Tensor] = None, ring: bool = False) -> Context:
    """The Context of a forward over tokens, positions [B, S] (computed once
    for all its layers). ring: tokens are this rank's rows of the ring
    prefill's block (JAX's cp), whose every block's rows are written where
    they fall in the cache."""
    tree = _tree_options(cfg, cache, cache_lens, tree_mask)
    cos = sin = None
    if not cfg.use_learned_pos:
        cos, sin = rope_tables(cfg, positions)
    S = tokens.shape[1]
    slots = blocks = None
    if isinstance(cache, PagedKVCache):
        slots = page_slots(cache.table, cache_lens, S, cache.page_size)
    elif ring:
        # Block src holds the prompt rows [src S, (src + 1) S): the cache
        # rows at cache_lens + those rows.
        blocks = [(slice_slots(cache_lens + src * S, S, cache.t0, cache.k.shape[3])
                   if cache.t0 is not None
                   else cache_slots(cache_lens + src * S, S, cache.max_seq_len, cfg.kv_ring_len))
                  for src in range(cfg.sp.size)]
    elif cache.t0 is not None:
        slots = slice_slots(cache_lens, S, cache.t0, cache.k.shape[3])
    else:
        slots = cache_slots(cache_lens, S, cache.max_seq_len, cfg.kv_ring_len)
    mask = None
    layers = params["layers"]
    if lora_ids is not None and has_pack(layers):
        # Each row's adapter as a 0/1 mask over the pack, once a forward.
        pack = next(v for k, v in layers.items() if k.startswith("lora_A_"))
        mask = adapter_mask(lora_ids, pack.shape[1], S, pack.dtype)
    return Context(positions, cos, sin, cache, slots, tree, mask, blocks)


def embed(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    """The rows entering the first layer: the embedding (Gemma's scaled),
    plus the learned positions of GPT-2 and OPT."""
    x = _embed_lookup(cfg, params["embed"], tokens)
    if cfg.embed_scale:
        # Gemma's input normalizer: sqrt(d_model) rounded to the compute
        # dtype, then multiplied (as the JAX package and HF round it).
        x = x * _embed_multiplier(cfg.d_model, cfg.dtype)
    if cfg.use_learned_pos:
        x = x + take_rows(params["pos_embed"], positions + cfg.pos_offset).to(cfg.dtype)
    return x


def run_layers(cfg: ModelConfig, params: Any, x: torch.Tensor, ctx: Context,
               final_norm: bool = True):
    """Every layer of params["layers"] over the residual rows x, which enter
    its first layer. Returns (x, n): the residual rows after the last layer
    and, with final_norm, their final norm (the head's input); without it
    (a pipeline stage before the last) n is None and x is torch's x + h,
    the bits the fused add gives. Each norm after the first runs fused with
    the residual add before it: RMSNorm through add_rms_norm (with Gemma-2's
    sandwich norm of a, post_norms, inside), GPT-2's and OPT's LayerNorm
    through add_layer_norm."""
    layers = params["layers"]
    L = next(iter(layers.values()))
    L = (L.data if isinstance(L, QuantTensor) else L).shape[0]

    def norm_of(i):
        """Scale and bias (None for RMSNorm) of layer i's input norm; at i = L
        the final norm's."""
        if i == L:
            return params["final_norm_scale"], params.get("final_norm_bias")
        return layers["attn_norm_scale"][i], (layers["attn_norm_bias"][i] if cfg.use_layernorm
                                              else None)

    def add_norm(h, a, w, b, post):
        # h + a and the norm after it, which is the next block's input norm
        # (after the last layer the final norm), in one launch.
        if cfg.use_layernorm:
            return add_layer_norm(h, a, w, b, cfg.layer_norm_eps)
        return add_rms_norm(h, a, w, cfg.rms_norm_eps, cfg.rms_one_offset,
                            p[post] if cfg.post_norms else None)

    w, b = norm_of(0)
    n = (layer_norm(x, w, b, cfg.layer_norm_eps) if cfg.use_layernorm
         else rms_norm(x, w, cfg.rms_norm_eps, cfg.rms_one_offset))
    for i in range(L):
        p = _layer_params(layers, i)
        a = _attn_block(cfg, p, n, ctx.positions, ctx.cos, ctx.sin, ctx.cache, i, ctx.slots,
                        ctx.tree, ctx.mask, ctx.ring)
        x, n = add_norm(x, a, p["mlp_norm_scale"], p.get("mlp_norm_bias"), "post_attn_norm_scale")
        h = _mlp_block(cfg, p, n, ctx.mask)
        if i + 1 < L or final_norm:
            x, n = add_norm(x, h, *norm_of(i + 1), "post_mlp_norm_scale")
        else:
            if cfg.post_norms:
                h = rms_norm(h, p["post_mlp_norm_scale"], cfg.rms_norm_eps, cfg.rms_one_offset)
            x, n = x + h, None
    return x, n


def forward(cfg: ModelConfig, params: Any, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_lens: torch.Tensor, return_hidden: bool = False,
            tree_mask: Optional[torch.Tensor] = None, lora_ids: Optional[torch.Tensor] = None,
            logits: bool = True, cp: bool = False):
    """tokens, positions: [B, S] (positions int32); cache (a KVCache or a
    PagedKVCache) written in place at cache_lens[b] + arange(S). Returns
    (logits [B, S, V] f32, cache), and with return_hidden the final
    post-norm hidden states [B, S, D] (the model dtype) third: the input of
    the head, which the Medusa and EAGLE heads read. tree_mask [S, S] bool
    (tree speculation): the chunk's rows are still written at cache_lens +
    arange(S), but attend by ancestry (row s sees the slots before the chunk
    and chunk row j iff tree_mask[s, j]) and take RoPE at `positions`, the
    caller's logical positions by depth. As in JAX, a sliding window that can
    bind and a ring refuse the tree mask. lora_ids [B] int32: each row's
    adapter in the params' LoRA pack (-1: the base model); without a pack,
    or with lora_ids None, no delta is computed (JAX passes none where the
    layers hold no pack). logits=False skips the head (the logits are
    None): Engine.embed reads the hidden states only. ``forward.calls`` and
    ``forward.layers`` count the forwards run and their layers.

    Under a mesh (cfg a RankConfig): a stage axis runs the pipeline
    (parallel/pipeline.py forward_pp); cp=True (JAX's cp, the single-shot
    prefill under a seq axis) runs this rank's S / n rows of the block
    through every layer, attention by ring attention (parallel/context.py),
    and gathers the final hidden rows over the seq group, so every rank
    computes the same logits; without cp a cache sliced on T over the seq
    axis is attended slice by slice and merged (ops/attention.py
    attend_slices)."""
    if cfg.pp is not None:
        from llm_inference_lab_tpu_torch.parallel.pipeline import forward_pp

        return forward_pp(cfg, params, tokens, positions, cache, cache_lens, return_hidden,
                          tree_mask, lora_ids, logits, cp)
    if cp:
        _check_ring(cfg, cache)
        n_seq, P = cfg.sp.size, tokens.shape[1]
        if P % n_seq:
            raise ValueError(f"seq len {P} not divisible by seq={n_seq}")
        rows = slice(cfg.sp.rank * (P // n_seq), (cfg.sp.rank + 1) * (P // n_seq))
        tokens, positions = tokens[:, rows], positions[:, rows]
    ctx = context(cfg, params, tokens, positions, cache, cache_lens, tree_mask, lora_ids, cp)
    forward.calls += 1
    forward.layers += cfg.n_layers
    _, n = run_layers(cfg, params, embed(cfg, params, tokens, positions), ctx)
    if cp:  # every rank's rows: the head's input on every rank
        n = cfg.sp.all_gather(n, dim=1)
    out = lm_head_logits(cfg, params, n) if logits else None
    if return_hidden:
        return out, cache, n
    return out, cache


forward.calls = 0
forward.layers = 0


def _embed_lookup(cfg: ModelConfig, embed: Any, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `tokens` in the model dtype. Under tensor parallelism the
    rank holds vocab rows [r n, (r + 1) n) (n = its row count): it looks up
    the ids in its range, writes zero for the rest, and the model group's
    sum (in f32) is each row exactly, one non-zero term."""
    def lookup(ids):
        if isinstance(embed, (EmbedQuant, EmbedQuant4)):
            return embed.lookup(ids, cfg.dtype)
        return embed[ids].to(cfg.dtype)

    if cfg.tp is None:
        return lookup(tokens)
    n = (embed.rq if isinstance(embed, EmbedQuant4) else
         embed.q if isinstance(embed, EmbedQuant) else embed).shape[0]
    local = tokens - cfg.tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = torch.where(inside[..., None], lookup(local.clamp(0, n - 1)).float(), 0.0)
    return cfg.tp.all_reduce(rows).to(cfg.dtype)


@lru_cache(maxsize=8)
def _embed_multiplier(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to `dtype`, as a Python float (exact in f32, so
    multiplying by it rounds as the dtype's product does)."""
    return float(torch.tensor(d_model ** 0.5, dtype=dtype))


def lm_head_logits(cfg: ModelConfig, params: Any, x: torch.Tensor) -> torch.Tensor:
    """Hidden states [.., D] -> vocab logits, f32: a tied head or an
    unquantized untied one keeps its products and sums in f32 (JAX's
    preferred_element_type=f32), a quantized untied head goes through dense
    as JAX's does. Under tensor parallelism each rank's head gives its
    vocab columns, all-gathered into the whole row, and the columns of a
    vocabulary padded to split over the ranks are cut, so no consumer of
    logits (argmax, kernel C, sampling, logprobs) sees them. Gemma-2 caps them
    (cap * tanh(logits / cap), in place on the f32 logits)."""
    if cfg.tie_word_embeddings:
        embed = params["embed"]
        if isinstance(embed, (EmbedQuant, EmbedQuant4)):
            logits = embed.head_logits(x)
        else:
            logits = f32_logits(x, embed.to(x.dtype))
    elif isinstance(params["lm_head"], QuantTensor):
        logits = dense(x, params["lm_head"]).float()
    else:
        logits = f32_logits(x, params["lm_head"].to(x.dtype).t())
    if cfg.tp is not None:  # the rank's vocab columns: the whole row on every rank
        logits = cfg.tp.all_gather_last(logits)
        if logits.shape[-1] > cfg.vocab_size:  # a padded vocabulary: its columns cut
            logits = logits[..., :cfg.vocab_size].contiguous()
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = logits.div_(cap).tanh_().mul_(cap)
    return logits


def _normal(g: torch.Generator, shape, dtype, device, std: float = 0.02) -> torch.Tensor:
    # Scaled in place: a Mixtral expert stack is 30 GB in bf16.
    return torch.randn(shape, generator=g, dtype=dtype, device=device).mul_(std)


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                skip_big: bool = False) -> dict:
    """Random init with the JAX package's shapes and N(0, 0.02^2) weights
    (biases and LayerNorm biases zero, norms the identity). skip_big leaves
    the projections out (init_params_quantized adds them)."""
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
        )
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if cfg.use_layernorm:  # GPT-2 / OPT: the LayerNorm biases
        layers.update(attn_norm_bias=zeros(L, D), mlp_norm_bias=zeros(L, D))
    if cfg.use_bias:  # GPT-2 / OPT: a bias on every projection
        layers.update(b_qkv=zeros(L, (H + 2 * KV) * Dh), bo=zeros(L, D), b_fc=zeros(L, Fd),
                      b_proj=zeros(L, D))
    elif cfg.qkv_bias:  # Qwen2: on the fused QKV only
        layers["b_qkv"] = zeros(L, (H + 2 * KV) * Dh)
    if not skip_big:
        if cfg.moe:  # Mixtral: the router and the expert-stacked gated MLPs
            E = cfg.n_experts
            layers.update(w_router=_normal(generator, (L, D, E), dt, device),
                          w_gate_up=_normal(generator, (L, E, D, 2 * Fd), dt, device),
                          w_down=_normal(generator, (L, E, Fd, D), dt, device))
        elif cfg.gated_mlp:
            layers.update(w_gate_up=_normal(generator, (L, D, 2 * Fd), dt, device),
                          w_down=_normal(generator, (L, Fd, D), dt, device))
        else:
            layers.update(w_fc=_normal(generator, (L, D, Fd), dt, device),
                          w_proj=_normal(generator, (L, Fd, D), dt, device))
    params = {
        "embed": _normal(generator, (cfg.vocab_size, D), dt, device),
        "layers": layers,
        "final_norm_scale": norm_one((D,), dtype=dt, device=device),
    }
    if cfg.use_learned_pos:
        params["pos_embed"] = _normal(generator, (cfg.max_position_embeddings + cfg.pos_offset,
                                                  D), dt, device)
    if cfg.use_layernorm:
        params["final_norm_bias"] = zeros(D)
    if not cfg.tie_word_embeddings and not skip_big:
        params["lm_head"] = _normal(generator, (D, cfg.vocab_size), dt, device)
    return params


def init_params_quantized(cfg: ModelConfig, generator: torch.Generator, device,
                          mode: str = "int4", quantize_embed=False) -> dict:
    """Random init directly in quantized form: random bytes straight into the
    packed layout, with scales that make the dequantized weights about
    N(0, 0.02^2)-sized (as the JAX package's init_params_quantized), so a
    full-size model never exists in bf16. quantize_embed carries the
    embedding's bit width as JAX's does: True (or 8) an int8 EmbedQuant, 4
    an EmbedQuant4 (random head-layout bytes, the row layout repacked from
    them). The MoE experts have no quantized form (mixtral.create refuses
    quantized_init, as JAX's MixtralModel)."""
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
    if cfg.gated_mlp:
        params["layers"]["w_gate_up"] = rand_qt(D, 2 * Fd, L)
        params["layers"]["w_down"] = rand_qt(Fd, D, L)
    else:
        params["layers"]["w_fc"] = rand_qt(D, Fd, L)
        params["layers"]["w_proj"] = rand_qt(Fd, D, L)
    if quantize_embed == 4:
        e4 = rand_bytes((D // 2, cfg.vocab_size))
        params["embed"] = EmbedQuant4(
            QuantTensor(e4, torch.full((cfg.vocab_size,), 0.02 / 7, dtype=torch.float32,
                                       device=device), bits=4),
            repack_int4_rows(e4))
    elif quantize_embed:
        params["embed"] = EmbedQuant(
            rand_bytes((cfg.vocab_size, D)),
            torch.full((cfg.vocab_size,), 0.02 / 127, dtype=torch.float32, device=device),
        )
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rand_qt(D, cfg.vocab_size)
    return params

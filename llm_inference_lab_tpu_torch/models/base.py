"""Model config and static-shape KV cache.

Port of llm_inference_lab_tpu/models/base.py (ModelConfig, KVCache, the
per-row int8 quantization and the cache write at absolute positions, or at
position mod ring_len in the rolling-buffer cache) for the Llama, Gemma and
Mistral families.

Cache-tail invariant (what makes single-pass verification work): the cache
holds KV for committed tokens [0, L-1), everything except the last committed
token. Each draft/verify forward starts from that last token, so verify is
one forward over [t_{L-1}, d_1..d_K] producing K+1 logit rows. Rejection
just does not advance the length: stale rows beyond it are dead by the
position mask and are overwritten by the next step's writes.

Unlike the JAX package, which threads immutable arrays, the port writes the
new rows into the cache IN PLACE (indexed assignment into the stacked
buffer), so a step never copies the cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch: str = "llama"
    vocab_size: int = 32000
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    # ("llama3", factor, low_freq_factor, high_freq_factor, original_max)
    rope_scaling: Optional[tuple] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    # Gated MLP activation: "silu" (Llama) or "gelu_tanh" (Gemma's GeGLU).
    act: str = "silu"
    # Local attention: a token at position p attends to (p - window, p];
    # None = full causal attention.
    sliding_window: Optional[int] = None
    # Gemma: head_dim decoupled from d_model / n_heads, a sqrt(d_model)
    # input-embedding scale, RMSNorm as x_hat * (1 + w).
    head_dim_override: Optional[int] = None
    embed_scale: bool = False
    rms_one_offset: bool = False
    # Gemma-2: softcaps (x -> cap * tanh(x / cap)) on the attention scores
    # and the final logits, the score scale query_pre_attn_scalar**-0.5,
    # sandwich norms after both blocks, the window on even layers only.
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    post_norms: bool = False
    alt_window: bool = False
    # Rolling-buffer KV (EngineConfig.kv_ring): the contiguous cache is a
    # ring of this many slots (slot = position mod kv_ring_len) instead of
    # max_seq_len. The engine sizes it to window + chunk + K + slack, so no
    # write ever clobbers a row still inside a live query's window (a write
    # at position p clobbers p - kv_ring_len). None = slot == position.
    kv_ring_len: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.d_model // self.n_heads


@dataclass
class KVCache:
    """k, v: [n_layers, B, n_kv_heads, max_seq, head_dim] (heads-major, as the
    JAX package and the attention kernels read it).

    An int8 cache (the JAX package's "quantized KV append") holds symmetric
    per-(head, position) scales in k_scale / v_scale [n_layers, B, n_kv_heads,
    max_seq] f32, initialised to ones. The JAX package carries scales for
    every cache; a bf16 cache here carries None instead, which saves their
    memory and never reads them."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelConfig, batch_size: int, max_seq_len: int,
               device, dtype: Optional[torch.dtype] = None) -> "KVCache":
        """dtype: the KV element type, the model dtype by default, or
        torch.int8 for a quantized cache with scales."""
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_seq_len, cfg.head_dim)
        return cls(*kv_buffers(shape, dtype or cfg.dtype, device))

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]


def kv_buffers(shape, dtype: torch.dtype, device):
    """Zeroed k and v of `shape`, and for int8 their scales (shape without
    the head dim) set to ones, as the JAX package initialises them; None
    scales otherwise."""
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    if dtype != torch.int8:
        return k, v, None, None
    ones = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    return k, v, ones, ones.clone()


def quantize_rows(x: torch.Tensor):
    """[..., D] -> (int8 values [..., D], f32 scales [...]): symmetric per
    row, with the f32 steps of the JAX package's _quantize_rows, so the bytes
    and scales are the same bit for bit (amax over D, max(amax, 1e-8) / 127,
    round half to even, clip to +-127)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


@dataclass
class Model:
    """A bound model: config + params (a nested dict of tensors, QuantTensor
    and EmbedQuant leaves, laid out as the JAX package's param tree)."""

    config: ModelConfig
    params: dict

    def forward(self, tokens, positions, cache, cache_lens, return_hidden=False,
                tree_mask=None):
        from llm_inference_lab_tpu_torch.models.transformer import forward

        return forward(self.config, self.params, tokens, positions, cache, cache_lens,
                       return_hidden, tree_mask)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The model's head (JAX's head_fn): hidden states [.., D] -> f32
        logits [.., V], as the forward computes them from its last norm."""
        from llm_inference_lab_tpu_torch.models.transformer import lm_head_logits

        return lm_head_logits(self.config, self.params, hidden)

    def init_cache(self, batch_size: int, max_seq_len: int, device, paged: bool = False,
                   page_size: int = 64, n_pages: Optional[int] = None,
                   table: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None):
        """A contiguous KVCache, or with paged=True a PagedKVCache (a pool of
        n_pages pages of page_size rows and a [batch_size, max_pages] table).
        dtype: the KV element type (None: the model dtype; torch.int8: a
        quantized cache with per-row scales). A ring model's contiguous cache
        holds at most kv_ring_len slots."""
        if paged:
            from llm_inference_lab_tpu_torch.models.paged import PagedKVCache

            return PagedKVCache.create(self.config, batch_size, max_seq_len, device,
                                       n_pages=n_pages, page_size=page_size, table=table,
                                       dtype=dtype)
        if self.config.kv_ring_len is not None:
            max_seq_len = min(max_seq_len, self.config.kv_ring_len)
        return KVCache.create(self.config, batch_size, max_seq_len, device, dtype=dtype)


def cache_slots(start: torch.Tensor, S: int, T: int, ring_len: Optional[int] = None):
    """Where the S new rows per sequence (positions start[b] .. start[b]+S-1)
    land, for ``write_cache_layer``: (b [B, 1], slot [B, n], rows), where the
    last n of the S rows (rows = slice(S - n, None)) are written. Slots
    clip to the buffer as the JAX scatter does; the engine guarantees
    headroom. With ring_len R the slot is position mod R, and when S > R only
    the last R rows land (an earlier row would be overwritten by a later
    one of the same block; JAX drops it). A forward computes this once for
    all its layers."""
    pos = start[:, None] + torch.arange(S, device=start.device)[None]
    rows = slice(None)
    if ring_len is None:
        slots = pos.clamp(0, T - 1)
    else:
        if S > ring_len:
            rows = slice(S - ring_len, None)
            pos = pos[:, rows]
        slots = pos % ring_len
    return torch.arange(start.shape[0], device=start.device)[:, None], slots, rows


def write_cache_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, slots) -> None:
    """Write the new rows k_new/v_new [B, S, n_kv, d] (model compute order)
    of layer `layer` at ``slots = cache_slots(...)``, in place; an int8
    cache quantizes each row as it is written and writes its scale at the
    same slot (the port of update_cache_layer, both branches)."""
    b_idx, slot, rows = slots
    # Advanced indices (b [B,1], slot [B,S]) around the head slice index a
    # [B, S, n_kv, d] block (a [B, S, n_kv] block of scales): exactly the
    # model-order rows.
    for dst, scales, new in ((cache.k, cache.k_scale, k_new), (cache.v, cache.v_scale, v_new)):
        new = new[:, rows]
        if dst.dtype == torch.int8:
            new, scale = quantize_rows(new)
            scales[layer][b_idx, :, slot] = scale
        dst[layer][b_idx, :, slot, :] = new.to(dst.dtype)

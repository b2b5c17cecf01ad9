"""Model config and static-shape KV cache.

Port of llm_inference_lab_tpu/models/base.py (ModelConfig, KVCache, the
per-row int8 quantization and the cache write at absolute positions, or at
position mod ring_len in the rolling-buffer cache) for the eight families:
Llama, Qwen2, Phi-3, Mistral and Mixtral (RMSNorm, rotary, gated MLP or
routed experts), Gemma and Gemma-2, and GPT-2 and OPT (LayerNorm with
biases, learned positions, a plain MLP).

Cache-tail invariant (what makes single-pass verification work): the cache
holds KV for committed tokens [0, L-1), everything except the last committed
token. Each draft/verify forward starts from that last token, so verify is
one forward over [t_{L-1}, d_1..d_K] producing K+1 logit rows. Rejection
just does not advance the length: stale rows beyond it are dead by the
position mask and are overwritten by the next step's writes.

Unlike the JAX package, which threads immutable arrays, the port writes the
new rows into the cache IN PLACE (ops/kv_write.py: kernel H on the card, one
launch a layer for K and V), so a step never copies the cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

# quantize_rows is the int8 cache's row quantization, imported from here too.
from llm_inference_lab_tpu_torch.ops.kv_write import KVSlots, kv_write, quantize_rows  # noqa: F401


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
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    # GPT-2 / OPT: learned absolute positions (row position + pos_offset of
    # the table; HF OPT's offset is 2) and a bias on every projection
    # (use_bias: init_params makes them; the forward reads the bias leaves
    # the params have).
    use_learned_pos: bool = False
    use_bias: bool = False
    # MLP activation: "silu" (Llama) or "gelu_tanh" (Gemma's GeGLU) gate a
    # gated MLP; "gelu" (GPT-2, tanh-approximated as jax.nn.gelu) and "relu"
    # (OPT) a plain two-layer one.
    act: str = "silu"
    pos_offset: int = 0
    # Qwen2: a bias on the fused q/k/v projection only.
    qkv_bias: bool = False
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
    # Mixtral: n_experts gated-MLP experts a layer behind a top-k router
    # (ops/moe.py); 0 = a dense MLP.
    n_experts: int = 0
    experts_per_token: int = 2
    # A rank's axes under a mesh (parallel/mesh.py AxisGroup): the model
    # group of its tensor-parallel collectives (tp), the seq group of its
    # ring prefill and sliced caches (sp), the stage group of its pipeline
    # (pp, with the global index of its first layer, layer0, and the
    # microbatches a forward splits into) and the expert group of its MoE
    # layers (ep). Not fields: a whole model has none, and a rank's share
    # is a RankConfig.
    tp = None
    sp = None
    pp = None
    ep = None
    layer0 = 0
    pp_microbatches = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.d_model // self.n_heads

    @property
    def use_layernorm(self) -> bool:
        """LayerNorm with a bias (GPT-2, OPT) instead of RMSNorm."""
        return self.arch in ("gpt2", "opt")

    @property
    def gated_mlp(self) -> bool:
        """A gated MLP (silu or tanh-gelu gate) instead of the plain one."""
        return self.act in ("silu", "gelu_tanh")

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class RankConfig(ModelConfig):
    """A rank's share of a model under a mesh (parallel/sharding.py
    shard_config): under the model axis the rank's heads (n_heads,
    n_kv_heads) and MLP width (d_ff), head_dim_override the whole model's
    head dim, and ``tp`` the model group its forward's collectives run
    over; under the stage axis its layers (n_layers of them from layer0)
    and ``pp``; ``sp`` and ``ep`` the seq and expert groups."""

    tp: Optional[Any] = None
    sp: Optional[Any] = None
    pp: Optional[Any] = None
    ep: Optional[Any] = None
    layer0: int = 0
    pp_microbatches: Optional[int] = None


@dataclass
class KVCache:
    """k, v: [n_layers, B, n_kv_heads, max_seq, head_dim] (heads-major, as the
    JAX package and the attention kernels read it).

    An int8 cache (the JAX package's "quantized KV append") holds symmetric
    per-(head, position) scales in k_scale / v_scale [n_layers, B, n_kv_heads,
    max_seq] f32, initialised to ones. The JAX package carries scales for
    every cache; a bf16 cache here carries None instead, which saves their
    memory and never reads them.

    t0: None for a cache that holds every position (slot = position); under
    the seq axis a rank's slice of a cache whose T splits (JAX's
    _cache_sharding), slot j holding position t0 + j."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    t0: Optional[int] = None

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


@dataclass
class Model:
    """A bound model: config + params (a nested dict of tensors, QuantTensor
    and EmbedQuant leaves, laid out as the JAX package's param tree), and
    where the weights came from ("random", "given" or a checkpoint's path;
    JAX's extras["weights_source"])."""

    config: ModelConfig
    params: dict
    weights_source: str = "random"

    def forward(self, tokens, positions, cache, cache_lens, return_hidden=False,
                tree_mask=None, lora_ids=None, logits=True, cp=False):
        from llm_inference_lab_tpu_torch.models.transformer import forward

        return forward(self.config, self.params, tokens, positions, cache, cache_lens,
                       return_hidden, tree_mask, lora_ids, logits, cp)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The model's head (JAX's head_fn): hidden states [.., D] -> f32
        logits [.., V], as the forward computes them from its last norm."""
        from llm_inference_lab_tpu_torch.models.transformer import lm_head_logits

        return lm_head_logits(self.config, self.params, hidden)

    def init_cache(self, batch_size: int, max_seq_len: int, device, paged: bool = False,
                   page_size: int = 64, n_pages: Optional[int] = None,
                   table: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None, split: bool = True):
        """A contiguous KVCache, or with paged=True a PagedKVCache (a pool of
        n_pages pages of page_size rows and a [batch_size, max_pages] table).
        dtype: the KV element type (None: the model dtype; torch.int8: a
        quantized cache with per-row scales). A ring model's contiguous cache
        holds at most kv_ring_len slots. Under the seq axis a contiguous
        cache holds the rank's slice of T; split=False keeps every position
        (the batcher's admission scratch, which every seq rank prefills
        whole)."""
        if paged:
            from llm_inference_lab_tpu_torch.models.paged import PagedKVCache

            return PagedKVCache.create(self.config, batch_size, max_seq_len, device,
                                       n_pages=n_pages, page_size=page_size, table=table,
                                       dtype=dtype)
        if self.config.kv_ring_len is not None:
            max_seq_len = min(max_seq_len, self.config.kv_ring_len)
        sp = self.config.sp
        if split and sp is not None and max_seq_len % sp.size == 0:
            # Under the seq axis a T that splits holds this rank's slice (JAX's
            # _cache_sharding); one that does not stays whole.
            per = max_seq_len // sp.size
            cache = KVCache.create(self.config, batch_size, per, device, dtype=dtype)
            cache.t0 = sp.rank * per
            return cache
        return KVCache.create(self.config, batch_size, max_seq_len, device, dtype=dtype)


def lane_slots(B: int, s: torch.Tensor, outer: torch.Tensor, slot: torch.Tensor) -> KVSlots:
    """KVSlots of the rows s [n] of every sequence b < B, each at its
    (outer [B, n], slot [B, n])."""
    b = torch.arange(B, device=s.device)[:, None]
    # contiguous: at B = 1 a reshape of an expanded index is a stride-0 view
    return KVSlots(*(t.expand_as(slot).reshape(-1).to(torch.int32).contiguous()
                     for t in (b, s[None], outer, slot)))


def cache_slots(start: torch.Tensor, S: int, T: int, ring_len: Optional[int] = None) -> KVSlots:
    """Where the S new rows per sequence (positions start[b] .. start[b]+S-1)
    land, for ``write_cache_layer``: the KVSlots of the last n of the S rows
    of each sequence, at (b, slot). Slots clip to the buffer as the JAX
    scatter does; the engine guarantees headroom. With ring_len R the slot
    is position mod R, and when S > R only the last R rows land (an earlier
    row would be overwritten by a later one of the same block; JAX drops
    it). A forward computes this once for all its layers, on the device."""
    rows = torch.arange(S, device=start.device)
    if ring_len is not None and S > ring_len:
        rows = rows[S - ring_len:]
    pos = start[:, None].long() + rows[None]
    slots = pos.clamp(0, T - 1) if ring_len is None else pos % ring_len
    b = torch.arange(start.shape[0], device=start.device)[:, None]
    return lane_slots(start.shape[0], rows, b, slots)


def slice_slots(start: torch.Tensor, S: int, t0: int, T: int) -> KVSlots:
    """The rows of a chunk of S rows per sequence at positions start[b] ..
    start[b] + S - 1 that fall in the slice [t0, t0 + T), and their slots
    (position - t0): a row outside it is not written, so a rank whose slice
    holds none writes nothing. Reads the rows on the host (the seq axis
    runs its forwards eagerly)."""
    pos = start[:, None].long() + torch.arange(S, device=start.device)[None]
    b, row = ((pos >= t0) & (pos < t0 + T)).nonzero(as_tuple=True)
    return KVSlots(*(t.to(torch.int32) for t in (b, row, b, pos[b, row] - t0)))


def write_cache_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, slots: KVSlots) -> None:
    """Write the new rows k_new/v_new [B, S, n_kv, d] (model compute order)
    of layer `layer` at ``slots = cache_slots(...)`` (or a slice's
    ``slice_slots``), in place; an int8 cache quantizes each row as it is
    written and writes its scale at the same slot (the port of
    update_cache_layer, both branches): ops/kv_write.py, one launch on the
    card."""
    int8 = cache.k_scale is not None
    kv_write(cache.k[layer], cache.v[layer], cache.k_scale[layer] if int8 else None,
             cache.v_scale[layer] if int8 else None, k_new, v_new, slots)

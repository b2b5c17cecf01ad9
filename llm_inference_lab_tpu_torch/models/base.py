"""Model config and static-shape KV cache.

Port of llm_inference_lab_tpu/models/base.py (ModelConfig, KVCache and the
cache write at absolute positions) for the Llama family.

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

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclass
class KVCache:
    """k, v: [n_layers, B, n_kv_heads, max_seq, head_dim] (heads-major, as the
    JAX package and the flash_decode kernel read it)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, batch_size: int, max_seq_len: int,
               device, dtype: Optional[torch.dtype] = None) -> "KVCache":
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_seq_len, cfg.head_dim)
        dtype = dtype or cfg.dtype
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]


@dataclass
class Model:
    """A bound model: config + params (a nested dict of tensors, QuantTensor
    and EmbedQuant leaves, laid out as the JAX package's param tree)."""

    config: ModelConfig
    params: dict

    def forward(self, tokens, positions, cache, cache_lens):
        from llm_inference_lab_tpu_torch.models.transformer import forward

        return forward(self.config, self.params, tokens, positions, cache, cache_lens)

    def init_cache(self, batch_size: int, max_seq_len: int, device) -> KVCache:
        return KVCache.create(self.config, batch_size, max_seq_len, device)


def cache_slots(start: torch.Tensor, S: int, T: int):
    """Index of the S new rows per sequence, slots start[b] .. start[b]+S-1,
    for ``write_cache_layer``: (b [B, 1], slot [B, S]). Slots clip to the
    buffer as the JAX scatter does; the engine guarantees headroom. A
    forward computes it once for all its layers."""
    slots = (start[:, None] + torch.arange(S, device=start.device)[None]).clamp(0, T - 1)
    return torch.arange(start.shape[0], device=start.device)[:, None], slots


def write_cache_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, slots) -> None:
    """Write the new rows k_new/v_new [B, S, n_kv, d] (model compute order)
    of layer `layer` at ``slots = cache_slots(...)``, in place."""
    b_idx, slot = slots
    # Advanced indices (b [B,1], slot [B,S]) around the head slice index a
    # [B, S, n_kv, d] block: exactly the model-order rows.
    cache.k[layer][b_idx, :, slot, :] = k_new.to(cache.k.dtype)
    cache.v[layer][b_idx, :, slot, :] = v_new.to(cache.v.dtype)

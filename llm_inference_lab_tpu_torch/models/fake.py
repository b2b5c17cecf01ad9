"""Deterministic fake model, the engine's test fixture (port of
llm_inference_lab_tpu/models/fake.py ``fake_forward`` and
``make_fake_model``).

Next-token rule, a pure function of (token, position):

    next = (mult * token + 31 * position + shift) % vocab

Two fake models with the same (mult, shift) agree everywhere (acceptance
1.0). ``miss_permille`` moves a prediction off by one where a hash of
(token, position) falls below it, which gives a controllable acceptance
rate with no randomness. The logits peak (+8) at the prediction over a
smooth position-dependent tail, so the confidence, top-k and typical
policies see a realistic distribution; the forward writes each token's
value into its cache row, in place, through the real models' cache write.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from llm_inference_lab_tpu_torch.models.base import (
    KVCache,
    Model,
    ModelConfig,
    cache_slots,
    write_cache_layer,
)

_M32 = 0xFFFFFFFF


def fake_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, positions: torch.Tensor,
                 cache, cache_lens: torch.Tensor):
    """(logits [B, S, V] f32, cache) for tokens and positions [B, S]."""
    if cache is not None and not isinstance(cache, KVCache):
        raise NotImplementedError("the fake model writes a contiguous KV cache only")
    V = cfg.vocab_size
    nxt = (params["mult"] * tokens + 31 * positions + params["shift"]) % V
    # Knuth multiplicative hash of (token, position) in uint32 arithmetic,
    # exact in int64.
    h = ((tokens.long() * 2654435761 + positions.long() * 40503) & _M32) % 1000
    nxt = (nxt + (h < params["miss_permille"]).to(nxt.dtype)) % V
    vocab_ids = torch.arange(V, dtype=torch.int32, device=tokens.device)
    tail = torch.cos((vocab_ids[None, None, :] + positions[..., None]).float() * 0.1)
    logits = tail + 8.0 * torch.nn.functional.one_hot(nxt.long(), V).float()
    if cache is not None:
        B, S = tokens.shape
        val = tokens.to(cache.k.dtype)[:, :, None, None].expand(B, S, cfg.n_kv_heads,
                                                               cfg.head_dim)
        write_cache_layer(cache, 0, val, val, cache_slots(cache_lens, S, cache.k.shape[3]))
    return logits, cache


FAKE_CONFIG = ModelConfig(name="fake", arch="fake", vocab_size=256, n_layers=1, n_heads=1,
                          n_kv_heads=1, d_model=8, d_ff=8, max_position_embeddings=65536)


@dataclass
class FakeModel(Model):
    def forward(self, tokens, positions, cache, cache_lens):
        return fake_forward(self.config, self.params, tokens, positions, cache, cache_lens)


def make_fake_model(vocab_size: int = 256, mult: int = 7, shift: int = 3,
                    miss_permille: int = 0, name: str = "fake") -> FakeModel:
    cfg = replace(FAKE_CONFIG, vocab_size=vocab_size, name=name)
    return FakeModel(config=cfg, params={"mult": mult, "shift": shift,
                                         "miss_permille": miss_permille})

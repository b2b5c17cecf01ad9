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

With ``return_hidden`` the forward also returns a hidden state [B, S, 8]
f32 holding each row's token in channel 0 and its position in channel 1,
and the model's head (``fake_head``) rounds them back and applies the rule
twice: fed the hidden of the row that predicted token x at position q, it
proposes the model's prediction for the token after x. So Medusa, EAGLE
and tree drafting accept on the fake model without a trained head. The
tree mask is taken for the protocol and not read (the rule reads no
cache).
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
                 cache, cache_lens: torch.Tensor, return_hidden: bool = False,
                 tree_mask=None):
    """(logits [B, S, V] f32, cache) for tokens and positions [B, S], and
    with return_hidden the hidden state [B, S, d_model] f32 third."""
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
        # The token in the cache's type (JAX's value); an int8 cache's rows
        # go to the write in f32, which quantizes them.
        val = tokens.to(cache.k.dtype)
        if cache.k.dtype == torch.int8:
            val = val.float()
        val = val[:, :, None, None].expand(B, S, cfg.n_kv_heads, cfg.head_dim)
        write_cache_layer(cache, 0, val, val, cache_slots(cache_lens, S, cache.k.shape[3]))
    if return_hidden:
        hidden = torch.zeros((*tokens.shape, cfg.d_model), dtype=torch.float32,
                             device=tokens.device)
        hidden[..., 0] = tokens.float()
        hidden[..., 1] = positions.float()
        return logits, cache, hidden
    return logits, cache


def fake_head(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Peaked logits (8 at one token, 0 elsewhere) at two steps of the rule
    from the (token, position) in channels 0 and 1 of `hidden`, rounded to
    integers: the token after the one that row predicts."""
    t = torch.round(hidden[..., 0].float()).long()
    pos = torch.round(hidden[..., 1].float()).long()
    V = cfg.vocab_size
    x1 = (params["mult"] * t + 31 * pos + params["shift"]) % V
    x2 = (params["mult"] * x1 + 31 * (pos + 1) + params["shift"]) % V
    return torch.nn.functional.one_hot(x2, V).float() * 8.0


FAKE_CONFIG = ModelConfig(name="fake", arch="fake", vocab_size=256, n_layers=1, n_heads=1,
                          n_kv_heads=1, d_model=8, d_ff=8, max_position_embeddings=65536)


@dataclass
class FakeModel(Model):
    def forward(self, tokens, positions, cache, cache_lens, return_hidden=False,
                tree_mask=None, lora_ids=None, logits=True, cp=False):
        # No layers: no LoRA pack (the engine refuses adapters here), and the
        # logits cost nothing to make; no attention for a ring prefill (the
        # engine keeps the fake model out of the seq axis, as JAX's).
        return fake_forward(self.config, self.params, tokens, positions, cache, cache_lens,
                            return_hidden, tree_mask)

    def head(self, hidden):
        return fake_head(self.config, self.params, hidden)


def make_fake_model(vocab_size: int = 256, mult: int = 7, shift: int = 3,
                    miss_permille: int = 0, name: str = "fake") -> FakeModel:
    cfg = replace(FAKE_CONFIG, vocab_size=vocab_size, name=name)
    return FakeModel(config=cfg, params={"mult": mult, "shift": shift,
                                         "miss_permille": miss_permille})

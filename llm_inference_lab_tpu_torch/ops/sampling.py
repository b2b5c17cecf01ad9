"""Token sampling: port of llm_inference_lab_tpu/ops/sampling.py
(``filtered_logits`` with static parameters, ``proposal_log_probs`` and
``sample_tokens``) and the port's own counter-based random numbers.

Randomness. JAX threads an explicit key (``DecodeState.rng``) and splits it
every step. The port does the same with a key of its own: an int64 tensor
holding a 32-bit value, derived from the call's seed by ``seed_key``.
``fold(key, data)`` derives a new key from a key and an integer (JAX's
``fold_in``), and a draw is a hash of (key, row, column): ``uniform`` and
``gumbel`` compute it with plain integer tensor ops, with no generator
state. So a step captured in a CUDA graph draws fresh numbers on every
replay (the key it reads has advanced), the in-place step draws what the
functional one draws, and the card draws what the CPU draws.
``sample_tokens`` samples by Gumbel-max, as ``jax.random.categorical`` does.
Torch's numbers are not JAX's: parity with JAX is statistical for a sampled
path and exact for a greedy one.

The per-row (dynamic) filter path of JAX, penalties and ``logit_bias``
belong to per-request sampling, which is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

_M32 = 0xFFFFFFFF
# Odd multipliers below 2**31, so that a 32-bit value times one stays below
# 2**63: every product of the hash is exact in int64, on any device.
_MUL_A, _MUL_B = 0x7FEB352D, 0x5BD1E995
_GOLDEN = 0x1E3779B9

Key = Union[int, torch.Tensor]


def _mix(h: Key) -> Key:
    """A 32-bit finalizer (murmur3's shape): a bijection of [0, 2**32) with
    full avalanche. Works on Python ints and int64 tensors alike."""
    h = h ^ (h >> 16)
    h = (h * _MUL_A) & _M32
    h = h ^ (h >> 15)
    h = (h * _MUL_B) & _M32
    return h ^ (h >> 16)


def seed_key(seed: int) -> int:
    """The key of a seed, as a Python int in [0, 2**32) (JAX PRNGKey)."""
    return _mix(int(seed) & _M32)


def fold(key: Key, data: Key) -> Key:
    """A new key from a key and an integer in [0, 2**31 - 1) (JAX fold_in).
    data + 1, so that no key is its own fold (_mix keeps 0 at 0)."""
    return _mix((key + (data + 1) * _GOLDEN) & _M32)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """f32 uniforms in (0, 1) of `shape`, a hash of (key, row, column): the
    leading dims flatten to rows, the last is the column."""
    shape = tuple(shape)
    rows, cols = math.prod(shape[:-1]), shape[-1]
    dev = key.device
    row_keys = fold(key, torch.arange(rows, dtype=torch.int64, device=dev))[:, None]
    h = fold(row_keys, torch.arange(cols, dtype=torch.int64, device=dev)[None])
    return (((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24).reshape(shape)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel noise of `shape` from uniform(key, shape)."""
    return -torch.log(-torch.log(uniform(key, shape)))


def filtered_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0, min_p: float = 0.0) -> torch.Tensor:
    """Temperature-scale, then mask (-inf) everything outside the min_p,
    top_k and top_p filters, in that order: the pre-softmax form of the
    sampling distribution, in f32. min_p drops l < l_max + log(min_p);
    top_p keeps the tokens whose exclusive cumulative mass is below top_p
    (so always the top one). Disabled filters cost nothing."""
    V = logits.shape[-1]
    scaled = logits.float() / max(temperature, 1e-6)
    if min_p and min_p > 0.0:
        mx = scaled.amax(dim=-1, keepdim=True)
        scaled = torch.where(scaled < mx + math.log(min_p), float("-inf"), scaled)
    if top_k and top_k > 0:
        kth = torch.topk(scaled, min(top_k, V), dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = ((cum - probs) < top_p) & torch.isfinite(sorted_logits)
        cutoff = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    return scaled


def proposal_log_probs(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0, min_p: float = 0.0,
                       greedy: bool = False) -> torch.Tensor:
    """Log-probs of the distribution ``sample_tokens`` samples from with
    these settings; greedy is a point mass at the argmax."""
    if greedy or temperature <= 0.0:
        best = torch.argmax(logits, dim=-1, keepdim=True)
        onehot = torch.arange(logits.shape[-1], device=logits.device) == best
        return torch.where(onehot, 0.0, float("-inf"))
    return torch.log_softmax(filtered_logits(logits, temperature, top_k, top_p, min_p), dim=-1)


def sample_tokens(key: Optional[torch.Tensor], logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                  greedy: bool = False) -> torch.Tensor:
    """[B, V] logits -> [B] int32 ids in [0, V). Greedy or temperature <= 0:
    the argmax (first maximal index on ties; `key` unused). Otherwise a
    Gumbel-max draw from the filtered logits with gumbel(key, [B, V]); a row
    whose filtered maximum is not finite (all NaN or all -inf) takes the
    argmax of its logits."""
    V = logits.shape[-1]
    fallback = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy or temperature <= 0.0:
        return fallback
    scaled = filtered_logits(logits, temperature, top_k, top_p, min_p)
    sampled = torch.argmax(scaled + gumbel(key, scaled.shape), dim=-1).to(torch.int32)
    bad = ~torch.isfinite(scaled.amax(dim=-1))
    return torch.where(bad, fallback, sampled).clamp(0, V - 1)

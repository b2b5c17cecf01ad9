"""Token sampling: port of llm_inference_lab_tpu/ops/sampling.py
(``filtered_logits`` with static or per-row parameters, ``proposal_log_probs``,
``sample_tokens``, ``token_counts``, ``apply_penalties``, ``logit_bias_row``
and ``apply_logit_bias``) and the port's own counter-based random numbers.

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

Per-request sampling (the serving path): the parameters are [B] tensors,
one value a row, and each row may draw from its own key (``row_keys``, [B]
int64: a slot's key folded with the row's committed length and the
sampling site, ``fold_rows``), so a request's draws depend on its seed,
prompt and parameters only. The per-row filters take one descending sort a
row (JAX's dynamic path): the k-th value is the top_k threshold and the
same sort gives the top_p cutoff after top_k. A row at temperature <= 0 is
greedy. Everything is computed branch-free, so a captured step takes any
mix of rows.
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


def fold_rows(row_keys: torch.Tensor, site: Key) -> torch.Tensor:
    """Fold a sampling site into per-row keys [R] (JAX's fold_rows)."""
    return fold(row_keys, site)


def uniform_rows(row_keys: torch.Tensor, cols: int) -> torch.Tensor:
    """f32 uniforms in (0, 1) of [R, cols], a hash of (row_keys[r],
    column): each row draws from its own key."""
    cols_idx = torch.arange(cols, dtype=torch.int64, device=row_keys.device)[None]
    h = fold(row_keys[:, None], cols_idx)
    return ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def token_counts(tokens: torch.Tensor, lengths: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[B, V] int32 occurrence counts of every token in each sequence's
    committed prefix: counts[b, v] = |{t < lengths[b] : tokens[b, t] == v}|.
    One scatter-add over the token buffer."""
    B, T = tokens.shape
    valid = (torch.arange(T, device=tokens.device)[None] < lengths[:, None]).to(torch.int32)
    idx = tokens.clamp(0, vocab_size - 1).long()
    return torch.zeros((B, vocab_size), dtype=torch.int32,
                       device=tokens.device).scatter_add_(1, idx, valid)


def _bcast(p, x: torch.Tensor, dtype=torch.float32):
    """A [B] parameter reshaped to broadcast against [B, ..., V] (a scalar
    passes through)."""
    if not isinstance(p, torch.Tensor):
        return p
    p = p.to(dtype)
    return p.reshape(p.shape + (1,) * (x.ndim - p.ndim))


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor, repetition=1.0, presence=0.0,
                    frequency=0.0) -> torch.Tensor:
    """Penalize the logits of tokens already seen, before temperature and
    the filters (HF's order), in f32. Repetition (HF): seen and > 0 ->
    logit / r, seen and < 0 -> logit * r. Presence and frequency (OpenAI):
    logit - presence * [count > 0] - frequency * count. Each parameter a
    float or [B]; counts [B, V] or [B, ..., V]. At 1.0, 0.0 and 0.0 every
    value is unchanged (x / 1, x * 1, x - 0 - 0)."""
    x = logits.float()
    c = counts.float()
    if c.ndim < x.ndim:  # [B, V] counts against [B, K, V] logits
        c = c.reshape(c.shape[:1] + (1,) * (x.ndim - c.ndim) + c.shape[1:])
    rep, pres, freq = (_bcast(p, x) for p in (repetition, presence, frequency))
    seen = c > 0
    x = torch.where(seen & (x > 0), x / rep, torch.where(seen, x * rep, x))
    return x - pres * seen.float() - freq * c


def logit_bias_row(bias_ids: torch.Tensor, bias_vals: torch.Tensor,
                   vocab_size: int) -> torch.Tensor:
    """The dense [B, V] f32 additive bias of fixed-width (id, value) pairs
    [B, N] (id -1: an empty pair). Computed once a step and added at every
    draft position and verify row."""
    B = bias_ids.shape[0]
    vals = torch.where(bias_ids >= 0, bias_vals.float(), 0.0)
    return torch.zeros((B, vocab_size), dtype=torch.float32, device=bias_ids.device).scatter_add_(
        1, bias_ids.clamp(0, vocab_size - 1).long(), vals)


def apply_logit_bias(logits: torch.Tensor, bias_ids: torch.Tensor,
                     bias_vals: torch.Tensor) -> torch.Tensor:
    """OpenAI ``logit_bias``: logits [B, ..., V] plus each row's biases
    (-100 bans a token, +100 forces it), in f32."""
    row = logit_bias_row(bias_ids, bias_vals, logits.shape[-1])
    return logits.float() + row.reshape(row.shape[:1] + (1,) * (logits.ndim - 2) + row.shape[1:])


def _dynamic(*params) -> bool:
    """Any sampling parameter given as a tensor (one value a row)?"""
    return any(isinstance(p, torch.Tensor) for p in params)


def filtered_logits(logits: torch.Tensor, temperature=1.0, top_k=0, top_p=1.0,
                    min_p=0.0) -> torch.Tensor:
    """Temperature-scale, then mask (-inf) everything outside the min_p,
    top_k and top_p filters, in that order: the pre-softmax form of the
    sampling distribution, in f32. min_p drops l < l_max + log(min_p);
    top_p keeps the tokens whose exclusive cumulative mass is below top_p
    (so always the top one). Scalar parameters: disabled filters cost
    nothing. [B] tensors (per-request): one descending sort a row gives the
    k-th value as the top_k threshold (0 = off) and the top_p cutoff over
    the ranks top_k keeps (a row at top_p >= 1 keeps everything), as JAX's
    dynamic path."""
    V = logits.shape[-1]
    if _dynamic(temperature, top_k, top_p, min_p):
        return _filtered_rows(logits, temperature, top_k, top_p, min_p)
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


def _filtered_rows(logits: torch.Tensor, temperature, top_k, top_p, min_p) -> torch.Tensor:
    """filtered_logits with per-row parameters (JAX's dynamic path)."""
    V = logits.shape[-1]
    dev = logits.device
    as_t = (lambda p, dt: p.to(dt) if isinstance(p, torch.Tensor)
            else torch.tensor(p, dtype=dt, device=dev))
    t = _bcast(as_t(temperature, torch.float32), logits)
    scaled = logits.float() / torch.clamp_min(t, 1e-6)
    mp = _bcast(as_t(min_p, torch.float32), logits)
    mx = scaled.amax(dim=-1, keepdim=True)
    scaled = torch.where((mp > 0.0) & (scaled < mx + torch.log(torch.clamp_min(mp, 1e-9))),
                         float("-inf"), scaled)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = _bcast(as_t(top_k, torch.int32), logits, torch.int32)
    kth = sorted_desc.gather(-1, (k - 1).clamp(0, V - 1).long().expand(scaled.shape[:-1] + (1,)))
    scaled = torch.where((k > 0) & (scaled < kth), float("-inf"), scaled)
    ranks = torch.arange(V, dtype=torch.int32, device=dev)
    sorted_masked = torch.where((k > 0) & (ranks >= k), float("-inf"), sorted_desc)
    probs = torch.softmax(sorted_masked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p = _bcast(as_t(top_p, torch.float32), logits)
    keep = (((cum - probs) < p) | (p >= 1.0)) & torch.isfinite(sorted_masked)
    cutoff = torch.where(keep, sorted_masked, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(scaled < cutoff, float("-inf"), scaled)


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


def sample_tokens(key: Optional[torch.Tensor], logits: torch.Tensor, temperature=1.0,
                  top_k=0, top_p=1.0, min_p=0.0, greedy: bool = False,
                  row_keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, V] logits -> [B] int32 ids in [0, V). Greedy (or a scalar
    temperature <= 0): the argmax (first maximal index on ties; `key`
    unused). Otherwise a Gumbel-max draw from the filtered logits, with
    gumbel(key, [B, V]) or, given row_keys [B], each row's own noise; a row
    whose filtered maximum is not finite (all NaN or all -inf) takes the
    argmax of its logits. Per-row parameters ([B] tensors): a row at
    temperature <= 0 takes the argmax."""
    V = logits.shape[-1]
    fallback = torch.argmax(logits, dim=-1).to(torch.int32)
    dynamic = _dynamic(temperature, top_k, top_p, min_p)
    if greedy or (not dynamic and temperature <= 0.0):
        return fallback
    scaled = filtered_logits(logits, temperature, top_k, top_p, min_p)
    noise = (-torch.log(-torch.log(uniform_rows(row_keys, V))) if row_keys is not None
             else gumbel(key, scaled.shape))
    sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    bad = ~torch.isfinite(scaled.amax(dim=-1))
    out = torch.where(bad, fallback, sampled)
    if dynamic and isinstance(temperature, torch.Tensor):
        out = torch.where(temperature <= 0.0, fallback, out)
    return out.clamp(0, V - 1)

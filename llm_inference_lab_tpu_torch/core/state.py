"""DecodeState: the decoding state of a batch, as tensors on the device.

Port of llm_inference_lab_tpu/core/state.py with only the fields the ported
slice reads. Invariants (as in the JAX package):

* ``tokens[b, :lengths[b]]`` are the committed tokens of sequence b; the
  buffer beyond is scratch.
* Both KV caches hold exactly the committed tokens [0, lengths[b]-1): all but
  the last committed token. Cache slot index == absolute position (for a
  paged cache: page ordinal * page size + row in the page).
* ``active[b]`` is False once b hit EOS, its budget or the buffer end;
  inactive lanes still flow through the batched step but commit nothing.

The steps return a new DecodeState; the KV caches inside are updated in
place by the forwards. ``assign`` writes one state's tensors into another's
(the in-place steps of core/specstep.py, which a CUDA graph replays), and
``reset_state`` returns a state to ``init_state``'s values in place.

``rng`` is the state's random key (ops/sampling.py), seeded from the call's
seed and advanced by every step that has an active lane; ``ctrl_k`` and
``acc_ema`` are the device-side adaptive controller's per-lane K and
acceptance EMA. ``last_hidden`` and ``prev_hidden`` are the hidden-state
carry of the head modes (Medusa, EAGLE, tree): the target's final hidden
row that predicted the last committed token, and the one before it (f32
[B, D_target]; zeros, and untouched, in the other modes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from llm_inference_lab_tpu_torch.models.base import KVCache, Model
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache
from llm_inference_lab_tpu_torch.ops.sampling import seed_key


@dataclass
class DecodeState:
    tokens: torch.Tensor  # [B, max_len] int32
    lengths: torch.Tensor  # [B] int32 — committed length L
    prompt_lens: torch.Tensor  # [B] int32
    max_new: torch.Tensor  # [B] int32 — per-sequence generation budget
    active: torch.Tensor  # [B] bool
    target_cache: Union[KVCache, PagedKVCache]
    draft_cache: Optional[Union[KVCache, PagedKVCache]]
    proposed: torch.Tensor  # [B] int32 — draft tokens proposed
    accepted: torch.Tensor  # [B] int32 — draft tokens accepted
    bonus: torch.Tensor  # [B] int32 — bonus/fallback tokens emitted
    token_logprobs: torch.Tensor  # [B, max_len] f32 — target log-prob per token
    steps: torch.Tensor  # [] int32 — decode steps run with an active lane
    rng: torch.Tensor  # [] int64 — the random key, a 32-bit value
    ctrl_k: torch.Tensor  # [B] int32 — device-side adaptive K per lane
    acc_ema: torch.Tensor  # [B] f32 — its acceptance EMA per lane
    last_hidden: torch.Tensor  # [B, D_target] f32 — the head modes' hidden carry
    prev_hidden: torch.Tensor  # [B, D_target] f32 — the carry a step before (EAGLE)


# The tensors a step or a prefill may replace (all but the caches).
FIELDS = ("tokens", "lengths", "prompt_lens", "max_new", "active", "proposed", "accepted",
          "bonus", "token_logprobs", "steps", "rng", "ctrl_k", "acc_ema", "last_hidden",
          "prev_hidden")


def cache_tensors(cache) -> tuple:
    """Every tensor of a KV cache (contiguous or paged), None for an absent
    one."""
    if cache is None:
        return ()
    return (cache.k, cache.v, cache.k_scale, cache.v_scale, getattr(cache, "table", None))


def state_tensors(state: DecodeState) -> tuple:
    """Every tensor a step reads or writes: the fields and both caches."""
    return (tuple(getattr(state, name) for name in FIELDS) + cache_tensors(state.target_cache)
            + cache_tensors(state.draft_cache))


def assign(state: DecodeState, new: DecodeState) -> DecodeState:
    """Write `new`'s fields into `state`'s own tensors (copy_) and return
    `state`: its tensors stay the same objects, so a graph captured over them
    sees the values. Both must share their caches (the forwards write those
    in place)."""
    if new.target_cache is not state.target_cache or new.draft_cache is not state.draft_cache:
        raise ValueError("assign: the two states must share their KV caches")
    for name in FIELDS:
        src, dst = getattr(new, name), getattr(state, name)
        if src is not dst:
            dst.copy_(src)
    return state


def reset_state(state: DecodeState, max_new_tokens: int, seed: int = 0,
                init_k: int = 4) -> DecodeState:
    """``init_state``'s values in the state's own tensors: zeros (the hidden
    carry too), every lane's budget max_new_tokens, the key of `seed`, every lane's K init_k
    and EMA 0.5, zeroed caches with int8 scales of one; a paged cache keeps
    its table."""
    for name in FIELDS:
        getattr(state, name).zero_()
    state.max_new.fill_(max_new_tokens)
    state.rng.fill_(seed_key(seed))
    state.ctrl_k.fill_(init_k)
    state.acc_ema.fill_(0.5)
    for cache in (state.target_cache, state.draft_cache):
        if cache is None:
            continue
        cache.k.zero_()
        cache.v.zero_()
        for scale in (cache.k_scale, cache.v_scale):
            if scale is not None:
                scale.fill_(1.0)
    return state


def init_state(target_model: Model, draft_model: Optional[Model], batch_size: int,
               max_seq_len: int, device, max_new_tokens: int = 64, paged: bool = False,
               page_size: int = 64, n_pages: Optional[int] = None,
               table: Optional[torch.Tensor] = None,
               kv_dtype: Optional[torch.dtype] = None, seed: int = 0,
               init_k: int = 4) -> DecodeState:
    """paged=True gives both models a PagedKVCache: n_pages pages of
    page_size rows (default batch_size * max_pages) and, unless a table is
    given, the default table that gives slot b the pages [b*m, (b+1)*m).
    Each cache keeps its own copy of a given table. kv_dtype torch.int8
    makes both caches (or pools) int8 with per-row scales; None keeps the
    models' dtype. seed: the key's seed; init_k: each lane's first K under
    the device-side adaptive controller."""
    B = batch_size
    kv_kw = dict(paged=paged, page_size=page_size, n_pages=n_pages, table=table, dtype=kv_dtype)

    def zeros_i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return DecodeState(
        tokens=zeros_i32(B, max_seq_len),
        lengths=zeros_i32(B),
        prompt_lens=zeros_i32(B),
        max_new=torch.full((B,), max_new_tokens, dtype=torch.int32, device=device),
        active=torch.zeros((B,), dtype=torch.bool, device=device),
        target_cache=target_model.init_cache(B, max_seq_len, device, **kv_kw),
        draft_cache=(draft_model.init_cache(B, max_seq_len, device, **kv_kw)
                     if draft_model is not None else None),
        proposed=zeros_i32(B),
        accepted=zeros_i32(B),
        bonus=zeros_i32(B),
        token_logprobs=torch.zeros((B, max_seq_len), dtype=torch.float32, device=device),
        steps=torch.zeros((), dtype=torch.int32, device=device),
        rng=torch.tensor(seed_key(seed), dtype=torch.int64, device=device),
        ctrl_k=torch.full((B,), init_k, dtype=torch.int32, device=device),
        acc_ema=torch.full((B,), 0.5, dtype=torch.float32, device=device),
        last_hidden=torch.zeros((B, target_model.config.d_model), dtype=torch.float32,
                                device=device),
        prev_hidden=torch.zeros((B, target_model.config.d_model), dtype=torch.float32,
                                device=device),
    )

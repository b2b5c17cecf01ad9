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

Per-request sampling (JAX core/state.py:60-112): each slot's
``temperature``, ``top_k``, ``top_p`` and ``min_p``, its penalties
(``rep_penalty``, ``presence_penalty``, ``freq_penalty``), its
``logit_bias`` as fixed-width pairs (``bias_ids`` [B, N_BIAS], id -1
empty, and ``bias_vals``) and its key ``slot_rng`` ([B] int64, a 32-bit
value: the request's seed; a row draws from it folded with its committed
length and the sampling site). A step built with ``per_request_sampling``
reads them; the others never do. ``top_ids`` and ``top_lps`` hold the top-N
alternatives of each committed position ([B, max_len, N] under
``logprobs_topk``; [B, 1, 1] placeholders when off). All are in ``FIELDS``:
a captured graph reads them from the state's own tensors, which admission
writes in place.

Multi-LoRA (JAX core/state.py:69-72): ``lora_ids`` [B] int32, each slot's
adapter in the target's LoRA pack (-1: the base model), which every target
forward reads; in ``FIELDS``, so a captured graph reads it in place.

Grammar-constrained decoding (JAX core/state.py:73-81, constrain/runtime.py):
each slot's FSM, ``fsm_lex`` [B] (the lexer state; -1 unconstrained, -2
dead), ``fsm_stack`` [B, STACK_DEPTH] (nesting symbols, bottom-first) and
``fsm_sp`` [B] (the stack height), all int32. Only a step built with the
grammar's tables reads or advances them; admission writes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from llm_inference_lab_tpu_torch.constrain.runtime import STACK_DEPTH, UNCONSTRAINED
from llm_inference_lab_tpu_torch.models.base import KVCache, Model
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache
from llm_inference_lab_tpu_torch.ops.sampling import fold, seed_key

N_BIAS = 32  # logit_bias pairs a slot holds (JAX init_state's n_bias)
# The per-slot sampling values of a state with no request's own: the
# engine's (core/engine.py sampling_defaults) or these.
SAMPLING_DEFAULTS = dict(temperature=1.0, top_k=0, top_p=1.0, min_p=0.0, rep_penalty=1.0,
                         presence_penalty=0.0, freq_penalty=0.0)


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
    temperature: torch.Tensor  # [B] f32 — per-request; <= 0 greedy
    top_k: torch.Tensor  # [B] int32 — 0 off
    top_p: torch.Tensor  # [B] f32 — 1.0 off
    min_p: torch.Tensor  # [B] f32 — 0.0 off
    slot_rng: torch.Tensor  # [B] int64 — each slot's key, a 32-bit value
    rep_penalty: torch.Tensor  # [B] f32 — 1.0 off
    presence_penalty: torch.Tensor  # [B] f32 — 0.0 off
    freq_penalty: torch.Tensor  # [B] f32 — 0.0 off
    bias_ids: torch.Tensor  # [B, N_BIAS] int32 — logit_bias ids, -1 empty
    bias_vals: torch.Tensor  # [B, N_BIAS] f32
    top_ids: torch.Tensor  # [B, max_len, N] int32 ([B, 1, 1] when off)
    top_lps: torch.Tensor  # [B, max_len, N] f32 ([B, 1, 1] when off)
    fsm_lex: torch.Tensor  # [B] int32 — the grammar's lexer state; -1 unconstrained
    fsm_stack: torch.Tensor  # [B, STACK_DEPTH] int32 — its nesting stack
    fsm_sp: torch.Tensor  # [B] int32 — the stack height
    lora_ids: torch.Tensor  # [B] int32 — each slot's LoRA adapter, -1 the base


# The tensors a step or a prefill may replace (all but the caches).
FIELDS = ("tokens", "lengths", "prompt_lens", "max_new", "active", "proposed", "accepted",
          "bonus", "token_logprobs", "steps", "rng", "ctrl_k", "acc_ema", "last_hidden",
          "prev_hidden", "temperature", "top_k", "top_p", "min_p", "slot_rng", "rep_penalty",
          "presence_penalty", "freq_penalty", "bias_ids", "bias_vals", "top_ids", "top_lps",
          "fsm_lex", "fsm_stack", "fsm_sp", "lora_ids")


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


def _fill_sampling(state: DecodeState, seed: int, defaults: Optional[dict]) -> None:
    """The per-slot sampling values with no request's own, in place: the
    defaults, slot b's key fold(seed_key(seed), b) (JAX: fold_in(PRNGKey(seed),
    b)), no logit_bias."""
    for name, value in dict(SAMPLING_DEFAULTS, **(defaults or {})).items():
        getattr(state, name).fill_(value)
    B = state.slot_rng.shape[0]
    state.slot_rng.copy_(fold(seed_key(seed), torch.arange(B, dtype=torch.int64,
                                                            device=state.slot_rng.device)))
    state.bias_ids.fill_(-1)


def reset_state(state: DecodeState, max_new_tokens: int, seed: int = 0,
                init_k: int = 4, defaults: Optional[dict] = None,
                fsm_init: int = UNCONSTRAINED, lora_id: int = -1) -> DecodeState:
    """``init_state``'s values in the state's own tensors: zeros (the hidden
    carry too), every lane's budget max_new_tokens, the key of `seed`, every
    lane's K init_k and EMA 0.5, the per-slot sampling values (`defaults`),
    every lane's FSM at fsm_init with an empty stack, every lane's adapter
    lora_id, zeroed caches with int8 scales of one; a paged cache keeps its
    table."""
    for name in FIELDS:
        getattr(state, name).zero_()
    state.max_new.fill_(max_new_tokens)
    state.fsm_lex.fill_(fsm_init)
    state.lora_ids.fill_(lora_id)
    state.rng.fill_(seed_key(seed))
    state.ctrl_k.fill_(init_k)
    state.acc_ema.fill_(0.5)
    _fill_sampling(state, seed, defaults)
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
               init_k: int = 4, defaults: Optional[dict] = None,
               logprobs_topk: int = 0, fsm_init: int = UNCONSTRAINED,
               lora_id: int = -1) -> DecodeState:
    """paged=True gives both models a PagedKVCache: n_pages pages of
    page_size rows (default batch_size * max_pages) and, unless a table is
    given, the default table that gives slot b the pages [b*m, (b+1)*m).
    Each cache keeps its own copy of a given table. kv_dtype torch.int8
    makes both caches (or pools) int8 with per-row scales; None keeps the
    models' dtype. seed: the key's seed (and the slots' keys); init_k: each
    lane's first K under the device-side adaptive controller; defaults: the
    per-slot sampling values (SAMPLING_DEFAULTS' keys); logprobs_topk: N of
    the top-N buffers (0: placeholders); fsm_init: every lane's grammar
    state (-1: unconstrained); lora_id: every lane's adapter (-1: the base
    model)."""
    B = batch_size
    kv_kw = dict(paged=paged, page_size=page_size, n_pages=n_pages, table=table, dtype=kv_dtype)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    top_shape = (B, max_seq_len, logprobs_topk) if logprobs_topk else (B, 1, 1)
    f32 = torch.float32
    state = DecodeState(
        tokens=zeros(B, max_seq_len),
        lengths=zeros(B),
        prompt_lens=zeros(B),
        max_new=torch.full((B,), max_new_tokens, dtype=torch.int32, device=device),
        active=zeros(B, dtype=torch.bool),
        target_cache=target_model.init_cache(B, max_seq_len, device, **kv_kw),
        draft_cache=(draft_model.init_cache(B, max_seq_len, device, **kv_kw)
                     if draft_model is not None else None),
        proposed=zeros(B),
        accepted=zeros(B),
        bonus=zeros(B),
        token_logprobs=zeros(B, max_seq_len, dtype=f32),
        steps=zeros(),
        rng=torch.tensor(seed_key(seed), dtype=torch.int64, device=device),
        ctrl_k=torch.full((B,), init_k, dtype=torch.int32, device=device),
        acc_ema=torch.full((B,), 0.5, dtype=f32, device=device),
        last_hidden=zeros(B, target_model.config.d_model, dtype=f32),
        prev_hidden=zeros(B, target_model.config.d_model, dtype=f32),
        temperature=zeros(B, dtype=f32),
        top_k=zeros(B),
        top_p=zeros(B, dtype=f32),
        min_p=zeros(B, dtype=f32),
        slot_rng=zeros(B, dtype=torch.int64),
        rep_penalty=zeros(B, dtype=f32),
        presence_penalty=zeros(B, dtype=f32),
        freq_penalty=zeros(B, dtype=f32),
        bias_ids=zeros(B, N_BIAS),
        bias_vals=zeros(B, N_BIAS, dtype=f32),
        top_ids=zeros(*top_shape),
        top_lps=zeros(*top_shape, dtype=f32),
        fsm_lex=torch.full((B,), fsm_init, dtype=torch.int32, device=device),
        fsm_stack=zeros(B, STACK_DEPTH),
        fsm_sp=zeros(B),
        lora_ids=torch.full((B,), lora_id, dtype=torch.int32, device=device),
    )
    _fill_sampling(state, seed, defaults)
    return state

"""Continuous batching: slot-based admission into a fixed-shape decode batch.

Port of llm_inference_lab_tpu/core/batching.py (``ContinuousBatcher``,
``make_admit_many``, ``make_admit_prefix`` and ``make_admit_incremental``).
The decode batch has a fixed shape [n_slots, max_seq_len]; a request
occupies a slot, decodes, retires and its slot is refilled from the queue:

    batcher = ContinuousBatcher(engine, n_slots=8)
    ids = [batcher.submit(p, max_new_tokens=64) for p in prompts]
    results = batcher.run()          # drain everything, ordered by req_id

Admission, routed per request as JAX's ``_execute_admissions`` routes it:

* one-shot waves (the default): one [G, P] prefill forward per model into
  a [L, G, KVH, P, D] scratch cache of the slots' KV type (int8 with its
  scales under ``kv_quantization="int8"``), spliced into the slots' cache
  lanes (contiguous) or their pages (``kv_layout="paged"``);
* incremental (``admit_chunk``): a prompt longer than the chunk prefills
  into a detached scratch one C-token forward after each decode chunk, so
  the decoding slots keep stepping; the splice at the next admission point
  is its only write to the decode state. One admission is in flight at a
  time. A rolling-buffer (``kv_ring``) engine serves only this way: its
  scratch is the ring's R slots, and a second long prompt waits for the
  one in flight;
* prefix-cached (``prefix_caching``, paged): the longest cached run of full
  prompt pages (models/paged.py ``PrefixPageCache``, capped at the prompt
  length - 2 so the suffix recomputes the head modes' hidden carry) is
  shared, and the suffix is forwarded straight into the slot's pages,
  attending to the shared ones through the slot's table row.

With pages, admission is memory-aware: a request waits until the allocator
gives its pages. Under ``kv_lazy_pages`` (the default, as in JAX) it
reserves the prompt and a growth margin; each poll grows a slot's pages
ahead of its length and, with the pool dry, preempts the youngest slot:
its pages are freed, its table row zeroed and the request requeued to
resume by recomputing prompt + generated tokens (its proposed and accepted
counts carry over into its result). With no slot left to preempt a request
is truncated. ``kv_lazy_pages=False`` reserves the worst case up front.
``cancel`` drops a queued request, deactivates a decoding one (it retires at
the next poll, ``finish_reason`` "cancelled") and unwinds an incremental
admission in flight.

The engine's step is the batcher's: vanilla, ngram, Medusa or EAGLE
drafting or tree speculation (with all but vanilla there is no draft model
and so no draft cache to fill; the head modes' hidden carry is seeded
from the admission prefill), any of the five policies, greedy decoding or
the engine's sampling, drawn from the batcher's state key (the engine's
seed), at a fixed K. Page reservations and the prompt cut leave the step's
scratch rows, the engine's ``_max_k`` + 2 (a tree's num_nodes + 3).

Per-request controls (``submit``'s keywords, under the engine's
``per_request_sampling``; JAX ``_admission_meta``): temperature, top_k,
top_p, min_p, the three penalties, ``logit_bias`` and ``seed`` go into the
slot's tensors of the decode state on every admission route (a wave, a
prefix-cached suffix, an incremental splice, a resume), so the captured
step reads them. A request's key is its seed (or one derived from the
engine's seed and its id, ``derive_request_seed``), and a row draws from
it folded with its committed length: a seeded request draws the same
tokens alone or among others, and a preempted one resumes with the draws it
would have made. Under ``logprobs_topk`` each result carries
``top_logprobs`` (a resumed request's earlier positions kept from before
its preemption). ``poll_generated`` reads every slot's tokens so far (the
server's streams and stop strings).

Grammars (``submit(..., response_format=)``, a key of the engine's grammar:
JAX ``_admission_meta``): every admission route writes the slot's FSM, the
key's initial state with an empty stack (-1 without a key), so a reused slot
starts afresh. A preempted constrained request resumes with its FSM walked
over the tokens it generated before the preemption (constrain/runtime.py
``walk_tokens`` on the host tables): JAX gives it the initial state again,
which forces a fresh value after its partial one. While a constrained
request decodes, a chunk replays the constrained step's loop (the engine's
``_fsm_steps``, captured over the same state); otherwise the unconstrained
one, whose ids and step time are those of an engine without tables.

The loop here runs POLL_EVERY steps, then reads the slots' flags and
lengths once (one [4, B] fetch), retires, grows pages, and admits. The
steps are replays of the engine's decode loop (core/specstep.py
``make_decode_loop``, a CUDA graph on the card) over the batcher's own
state, captured at construction with every lane inactive (under
per-request sampling a second loop of the plain greedy step over the same
state, which a chunk replays when every decoding request is greedy with no
penalty or bias: what the per-request step would give them, without its
counts, bias row and per-row sort); admission,
growth, preemption, cancel and retirement write that state's tensors in
place. With the engine's ``EnvFlags(sync_steps=True)`` the batcher runs the
functional step instead, one call a step.

Multi-LoRA (``submit(..., lora=name)``, an adapter of the engine's pack;
JAX ``_admission_meta``): every admission route writes the slot's
``lora_ids`` (-1 for a request without one, so a reused slot starts on the
base model) and runs the request's admission forward of the target under
its adapter; a resumed request keeps it. Prefix caching keys its pages by
adapter (models/paged.py ``root``): a page is shared only within one
adapter, where JAX's token-only hashes share them across adapters. An
unknown adapter raises at submit, with JAX's message (JAX raises it at
admission).

Left out (ROADMAP Queue 1): adaptive K (both
adaptive controllers raise here; JAX's ``record_step``), async, prefetched
and overlapped polls and admission, the chunk cost model, fused admission
in the decode graph (JAX ``Engine._get_admit_loop``) and multi-host
serving.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from llm_inference_lab_tpu_torch.constrain import runtime as fsm
from llm_inference_lab_tpu_torch.core.engine import Engine, _round_up, plain_rows, top_logprobs
from llm_inference_lab_tpu_torch.core.scheduler import Scheduler
from llm_inference_lab_tpu_torch.core.specstep import make_decode_loop
from llm_inference_lab_tpu_torch.core.state import N_BIAS, DecodeState, init_state
from llm_inference_lab_tpu_torch.models.base import Model
from llm_inference_lab_tpu_torch.models.paged import (
    PageAllocator,
    PagedKVCache,
    PrefixPageCache,
)
from llm_inference_lab_tpu_torch.ops.sampling import seed_key

POLL_EVERY = 4  # decode steps between two host reads of the slots' flags
# The per-slot controls a request may set (submit's keywords) and the state
# tensor each goes to; the f32 ones travel to the card in one row.
CONTROLS = {"temperature": "temperature", "top_k": "top_k", "top_p": "top_p",
            "min_p": "min_p", "repetition_penalty": "rep_penalty",
            "presence_penalty": "presence_penalty", "frequency_penalty": "freq_penalty"}
_F32_CONTROLS = ("temperature", "top_p", "min_p", "rep_penalty", "presence_penalty",
                 "freq_penalty")
PENALTIES = ("repetition_penalty", "presence_penalty", "frequency_penalty")


def derive_request_seed(engine_seed: int, req_id: int, explicit: Optional[int]) -> int:
    """A request's sampling seed (copy of JAX core/batching.py
    derive_request_seed): its own, clamped to 31 bits, or one derived from
    the engine's seed and its id, so a whole serving trace replays."""
    if explicit is not None:
        return explicit & 0x7FFFFFFF
    return (engine_seed * 1000003 + req_id) & 0x7FFFFFFF


@dataclass
class _Request:
    req_id: int
    prompt: str
    ids: List[int]
    max_new_tokens: int
    submitted_at: float = field(default_factory=time.perf_counter)
    slot: Optional[int] = None
    result: Optional[dict] = None
    pages: Optional[List[int]] = None  # paged KV: the pages this request owns
    reuse_len: int = 0  # prompt tokens served from the prefix cache
    cancelled: bool = False
    prefilling: bool = False  # an incremental admission in flight
    # Resume by recompute: the context to prefill at readmission (prompt +
    # the tokens generated before a preemption); None = the prompt.
    resume_ids: Optional[List[int]] = None
    admit_seq: int = -1  # admission order: preemption takes the youngest
    # Proposed and accepted drafts of the slots a preemption took from it.
    prior_proposed: int = 0
    prior_accepted: int = 0
    # Per-request controls (None: the engine's), its logit_bias and seed.
    controls: Dict[str, Any] = field(default_factory=dict)
    logit_bias: Optional[Dict[int, float]] = None
    seed: Optional[int] = None
    # The top-N alternatives of the positions generated before a preemption.
    prior_tops: List[list] = field(default_factory=list)
    # The initial FSM state of the request's grammar key (-1: unconstrained).
    fsm_init: int = fsm.UNCONSTRAINED
    # Its LoRA adapter's index in the engine's pack (-1: the base model).
    lora_id: int = -1

    @property
    def prefix_root(self):
        """The root of its prompt's chain hashes (PrefixPageCache): None for
        the base model (JAX's hashes), the adapter's key otherwise."""
        return None if self.lora_id < 0 else ("lora", self.lora_id)

    @property
    def admit_ids(self) -> List[int]:
        return self.resume_ids if self.resume_ids is not None else self.ids

    @property
    def remaining_new(self) -> int:
        """The generation budget left (it shrinks across preemptions)."""
        return max(self.max_new_tokens - (len(self.admit_ids) - len(self.ids)), 1)


@dataclass
class BatcherStats:
    """Counters of the serving loop, read by ``report``."""

    admitted: int = 0  # admissions done (a wave's requests, a splice, a prefix admission)
    retired: int = 0  # requests retired
    steps: int = 0  # decode steps run
    admit_waves: int = 0  # [G, P] admission prefills
    committed_tokens: int = 0  # generated tokens of retired requests
    occupied_slot_steps: int = 0  # sum over steps of occupied slots
    # Steps run on the plain greedy step: every decoding request greedy and
    # unpenalized under per-request sampling (Engine._plain).
    plain_steps: int = 0
    # Steps run on the constrained step: a constrained request decoding.
    constrained_steps: int = 0
    page_grows: int = 0  # lazy page growths (table rows extended)
    preemptions: int = 0  # slots preempted on a dry pool
    # Wall time of admission work: waves, prefix admissions, incremental
    # chunks and splices (the card synchronized before and after each).
    admit_ms: float = 0.0
    wall_s: float = 0.0  # time inside run()

    def report(self) -> Dict[str, Any]:
        return {
            "admitted": self.admitted,
            "retired": self.retired,
            "steps": self.steps,
            "plain_steps": self.plain_steps,
            "constrained_steps": self.constrained_steps,
            "admit_waves": self.admit_waves,
            "committed_tokens": self.committed_tokens,
            "page_grows": self.page_grows,
            "preemptions": self.preemptions,
            "admit_ms": self.admit_ms,
            "wall_s": self.wall_s,
            "tok_s": self.committed_tokens / self.wall_s if self.wall_s else 0.0,
            "mean_occupied_slots": (self.occupied_slot_steps / self.steps
                                    if self.steps else 0.0),
        }


def _token_logprobs(lg: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """log p(nxt) under the logits lg [.., V]: gather minus logsumexp, f32."""
    lg32 = lg.float()
    return lg32.gather(-1, nxt[..., None].long())[..., 0] - torch.logsumexp(lg32, dim=-1)


def _fill_slots(state: DecodeState, slots: torch.Tensor, token_rows: torch.Tensor,
                lp_rows: torch.Tensor, prompt_lens: torch.Tensor, max_news: torch.Tensor,
                h_last: Optional[torch.Tensor], controls: tuple) -> None:
    """What every admission writes into its slots' lanes of the decode
    state, in place: tokens and logprob lanes [G, max_len], lengths, budget,
    active flag, zeroed counters, (head modes) the hidden carry and the
    requests' controls (ContinuousBatcher._controls: f32 [G, 6 + N_BIAS],
    int32 [G, 1 + N_BIAS], keys int64 [G], the FSM: lex [G], stack
    [G, STACK_DEPTH], sp [G] int32, and the LoRA ids [G] int32)."""
    f32, i32, keys, fsm_lex, fsm_stack, fsm_sp, lora = controls
    state.lora_ids[slots] = lora
    state.fsm_lex[slots] = fsm_lex
    state.fsm_stack[slots] = fsm_stack
    state.fsm_sp[slots] = fsm_sp
    for j, name in enumerate(_F32_CONTROLS):
        getattr(state, name)[slots] = f32[:, j]
    state.bias_vals[slots] = f32[:, len(_F32_CONTROLS):]
    state.top_k[slots] = i32[:, 0]
    state.bias_ids[slots] = i32[:, 1:]
    state.slot_rng[slots] = keys
    state.tokens[slots] = token_rows
    state.token_logprobs[slots] = lp_rows
    state.lengths[slots] = prompt_lens
    state.prompt_lens[slots] = prompt_lens
    state.max_new[slots] = max_news
    state.active[slots] = prompt_lens > 0
    for counter in (state.proposed, state.accepted, state.bonus):
        counter[slots] = 0
    if h_last is not None:
        state.last_hidden[slots] = h_last
        state.prev_hidden[slots] = h_last


def _splice(cache, sub, slots: torch.Tensor, table_rows: Optional[torch.Tensor]) -> None:
    """Copy scratch caches [L, G, KVH, T, D] (int8 scales with them) into
    the slots: contiguous caches take lanes [0, T) of the slots (rows past
    T keep stale data, which the position mask hides until decode
    overwrites them); paged caches take scratch page j of row g into page
    table_rows[g, j] and set the slots' table rows. A request whose own
    allocation is shorter than the scratch sends the excess into page 0,
    the dummy page no allocation owns."""
    G, T = sub.k.shape[1], sub.k.shape[3]
    pairs = [(sub.k, cache.k), (sub.v, cache.v)]
    if cache.k_scale is not None:  # int8: the scale rows travel with the values
        pairs += [(sub.k_scale, cache.k_scale), (sub.v_scale, cache.v_scale)]
    if isinstance(cache, PagedKVCache):
        pg = cache.page_size
        J = T // pg
        pids = torch.zeros((G, J), dtype=torch.long, device=sub.k.device)
        n = min(J, table_rows.shape[1])
        pids[:, :n] = table_rows[:, :n].long()
        for src, dst in pairs:
            # [L, G, KVH, J*pg(, D)] -> [L, G, J, KVH, pg(, D)], page-major
            L, _, KVH = src.shape[:3]
            dst[:, pids] = src.reshape(L, G, KVH, J, pg, *src.shape[4:]).transpose(2, 3)
        cache.table[slots] = table_rows
    else:
        n = min(T, cache.k.shape[3])
        for src, dst in pairs:
            dst[:, slots, :, :n] = src[:, :, :, :n]


def make_admit_many(target_model: Model, draft_model: Optional[Model], hidden: bool = False):
    """G-slot admission: ONE [G, P] prefill forward per model into a
    [L, G, KVH, P, D] scratch cache, then a splice into the G slots. The
    scratch has the slots' KV dtype, so an int8 cache's admitted rows are
    quantized per row from the same forward rows as Engine.generate's, and
    the splice carries their scales with them.

    admit(state, rows [G, P], prompt_lens [G], slots [G], max_news [G],
          table_rows [G, M] or None, controls) -> state, all int32 on the
    device (controls: _fill_slots').

    The prompt logprobs of each prompt token come from the prefill logits.
    hidden (the head modes): the target's hidden row that predicted each
    prompt's last token (index prompt_len - 2, clamped at 0) seeds the
    slot's last_hidden and prev_hidden. The state's tensors are written in
    place."""

    def admit(state: DecodeState, rows: torch.Tensor, prompt_lens: torch.Tensor,
              slots: torch.Tensor, max_news: torch.Tensor,
              table_rows: Optional[torch.Tensor], controls: tuple) -> DecodeState:
        G, P = rows.shape
        dev = rows.device
        positions = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(G, 1)
        zeros = torch.zeros((G,), dtype=torch.int32, device=dev)
        slots_l = slots.long()

        def prefill(model: Model, cache, want_hidden=False, lora_ids=None):
            scratch = model.init_cache(G, P, dev, dtype=cache.k.dtype)
            out = model.forward(rows, positions, scratch, zeros, return_hidden=want_hidden,
                                lora_ids=lora_ids)
            _splice(cache, scratch, slots_l, table_rows)
            return out[0], out[2] if want_hidden else None

        lg, hid = prefill(target_model, state.target_cache, hidden, controls[-1])
        if draft_model is not None:
            prefill(draft_model, state.draft_cache)
        # Prompt logprobs: row i of the logits scores prompt token i+1;
        # position 0 has no conditional, padding rows are 0.
        row_lp = _token_logprobs(lg[:, :-1], rows[:, 1:])
        row_lp = torch.where(positions[:, 1:] < prompt_lens[:, None], row_lp, 0.0)
        max_len = state.tokens.shape[1]
        lp_lanes = torch.zeros((G, max_len), dtype=torch.float32, device=dev)
        lp_lanes[:, 1:P] = row_lp
        token_rows = torch.zeros((G, max_len), dtype=torch.int32, device=dev)
        token_rows[:, :P] = rows
        h_last = None
        if hidden:
            h_idx = (prompt_lens - 2).clamp_min(0).long()
            h_last = hid[torch.arange(G, device=dev), h_idx].float()
        _fill_slots(state, slots_l, token_rows, lp_lanes, prompt_lens, max_news, h_last,
                    controls)
        return state

    return admit


def make_admit_prefix(target_model: Model, draft_model: Optional[Model], hidden: bool = False):
    """One-slot admission for paged caches with prefix caching: the prompt
    SUFFIX (from reuse_len, a whole number of pages) is forwarded straight
    into the slot's pages, attending to the reused prefix pages through the
    slot's table row (models/transformer.py's paged path: a suffix of more
    than 32 rows gathers the row's pages and runs kernel E with queries
    from reuse_len; a shorter one runs F). No scratch, no splice; the
    reused pages are never written. reuse_len 0 is a plain paged admission.

    admit(state, full_row [1, P], suffix_row [1, S], prompt_len, reuse_len,
          slot, max_new, table_row [M], controls) -> state (ints on the host, rows
    int32 on the device). Prompt logprobs exist for the forwarded suffix
    only (the lane holds 0 at the reused positions); the head modes' carry
    is the hidden row at prompt_len - 2, inside the suffix by the cap."""

    def admit(state: DecodeState, full_row: torch.Tensor, suffix_row: torch.Tensor,
              prompt_len: int, reuse_len: int, slot: int, max_new: int,
              table_row: torch.Tensor, controls: tuple) -> DecodeState:
        S = suffix_row.shape[1]
        dev = suffix_row.device
        positions = reuse_len + torch.arange(S, dtype=torch.int32, device=dev)[None]
        start = torch.full((1,), reuse_len, dtype=torch.int32, device=dev)

        def run(model: Model, cache, want_hidden=False, lora_ids=None):
            view = PagedKVCache(k=cache.k, v=cache.v, table=table_row[None],
                                k_scale=cache.k_scale, v_scale=cache.v_scale)
            out = model.forward(suffix_row, positions, view, start, return_hidden=want_hidden,
                                lora_ids=lora_ids)
            cache.table[slot] = table_row
            return out

        out = run(target_model, state.target_cache, hidden, controls[-1])
        if draft_model is not None:
            run(draft_model, state.draft_cache)
        # Suffix row j (position reuse_len + j) scores the prompt token at
        # reuse_len + j + 1.
        max_len = state.tokens.shape[1]
        gpos = positions[0].long() + 1
        nxt = full_row[0, gpos.clamp(0, full_row.shape[1] - 1)]
        row_lp = torch.where(gpos < prompt_len, _token_logprobs(out[0][0], nxt), 0.0)
        lp_lane = torch.zeros((1, max_len), dtype=torch.float32, device=dev)
        keep = gpos < max_len
        lp_lane[0, gpos[keep]] = row_lp[keep]
        lp_lane[0, 0] = 0.0
        token_row = torch.zeros((1, max_len), dtype=torch.int32, device=dev)
        n = min(full_row.shape[1], max_len)
        token_row[:, :n] = full_row[:, :n]
        h_last = None
        if hidden:
            h_last = out[2][0, min(max(prompt_len - 2 - reuse_len, 0), S - 1)].float()[None]
        ints = torch.tensor([[slot, prompt_len, max_new]], dtype=torch.int32, device=dev)
        _fill_slots(state, ints[:, 0].long(), token_row, lp_lane, ints[:, 1], ints[:, 2], h_last,
                    controls)
        return state

    return admit


def make_admit_incremental(target_model: Model, draft_model: Optional[Model], chunk: int,
                           hidden: bool = False):
    """Interleaved (chunked) admission: a long prompt prefills into a
    DETACHED scratch cache `chunk` tokens a call, between decode chunks, and
    only the final splice touches the decode state. The slot stays inactive
    until then, so the decode steps in between are untouched (an inactive
    lane's junk writes land in its own lane, or through its zeroed table
    row in the dummy page 0).

    Returns (chunk_fn, splice_fn):
      chunk_fn(st, sd, lpbuf [1, max_len], h_carry [1, D], tok [1, C],
               nxt [1, C], off, plen, lora [1]) -> h_carry: one C-token
        forward of each model into its scratch at offset off (positions
        off .. off + C - 1, in place; the target's under the request's
        LoRA id), the prompt logprobs of the chunk's rows written into
        lpbuf, and (hidden) the carry replaced by the hidden row at
        plen - 2 when the chunk holds it;
      splice_fn(state, st, sd, lp_row, h_carry, prompt_row [1, P],
                prompt_len, slot, max_new, table_row [M] or None, controls)
        -> state."""
    C = chunk

    def chunk_fn(st, sd, lpbuf: torch.Tensor, h_carry: torch.Tensor, tok: torch.Tensor,
                 nxt: torch.Tensor, off: int, plen: int, lora: torch.Tensor) -> torch.Tensor:
        dev = tok.device
        positions = off + torch.arange(C, dtype=torch.int32, device=dev)[None]
        start = torch.full((1,), off, dtype=torch.int32, device=dev)
        out = target_model.forward(tok, positions, st, start, return_hidden=hidden,
                                   lora_ids=lora)
        if draft_model is not None:
            draft_model.forward(tok, positions, sd, start)
        row_lp = torch.where(positions[0] + 1 < plen, _token_logprobs(out[0][0], nxt[0]), 0.0)
        n = min(C, lpbuf.shape[1] - off - 1)
        lpbuf[0, off + 1: off + 1 + n] = row_lp[:n]
        local = plen - 2 - off
        if hidden and 0 <= local < C:
            h_carry = out[2][0, local].float()[None]
        return h_carry

    def splice_fn(state: DecodeState, st, sd, lp_row: torch.Tensor, h_carry: torch.Tensor,
                  prompt_row: torch.Tensor, prompt_len: int, slot: int, max_new: int,
                  table_row: Optional[torch.Tensor], controls: tuple) -> DecodeState:
        dev = prompt_row.device
        ints = torch.tensor([[slot, prompt_len, max_new]], dtype=torch.int32, device=dev)
        slots = ints[:, 0].long()
        table_rows = table_row[None] if table_row is not None else None
        _splice(state.target_cache, st, slots, table_rows)
        if sd is not None:
            _splice(state.draft_cache, sd, slots, table_rows)
        max_len = state.tokens.shape[1]
        token_row = torch.zeros((1, max_len), dtype=torch.int32, device=dev)
        n = min(prompt_row.shape[1], max_len)
        token_row[:, :n] = prompt_row[:, :n]
        _fill_slots(state, slots, token_row, lp_row, ints[:, 1], ints[:, 2],
                    h_carry if hidden else None, controls)
        return state

    return chunk_fn, splice_fn


class ContinuousBatcher:
    """Drives an Engine's step over a fixed slot batch with rolling
    admission and retirement, on the engine's device."""

    def __init__(self, engine: Engine, n_slots: int = 8):
        cfg = engine.config
        if cfg.controller != "fixed":
            raise NotImplementedError(
                f"the {cfg.controller!r} controller in the batcher (a per-slot K "
                "reset at admission) is not ported yet; use controller='fixed'")
        self.paged = cfg.kv_layout == "paged"
        if cfg.prefix_caching and not self.paged:
            raise ValueError("prefix_caching requires kv_layout='paged'")
        self.prefix_caching = self.paged and cfg.prefix_caching
        self.ring = any(m is not None and m.config.kv_ring_len is not None
                        for m in (engine.target, engine.draft))
        # Incremental admission: not under prefix caching (JAX's rule).
        self.admit_chunk = cfg.admit_chunk if cfg.admit_chunk and not self.prefix_caching else None
        if self.admit_chunk is not None:
            bucket = cfg.kv_page_size if self.paged else 32
            if self.admit_chunk % bucket:
                raise ValueError(f"admit_chunk ({self.admit_chunk}) must be a multiple of "
                                 f"the KV bucket ({bucket})")
        if self.ring and self.admit_chunk is None:
            # A one-shot prefill of a prompt longer than the ring would wrap
            # it over rows its own queries still need.
            raise ValueError("serving over a rolling-buffer cache (kv_ring) needs admit_chunk "
                             "(incremental admission); set e.g. admit_chunk=512")
        self.engine = engine
        self.n_slots = n_slots
        self.max_seq_len = cfg.max_seq_len
        self.scheduler = Scheduler()
        self._requests: Dict[int, _Request] = {}
        self._slots: List[Optional[_Request]] = [None] * n_slots
        self._done: Dict[int, _Request] = {}
        self._next_id = 0
        hidden = engine.head_mode
        self._admit_many = make_admit_many(engine.target, engine.draft, hidden)
        self._admit_prefix = (make_admit_prefix(engine.target, engine.draft, hidden)
                              if self.prefix_caching else None)
        self._admit_incr = (make_admit_incremental(engine.target, engine.draft,
                                                   self.admit_chunk, hidden)
                            if self.admit_chunk is not None else None)
        self._prefilling: Optional[dict] = None  # the incremental admission in flight
        self._tokens: Optional[np.ndarray] = None  # the token buffer read at this poll
        self.stats = BatcherStats()
        paged_kw = {}
        self.allocator: Optional[PageAllocator] = None
        self.lazy_pages = False
        if self.paged:
            P = cfg.kv_page_size
            self._pages_per_seq = (self.max_seq_len + P - 1) // P
            n_pages = cfg.kv_pages or (n_slots * self._pages_per_seq + 1)
            self.allocator = (PrefixPageCache if self.prefix_caching else PageAllocator)(
                n_pages, P)
            paged_kw = dict(paged=True, page_size=P, n_pages=n_pages,
                            table=torch.zeros((n_slots, self._pages_per_seq), dtype=torch.int32))
            # Growth runs at each poll from the lengths it reads: the margin
            # covers two chunks of POLL_EVERY steps at the commit bound and
            # the step's K + 2 scratch rows (JAX's margin, whose poll lags a
            # chunk; here the poll is current, so chunks of up to
            # 2 * POLL_EVERY steps stay inside it).
            self.lazy_pages = cfg.kv_lazy_pages
            self._commit_bound = engine._max_k + 1 if engine.is_spec else 1
            self._grow_margin = 2 * POLL_EVERY * self._commit_bound + engine._max_k + 2
            self._admit_seq = 0
        with torch.inference_mode():
            self.state = init_state(engine.target, engine.draft, n_slots, self.max_seq_len,
                                    engine.device, max_new_tokens=cfg.max_new_tokens,
                                    kv_dtype=engine.kv_dtype, seed=cfg.seed,
                                    init_k=engine.controller.k,
                                    defaults=engine.sampling_defaults(),
                                    logprobs_topk=cfg.logprobs_topk, **paged_kw)
            self._loop = self._plain_loop = self._fsm_loop = None
            if not engine.flags.sync_steps:
                self._loop = make_decode_loop(engine._step_in_place, pool=engine.graph_pool)
                self._loop.bind(self.state)
                if engine._plain is not None:  # the same state, the engine's pool
                    self._plain_loop = make_decode_loop(engine._plain[1],
                                                        pool=engine.graph_pool)
                    self._plain_loop.bind(self.state)
                if engine._fsm_steps is not None:
                    self._fsm_loop = make_decode_loop(engine._fsm_steps[1],
                                                      pool=engine.graph_pool)
                    self._fsm_loop.bind(self.state)

    def check_request(self, *, logit_bias: Optional[Dict[int, float]] = None,
                      seed: Optional[int] = None, response_format: Optional[str] = None,
                      lora: Optional[str] = None, **controls: Any) -> None:
        """Refuse what this batcher cannot serve as asked, before anything is
        queued (host only: the server's handler threads call it): a grammar
        key the engine's grammar cannot serve (``response_format``; ValueError
        with JAX's message, from Engine._resolve_fsm_initial), a LoRA adapter
        the engine does not have (``lora``; ValueError, JAX's message);
        per-request controls, a logit_bias or a seed on an engine without
        ``per_request_sampling`` (its step reads the engine's values);
        penalties in tree mode; more logit_bias pairs than a slot holds
        (N_BIAS) or an id outside the vocabulary. Raises ValueError or
        NotImplementedError, naming what."""
        if response_format is not None:
            self.engine._resolve_fsm_initial(response_format)
        self.engine.lora_id(lora)
        unknown = set(controls) - set(CONTROLS)
        if unknown:
            raise TypeError(f"unknown request controls {sorted(unknown)}")
        given = sorted(k for k, v in controls.items() if v is not None)
        given += [k for k, v in (("logit_bias", logit_bias), ("seed", seed)) if v is not None]
        cfg = self.engine.config
        if given and not cfg.per_request_sampling:
            raise ValueError(f"per-request {', '.join(given)} need an engine with "
                             "EngineConfig(per_request_sampling=True)")
        if self.engine.tree is not None:
            off = {"repetition_penalty": 1.0, "presence_penalty": 0.0, "frequency_penalty": 0.0}
            if any(controls.get(k) is not None and controls[k] != off[k] for k in PENALTIES):
                raise ValueError("repetition/presence/frequency penalties are not supported in "
                                 "tree mode")
        if logit_bias:
            if len(logit_bias) > N_BIAS:
                raise ValueError(f"logit_bias holds at most {N_BIAS} tokens, got "
                                 f"{len(logit_bias)}")
            vocab = self.engine.target.config.vocab_size
            bad = [t for t in logit_bias if not 0 <= int(t) < vocab]
            if bad:
                raise ValueError(f"logit_bias ids outside the vocabulary [0, {vocab}): {bad}")

    def submit(self, prompt: str, max_new_tokens: Optional[int] = None, *,
               logit_bias: Optional[Dict[int, float]] = None, seed: Optional[int] = None,
               response_format: Optional[str] = None, lora: Optional[str] = None,
               **controls: Any) -> int:
        """Queue a prompt; returns its req_id. controls: temperature, top_k,
        top_p, min_p, repetition_penalty, presence_penalty and
        frequency_penalty of this request (None: the engine's); logit_bias
        {token id: bias}; seed; response_format, a grammar key of the
        engine's (None: unconstrained, whatever the engine's default); lora,
        an adapter of the engine's pack (None: the base model); JAX's submit
        keywords. What check_request refuses raises here."""
        self.check_request(logit_bias=logit_bias, seed=seed, response_format=response_format,
                           lora=lora, **controls)
        max_new = max_new_tokens or self.engine.config.max_new_tokens
        ids = self.engine.encode(prompt, max_new, self.max_seq_len)
        req = _Request(self._next_id, prompt, ids, max_new,
                       controls={k: v for k, v in controls.items() if v is not None},
                       logit_bias=dict(logit_bias) if logit_bias else None, seed=seed,
                       fsm_init=(self.engine._resolve_fsm_initial(response_format)
                                 if response_format is not None else fsm.UNCONSTRAINED),
                       lora_id=self.engine.lora_id(lora))
        self._next_id += 1
        self._requests[req.req_id] = req
        self.scheduler.submit(req.req_id, len(ids), max_new)
        return req.req_id

    @torch.inference_mode()
    def cancel(self, req_id: int) -> bool:
        """End a request early. A queued one is dropped at admission; a
        decoding one is deactivated on the device and retires at the next
        poll with the tokens it has (finish_reason "cancelled"); an
        incremental admission in flight unwinds, pages included."""
        req = self._requests.get(req_id)
        if req is not None and req.slot is None:
            req.cancelled = True
            return True
        for slot, r in enumerate(self._slots):
            if r is not None and r.req_id == req_id:
                r.cancelled = True
                self.state.active[slot] = False
                return True
        return False

    def _controls(self, reqs: List[_Request]) -> tuple:
        """The requests' controls for _fill_slots, on the device (JAX
        _admission_meta): f32 [G, 6 + N_BIAS] (temperature, top_p, min_p,
        the penalties, the bias values), int32 [G, 1 + N_BIAS] (top_k, the
        bias ids, -1 empty), int64 [G] keys, the key of each request's
        seed (derive_request_seed), each request's FSM (_fsm_of) and int32
        [G] its LoRA id."""
        G = len(reqs)
        f32 = np.zeros((G, len(_F32_CONTROLS) + N_BIAS), np.float32)
        i32 = np.full((G, 1 + N_BIAS), -1, np.int32)
        keys = np.zeros((G,), np.int64)
        fsm_lex, fsm_stack, fsm_sp = fsm.init_fsm(G)
        for g, req in enumerate(reqs):
            fsm_lex[g], fsm_stack[g], fsm_sp[g] = self._fsm_of(req)
            vals = self._values(req)
            f32[g, :len(_F32_CONTROLS)] = [vals[name] for name in _F32_CONTROLS]
            i32[g, 0] = vals["top_k"]
            for j, (tid, bias) in enumerate((req.logit_bias or {}).items()):
                i32[g, 1 + j] = int(tid)
                f32[g, len(_F32_CONTROLS) + j] = float(bias)
            keys[g] = seed_key(derive_request_seed(self.engine.config.seed, req.req_id,
                                                   req.seed))
        lora = np.array([req.lora_id for req in reqs], np.int32)
        dev = self.engine.device
        return tuple(torch.from_numpy(a).to(dev)
                     for a in (f32, i32, keys, fsm_lex, fsm_stack, fsm_sp, lora))

    def _fsm_of(self, req: _Request) -> tuple:
        """A request's FSM at admission: unconstrained, or its key's initial
        state with an empty stack, or for a request resumed after a
        preemption that state walked over the tokens it generated before
        (the context it resumes with ends with them)."""
        if req.fsm_init == fsm.UNCONSTRAINED:
            return fsm.UNCONSTRAINED, 0, 0
        return fsm.walk_tokens(self.engine.constrain_tables, req.fsm_init,
                               req.admit_ids[len(req.ids):])

    def _values(self, req: _Request) -> Dict[str, float]:
        """A request's sampling values by state field: its own, else the
        engine's."""
        vals = self.engine.sampling_defaults()
        vals.update({CONTROLS[k]: v for k, v in req.controls.items()})
        return vals

    def _plain_request(self, req: _Request) -> bool:
        """A request the plain greedy step serves exactly (Engine._plain):
        greedy, no penalty, no logit_bias."""
        return plain_rows(self._values(req)) and not req.logit_bias

    def _finish_cancelled(self, req: _Request) -> None:
        req.result = {
            "req_id": req.req_id, "text": "", "generated_ids": [], "token_logprobs": [],
            "prompt_logprobs": None, "top_logprobs": None, "generated_tokens": 0,
            "proposed": 0, "accepted": 0,
            "acceptance_rate": 0.0, "prompt_tokens_reused": 0,
            "latency_ms": (time.perf_counter() - req.submitted_at) * 1e3,
            "slot": None, "finish_reason": "cancelled",
        }
        self._done[req.req_id] = req

    # ------------------------------------------------------------------
    def _requeue(self, req: _Request) -> None:
        req.slot = None
        self._requests[req.req_id] = req
        self.scheduler.submit(req.req_id, len(req.admit_ids), req.remaining_new)

    def _next_request(self) -> Optional[_Request]:
        """The next request the scheduler admits, dropping the cancelled ones."""
        while self.scheduler.pending():
            got = self.scheduler.admit(1)
            if not got:
                return None
            req = self._requests[got[0]]
            if not req.cancelled:
                return req
            self._finish_cancelled(self._requests.pop(req.req_id))
        return None

    def _plan_admissions(self) -> List[_Request]:
        """Host-side admission decisions (queue order, slots, pages): pops
        the chosen requests and sets req.slot / req.pages / req.reuse_len."""
        eng = self.engine
        free = [s for s in range(self.n_slots) if self._slots[s] is None]
        plans: List[_Request] = []
        if not free or not self.scheduler.pending():
            return plans
        if not self.paged:
            slots = iter(free)
            for rid in self.scheduler.admit(len(free)):
                req = self._requests.pop(rid)
                if req.cancelled:
                    self._finish_cancelled(req)
                    continue
                req.slot = next(slots)
                plans.append(req)
            return plans
        # Paged: memory-aware admission, one at a time. A request whose pages
        # the pool cannot give goes back to the queue and admission stops
        # (the scheduler's overdue rule keeps it from starving).
        for slot in free:
            req = self._next_request()
            if req is None:
                break
            ids = req.admit_ids
            shared: List[int] = []
            reuse_len = 0
            if self.prefix_caching:
                shared, reuse_len = self.allocator.match(ids, len(ids) - 2, req.prefix_root)
            cap_tok = len(ids) + req.remaining_new + eng._max_k + 2
            need_tok = min(len(ids) + self._grow_margin, cap_tok) if self.lazy_pages else cap_tok
            pages = self.allocator.alloc(self.allocator.pages_needed(need_tok) - len(shared))
            if pages is None:
                if shared:  # give back the refcounts match() took
                    self.allocator.free(shared)
                self._requeue(req)
                break
            req.pages = shared + pages
            req.reuse_len = reuse_len
            req.slot = slot
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self._requests.pop(req.req_id)
            plans.append(req)
        return plans

    def _has_admission_work(self) -> bool:
        pf = self._prefilling
        return ((pf is not None and pf["ready"])
                or (bool(self.scheduler.pending()) and any(r is None for r in self._slots)))

    @torch.inference_mode()
    def _admit_pending(self) -> None:
        """The admission point: splice a finished incremental admission, then
        admit what the free slots and pages allow."""
        if not self._has_admission_work():
            return
        self.engine._sync()
        t0 = time.perf_counter()
        self._finish_admission()
        self._execute_admissions()
        self.engine._sync()
        self.stats.admit_ms += (time.perf_counter() - t0) * 1e3

    def _execute_admissions(self) -> None:
        """Plan, then admit: prefix-cached and incremental admissions one
        slot at a time, the rest sorted by length in power-of-two groups,
        one [G, P] prefill each."""
        group: List[_Request] = []
        for req in self._plan_admissions():
            if self.prefix_caching or self._incremental(req):
                self._admit_one(req)
            else:
                group.append(req)
        group.sort(key=lambda r: len(r.admit_ids))
        while group:
            n = 1
            while n * 2 <= len(group):
                n *= 2
            self._admit_group(group[:n])
            group = group[n:]

    def _incremental(self, req: _Request) -> bool:
        return self.admit_chunk is not None and len(req.admit_ids) > self.admit_chunk

    def _table_row(self, req: _Request) -> np.ndarray:
        row = np.zeros((self._pages_per_seq,), np.int32)
        row[: len(req.pages)] = req.pages
        return row

    def _admit_one(self, req: _Request) -> None:
        """An incremental or prefix-cached admission. A long prompt starts an
        incremental admission, or, with one already in flight, is admitted
        one-shot (a ring engine's waits in the queue instead: its one-shot
        forward would wrap the ring)."""
        ids = req.admit_ids
        if self._incremental(req):
            if self._prefilling is None:
                self._begin_incremental(req)
                return
            if self.ring:
                self._requeue(req)
                return
        bucket = self.engine.config.kv_page_size if self.paged else 32
        P = _round_up(max(len(ids), 1), bucket)
        if self._admit_prefix is None:
            self._admit_group([req], P=P)
            return
        dev = self.engine.device
        suffix = ids[req.reuse_len:]
        full = np.zeros((1, P), np.int32)
        full[0, : len(ids)] = ids
        rows = torch.from_numpy(full).to(dev)
        S = _round_up(max(len(suffix), 1), bucket)
        self.state = self._admit_prefix(
            self.state, rows, rows[:, req.reuse_len: req.reuse_len + S], len(ids),
            req.reuse_len, req.slot, req.remaining_new,
            torch.from_numpy(self._table_row(req)).to(dev), self._controls([req]))
        self._slots[req.slot] = req
        self.stats.admitted += 1
        # Publish this request's own full prompt chunks for reuse.
        self.allocator.register(ids, req.pages, req.reuse_len, req.prefix_root)

    def _admit_group(self, reqs: List[_Request], P: Optional[int] = None) -> None:
        """One admission wave. P is the page size (paged) or 32
        (contiguous), doubled until it holds the longest prompt, so the
        prefill shapes stay few. A long prompt admitted one-shot beside an
        incremental admission passes its own bucket-rounded P (JAX's
        one-slot ``make_admit``) and counts as no wave."""
        dev = self.engine.device
        G = len(reqs)
        if P is None:
            bucket = self.engine.config.kv_page_size if self.paged else 32
            need = max(_round_up(max(len(r.admit_ids), 1), bucket) for r in reqs)
            lane = self.state.tokens.shape[1]
            P = bucket
            while P < need:
                P *= 2
            if P > lane:
                P = need
            self.stats.admit_waves += 1
        rows = np.zeros((G, P), np.int32)
        meta = np.zeros((3, G), np.int32)  # prompt_lens, slots, max_news
        table_rows = np.zeros((G, self._pages_per_seq if self.paged else 1), np.int32)
        for i, req in enumerate(reqs):
            ids = req.admit_ids
            rows[i, : len(ids)] = ids
            meta[:, i] = (len(ids), req.slot, req.remaining_new)
            if self.paged:
                table_rows[i] = self._table_row(req)
        plens, slots, max_news = torch.from_numpy(meta).to(dev)
        self.state = self._admit_many(
            self.state, torch.from_numpy(rows).to(dev), plens, slots, max_news,
            torch.from_numpy(table_rows).to(dev) if self.paged else None, self._controls(reqs))
        for req in reqs:
            self._slots[req.slot] = req
            self.stats.admitted += 1

    # -------------------------------------------------- incremental admission
    def _begin_incremental(self, req: _Request) -> None:
        """Allocate the detached scratch caches and park the request in its
        slot; _advance_admission runs one C-token chunk after each decode
        chunk until the splice. The slot's lane (or zeroed table row) stays
        as a retired slot's until then."""
        eng = self.engine
        dev = eng.device
        ids = req.admit_ids
        C = self.admit_chunk
        P = _round_up(max(len(ids), 1), C)
        row = np.zeros((1, P), np.int32)
        row[0, : len(ids)] = ids

        def scratch(model: Optional[Model], cache):
            if model is None:
                return None
            # A ring model writes at position mod R: its scratch is the
            # ring itself (init_cache holds a ring model to R slots).
            T = cache.k.shape[-2] if self.ring else P
            return model.init_cache(1, T, dev, dtype=cache.k.dtype)

        self._prefilling = {
            "req": req, "slot": req.slot, "off": 0, "P": P, "ready": False,
            "row": row, "row_dev": torch.from_numpy(row).to(dev),
            "table_row": (torch.from_numpy(self._table_row(req)).to(dev) if self.paged
                          else None),
            "st": scratch(eng.target, self.state.target_cache),
            "sd": scratch(eng.draft, self.state.draft_cache),
            "lp": torch.zeros((1, self.state.tokens.shape[1]), dtype=torch.float32, device=dev),
            "h": torch.zeros((1, eng.target.config.d_model), dtype=torch.float32, device=dev),
            "lora": torch.full((1,), req.lora_id, dtype=torch.int32, device=dev),
        }
        req.prefilling = True
        self._slots[req.slot] = req

    def _advance_admission(self) -> None:
        """One C-token prefill chunk of the admission in flight (none: a
        no-op). The splice waits for the next admission point."""
        pf = self._prefilling
        if pf is None or pf["ready"]:
            return
        req = pf["req"]
        if req.cancelled:
            self._abort_incremental(req)
            return
        self.engine._sync()
        t0 = time.perf_counter()
        C = self.admit_chunk
        off, P, row = pf["off"], pf["P"], pf["row"]
        nxt = np.zeros((1, C), np.int32)
        nxt[0, : C - 1] = row[0, off + 1: off + C]
        if off + C < P:
            nxt[0, C - 1] = row[0, off + C]
        chunk_fn, _ = self._admit_incr
        pf["h"] = chunk_fn(pf["st"], pf["sd"], pf["lp"], pf["h"], pf["row_dev"][:, off: off + C],
                           torch.from_numpy(nxt).to(self.engine.device), off,
                           len(req.admit_ids), pf["lora"])
        pf["off"] = off + C
        pf["ready"] = pf["off"] >= P
        self.engine._sync()
        self.stats.admit_ms += (time.perf_counter() - t0) * 1e3

    def _finish_admission(self) -> None:
        pf = self._prefilling
        if pf is None or not pf["ready"]:
            return
        req = pf["req"]
        if req.cancelled:
            self._abort_incremental(req)
            return
        _, splice_fn = self._admit_incr
        self.state = splice_fn(self.state, pf["st"], pf["sd"], pf["lp"], pf["h"], pf["row_dev"],
                               len(req.admit_ids), pf["slot"], req.remaining_new,
                               pf["table_row"], self._controls([req]))
        req.prefilling = False
        self._prefilling = None
        self.stats.admitted += 1

    def _abort_incremental(self, req: _Request) -> None:
        """Drop a cancelled admission in flight: nothing reached the decode
        state, so only the slot and the pages unwind."""
        pf = self._prefilling
        self._prefilling = None
        self._slots[pf["slot"]] = None
        req.prefilling = False
        if self.paged and req.pages:
            self.allocator.free(req.pages)
            req.pages = None
        self._finish_cancelled(req)

    # ------------------------------------------------------------- decoding
    @torch.inference_mode()
    def step_chunk(self, n: int = POLL_EVERY) -> None:
        """n decode steps over all slots (none when no slot decodes), one
        chunk of an incremental admission in flight, then one host read of
        the flags, which retires the requests that finished and grows or
        preempts pages. Under lazy pages n is at most 2 * POLL_EVERY: a
        longer chunk could write past the pages the growth margin keeps
        ahead (it raises)."""
        if self.lazy_pages and n * self._commit_bound + self.engine._max_k + 2 > self._grow_margin:
            raise ValueError(f"a chunk of {n} steps can outrun the lazy page margin "
                             f"({self._grow_margin} tokens); take at most {2 * POLL_EVERY}")
        decoding = [r for r in self._slots if r is not None and not r.prefilling]
        occupied = len(decoding)
        if occupied:
            # A constrained request decoding: the constrained step for all.
            constrained = any(r.fsm_init != fsm.UNCONSTRAINED for r in decoding)
            plain = (not constrained and self.engine._plain is not None
                     and all(map(self._plain_request, decoding)))
            self.stats.plain_steps += n if plain else 0
            self.stats.constrained_steps += n if constrained else 0
            if self._loop is None:
                step = (self.engine._fsm_steps[0] if constrained
                        else self.engine._plain[0] if plain else self.engine._step)
                for _ in range(n):
                    self.state = step(self.state)
            else:  # raises if the state's tensors were replaced
                loop = (self._fsm_loop if constrained
                        else self._plain_loop if plain else self._loop)
                loop(self.state, n)
            self.stats.steps += n
            self.stats.occupied_slot_steps += n * occupied
        self._advance_admission()
        self._retire_finished()

    @torch.inference_mode()
    def _retire_finished(self) -> None:
        """The poll: one [4, B] read of the flags, lengths and counters;
        retire the inactive slots (their table rows zeroed), then lazy page
        growth from the same lengths."""
        st = self.state
        flags = torch.stack([st.active.to(torch.int32), st.lengths, st.proposed,
                             st.accepted]).cpu().numpy()
        active, lengths, proposed, accepted = flags[0].astype(bool), flags[1], flags[2], flags[3]
        retiring = [s for s, r in enumerate(self._slots)
                    if r is not None and not r.prefilling and not active[s]]
        self._tokens = None  # the token buffer, fetched at most once a poll
        if retiring:
            tokens, logprobs = self._fetch_tokens(), st.token_logprobs.cpu().numpy()
            tops = self._fetch_tops()
            eng = self.engine
            for slot in retiring:
                req = self._slots[slot]
                plen = len(req.ids)
                gen = tokens[slot, plen: lengths[slot]].tolist()
                prop = int(proposed[slot]) + req.prior_proposed
                acc = int(accepted[slot]) + req.prior_accepted
                reuse = req.reuse_len
                req.result = {
                    "req_id": req.req_id,
                    "text": eng.tokenizer.decode([t for t in gen if t != eng.eos_token_id]),
                    "generated_ids": gen,
                    "token_logprobs": [round(float(x), 6)
                                       for x in logprobs[slot, plen: lengths[slot]]],
                    # Positions up to reuse_len were served from the prefix
                    # cache and never scored again: None, as position 0.
                    "prompt_logprobs": [None] + [
                        None if 0 < reuse and i <= reuse else round(float(x), 6)
                        for i, x in enumerate(logprobs[slot, 1:plen], start=1)],
                    # A resumed request's positions before its preemption
                    # come from the slot it held then.
                    "top_logprobs": (req.prior_tops + top_logprobs(
                        tops, slot, len(req.admit_ids), lengths[slot])
                        if tops is not None else None),
                    "generated_tokens": len(gen),
                    "proposed": prop,
                    "accepted": acc,
                    "acceptance_rate": acc / prop if prop else 0.0,
                    "prompt_tokens_reused": reuse,
                    "latency_ms": (time.perf_counter() - req.submitted_at) * 1e3,
                    "slot": slot,
                    # OpenAI semantics: "length" = ran to the token budget,
                    # "stop" = EOS (or the end of the buffer).
                    "finish_reason": ("cancelled" if req.cancelled
                                      else "length" if len(gen) >= req.max_new_tokens
                                      else "stop"),
                }
                self._done[req.req_id] = req
                self._slots[slot] = None
                self.stats.retired += 1
                self.stats.committed_tokens += len(gen)
                if self.paged:
                    self.allocator.free(req.pages)
                    req.pages = None
            self._clear_tables(retiring)
        self._apply_growth(self._plan_growth(lengths, proposed, accepted), lengths)

    def _fetch_tokens(self) -> np.ndarray:
        """The token buffer on the host, one read a poll (it changes only
        when the next chunk runs)."""
        if self._tokens is None:
            self._tokens = self.state.tokens.cpu().numpy()
        return self._tokens

    def _fetch_tops(self):
        """The top-N buffers (ids, log-probs) on the host, under
        logprobs_topk (JAX _fetch_tops); None when off."""
        if not self.engine.config.logprobs_topk:
            return None
        return self.state.top_ids.cpu().numpy(), self.state.top_lps.cpu().numpy()

    @torch.inference_mode()
    def poll_generated(self) -> Dict[int, List[int]]:
        """The ids each decoding request has generated so far, by req_id (one
        read of the lengths and the token buffer): the server diffs two
        polls for its stream deltas and stop strings (JAX
        poll_generated)."""
        st = self.state
        both = torch.cat([st.lengths[:, None], st.tokens], dim=1).cpu().numpy()
        return {req.req_id: both[slot, 1 + len(req.ids):1 + both[slot, 0]].tolist()
                for slot, req in enumerate(self._slots)
                if req is not None and not req.prefilling}

    def _clear_tables(self, slots: List[int]) -> None:
        """Zero the slots' table rows. An inactive lane still rides every
        step and writes K+1 junk rows at its stale offset: through a zeroed
        row they land in the dummy page 0, never in freed pages another
        request may own next."""
        if not self.paged or not slots:
            return
        st = self.state
        idx = torch.tensor(slots, dtype=torch.long, device=st.tokens.device)
        for cache in (st.target_cache, st.draft_cache):
            if cache is not None:
                cache.table[idx] = 0

    # ------------------------------------------------------------ lazy pages
    def _plan_growth(self, lengths: np.ndarray, proposed: np.ndarray,
                     accepted: np.ndarray) -> List[tuple]:
        """Lazy growth and preemption, host decisions only: keep each
        decoding slot's pages _grow_margin tokens ahead of its length; on a
        dry pool preempt the youngest other slot, or with none left truncate
        the request. Returns the ops in order (a preemption frees the pages
        the growth after it takes): ("grow", slot, table_row) |
        ("truncate", slot) | ("preempt", slot, req, proposed, accepted). The
        allocator and the slot map change here, so later decisions see
        them; the device and the queue change in _apply_growth."""
        ops: List[tuple] = []
        if not self.lazy_pages:
            return ops
        P = self.allocator.page_size
        eng = self.engine
        for slot in range(self.n_slots):
            req = self._slots[slot]
            if req is None or req.prefilling or req.pages is None:
                continue
            L = int(lengths[slot])
            if L < len(req.admit_ids) or L + self._grow_margin <= len(req.pages) * P:
                continue
            cap_tok = len(req.admit_ids) + req.remaining_new + eng._max_k + 2
            need = (self.allocator.pages_needed(min(L + 2 * self._grow_margin, cap_tok))
                    - len(req.pages))
            if need <= 0:
                continue
            got = self.allocator.alloc(need)
            while got is None:
                victim = self._youngest_slot(exclude=slot)
                if victim is None:
                    logging.getLogger(__name__).warning(
                        "page pool exhausted with no preemption victim; truncating request "
                        "%d at %d tokens", req.req_id, L)
                    ops.append(("truncate", slot))
                    break
                vr = self._slots[victim]
                ops.append(("preempt", victim, vr, int(proposed[victim]), int(accepted[victim])))
                self.allocator.free(vr.pages)
                self._slots[victim] = None
                got = self.allocator.alloc(need)
            if got is None:
                continue
            req.pages = req.pages + got
            ops.append(("grow", slot, self._table_row(req)))
        return ops

    def _apply_growth(self, ops: List[tuple], lengths: np.ndarray) -> None:
        """The device writes and the requeues of a growth plan: a grown
        slot's table row; a truncated slot deactivated; a preempted slot
        deactivated with its table row zeroed, its request requeued with
        its prompt + generated tokens (read from the token buffer at this
        poll, outside any graph) to resume by recompute."""
        st = self.state
        for op in ops:
            kind, slot = op[0], op[1]
            if kind == "grow":
                row = torch.from_numpy(op[2]).to(st.tokens.device)
                for cache in (st.target_cache, st.draft_cache):
                    if cache is not None:
                        cache.table[slot] = row
                self.stats.page_grows += 1
            elif kind == "truncate":
                st.active[slot] = False
            else:
                req, prop, acc = op[2], op[3], op[4]
                tops = self._fetch_tops()
                if tops is not None:
                    req.prior_tops += top_logprobs(tops, slot, len(req.admit_ids),
                                                   int(lengths[slot]))
                req.resume_ids = self._fetch_tokens()[slot, : int(lengths[slot])].tolist()
                st.active[slot] = False
                self._clear_tables([slot])
                req.pages = None
                req.prior_proposed += prop
                req.prior_accepted += acc
                self.stats.preemptions += 1
                self._requeue(req)

    def _youngest_slot(self, exclude: int) -> Optional[int]:
        """The most recently admitted decoding slot other than exclude: the
        preemption victim with the least recompute to lose."""
        best, best_seq = None, -1
        for s, r in enumerate(self._slots):
            if s == exclude or r is None or r.prefilling:
                continue
            if r.admit_seq > best_seq:
                best, best_seq = s, r.admit_seq
        return best

    def run(self) -> List[dict]:
        """Drain the queue and every slot; returns results ordered by req_id."""
        t0 = time.perf_counter()
        self._admit_pending()
        while any(r is not None for r in self._slots):
            self.step_chunk()
            self._admit_pending()
        if self.scheduler.pending():
            raise RuntimeError("a queued request needs more KV pages than the pool holds")
        self.engine._sync()
        self.stats.wall_s += time.perf_counter() - t0
        return [self._done[rid].result for rid in sorted(self._done)]

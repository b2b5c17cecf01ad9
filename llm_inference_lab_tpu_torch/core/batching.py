"""Continuous batching: slot-based admission into a fixed-shape decode batch.

Port of llm_inference_lab_tpu/core/batching.py (``ContinuousBatcher`` with
``make_admit_many``) for the ported slice. The decode batch has a fixed
shape [n_slots, max_seq_len]; a request occupies a slot, decodes, retires
and its slot is refilled from the queue:

    batcher = ContinuousBatcher(engine, n_slots=8)
    ids = [batcher.submit(p, max_new_tokens=64) for p in prompts]
    results = batcher.run()          # drain everything, ordered by req_id

Admission prefills a whole wave at once: one [G, P] forward per model into
a [L, G, KVH, P, D] scratch cache of the slots' KV type (int8 with its
scales under ``kv_quantization="int8"``), spliced into the slots' cache
lanes (contiguous) or their pages (paged, ``kv_layout="paged"``). With pages,
admission is memory-aware: a request waits until the allocator can reserve
pages for its prompt, its budget and the step's K+2 scratch rows, all up
front (the JAX package's ``kv_lazy_pages=False``).

The engine's step is the batcher's: vanilla, ngram, Medusa or EAGLE
drafting or tree speculation (with all but vanilla there is no draft model
and so no draft cache to splice; the head modes' hidden carry is seeded
from the admission prefill), any of the five policies, greedy decoding or
the engine's sampling, drawn from the batcher's state key (the engine's
seed), at a fixed K. Page reservations and the prompt cut leave the step's
scratch rows, the engine's ``_max_k`` + 2 (a tree's num_nodes + 3).

Left out of this slice (ROADMAP Queue 1): lazy pages with preemption,
prefix caching, incremental (chunked) admission and with it an engine with
a rolling-buffer cache (``kv_ring``, which raises here), adaptive K (both
adaptive controllers raise here: their per-slot update at admission is not
ported), per-request sampling, penalties, ``logit_bias``, grammars, LoRA,
top-N logprobs and cancel; and the TPU host's tuning of the
loop (chunk cost model, async and prefetched polls, fused and overlapped
admission, traces). The loop here runs POLL_EVERY steps, then reads the
flags once and retires and admits. The steps are replays of the engine's
decode loop (core/specstep.py ``make_decode_loop``, a CUDA graph on the card)
over the batcher's own state, captured at construction with every lane
inactive; admission and retirement write that state's tensors in place. With
the engine's ``EnvFlags(sync_steps=True)`` the batcher runs the functional
step instead, one call a step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from llm_inference_lab_tpu_torch.core.engine import Engine, _round_up
from llm_inference_lab_tpu_torch.core.scheduler import Scheduler
from llm_inference_lab_tpu_torch.core.specstep import make_decode_loop
from llm_inference_lab_tpu_torch.core.state import DecodeState, init_state
from llm_inference_lab_tpu_torch.models.base import Model
from llm_inference_lab_tpu_torch.models.paged import PageAllocator, PagedKVCache

POLL_EVERY = 4  # decode steps between two host reads of the slots' flags


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


@dataclass
class BatcherStats:
    """Counters of the serving loop, read by ``report``."""

    admitted: int = 0  # requests admitted
    retired: int = 0  # requests retired
    steps: int = 0  # decode steps run
    admit_waves: int = 0  # [G, P] admission prefills
    committed_tokens: int = 0  # generated tokens of retired requests
    occupied_slot_steps: int = 0  # sum over steps of occupied slots
    wall_s: float = 0.0  # time inside run()

    def report(self) -> Dict[str, Any]:
        return {
            "admitted": self.admitted,
            "retired": self.retired,
            "steps": self.steps,
            "admit_waves": self.admit_waves,
            "committed_tokens": self.committed_tokens,
            "wall_s": self.wall_s,
            "tok_s": self.committed_tokens / self.wall_s if self.wall_s else 0.0,
            "mean_occupied_slots": (self.occupied_slot_steps / self.steps
                                    if self.steps else 0.0),
        }


def make_admit_many(target_model: Model, draft_model: Optional[Model], hidden: bool = False):
    """G-slot admission: ONE [G, P] prefill forward per model into a
    [L, G, KVH, P, D] scratch cache, then a splice into the G slots. The
    scratch has the slots' KV dtype, so an int8 cache's admitted rows are
    quantized per row from the same forward rows as Engine.generate's, and
    the splice carries their scales with them.

    admit(state, rows [G, P], prompt_lens [G], slots [G], max_news [G],
          table_rows [G, M] or None) -> state, all int32 on the device.

    Contiguous caches take the scratch into lanes [0, P) of the slots (rows
    past P keep stale data, which the position mask hides until decode
    overwrites it). Paged caches take scratch page j of row g into page
    table_rows[g, j] and set the slots' table rows; a request whose own
    allocation is shorter than the group's padded P sends the excess into
    page 0, the dummy page no allocation owns. The prompt logprobs of each
    prompt token come from the prefill logits. hidden (the head modes): the
    target's hidden row that predicted each prompt's last token (index
    prompt_len - 2, clamped at 0) seeds the slot's last_hidden and
    prev_hidden. The state's tensors are written in place."""

    def splice(cache, sub, slots: torch.Tensor, table_rows: Optional[torch.Tensor]) -> None:
        G, P = sub.k.shape[1], sub.k.shape[3]
        pairs = [(sub.k, cache.k), (sub.v, cache.v)]
        if cache.k_scale is not None:  # int8: the scale rows travel with the values
            pairs += [(sub.k_scale, cache.k_scale), (sub.v_scale, cache.v_scale)]
        if isinstance(cache, PagedKVCache):
            pg = cache.page_size
            pids = table_rows[:, : P // pg].long()  # [G, J]
            for src, dst in pairs:
                # [L, G, KVH, J*pg(, D)] -> [L, G, J, KVH, pg(, D)], page-major
                L, _, KVH = src.shape[:3]
                dst[:, pids] = src.reshape(L, G, KVH, P // pg, pg, *src.shape[4:]).transpose(2, 3)
            cache.table[slots] = table_rows
        else:
            for src, dst in pairs:
                dst[:, slots, :, :P] = src

    def admit(state: DecodeState, rows: torch.Tensor, prompt_lens: torch.Tensor,
              slots: torch.Tensor, max_news: torch.Tensor,
              table_rows: Optional[torch.Tensor]) -> DecodeState:
        G, P = rows.shape
        dev = rows.device
        positions = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(G, 1)
        zeros = torch.zeros((G,), dtype=torch.int32, device=dev)
        slots_l = slots.long()

        def prefill(model: Model, cache, want_hidden=False):
            scratch = model.init_cache(G, P, dev, dtype=cache.k.dtype)
            out = model.forward(rows, positions, scratch, zeros, return_hidden=want_hidden)
            splice(cache, scratch, slots_l, table_rows)
            return out[0], out[2] if want_hidden else None

        lg, hid = prefill(target_model, state.target_cache, hidden)
        if draft_model is not None:
            prefill(draft_model, state.draft_cache)
        # Prompt logprobs: row i of the logits scores prompt token i+1;
        # position 0 has no conditional, padding rows are 0.
        lg32 = lg[:, :-1].float()
        row_lp = (lg32.gather(-1, rows[:, 1:, None].long())[..., 0]
                  - torch.logsumexp(lg32, dim=-1))
        row_lp = torch.where(positions[:, 1:] < prompt_lens[:, None], row_lp, 0.0)
        max_len = state.tokens.shape[1]
        lp_lanes = torch.zeros((G, max_len), dtype=torch.float32, device=dev)
        lp_lanes[:, 1:P] = row_lp
        token_rows = torch.zeros((G, max_len), dtype=torch.int32, device=dev)
        token_rows[:, :P] = rows
        state.tokens[slots_l] = token_rows
        state.token_logprobs[slots_l] = lp_lanes
        state.lengths[slots_l] = prompt_lens
        state.prompt_lens[slots_l] = prompt_lens
        state.max_new[slots_l] = max_news
        state.active[slots_l] = prompt_lens > 0
        for counter in (state.proposed, state.accepted, state.bonus):
            counter[slots_l] = 0
        if hidden:
            h_idx = (prompt_lens - 2).clamp_min(0).long()
            h_last = hid[torch.arange(G, device=dev), h_idx].float()
            state.last_hidden[slots_l] = h_last
            state.prev_hidden[slots_l] = h_last
        return state

    return admit


class ContinuousBatcher:
    """Drives an Engine's step over a fixed slot batch with rolling
    admission and retirement, on the engine's device."""

    def __init__(self, engine: Engine, n_slots: int = 8):
        if engine.config.controller != "fixed":
            raise NotImplementedError(
                f"the {engine.config.controller!r} controller in the batcher (a per-slot K "
                "reset at admission) is not ported yet; use controller='fixed'")
        if any(m is not None and m.config.kv_ring_len is not None
               for m in (engine.target, engine.draft)):
            # A wave's one-shot [G, P] prefill would wrap a ring shorter than
            # its prompts over rows its own queries still need.
            raise NotImplementedError(
                "serving over a rolling-buffer cache (kv_ring) needs incremental admission "
                "(admit_chunk), which is not ported yet")
        self.engine = engine
        self.n_slots = n_slots
        cfg = engine.config
        self.max_seq_len = cfg.max_seq_len
        self.scheduler = Scheduler()
        self._requests: Dict[int, _Request] = {}
        self._slots: List[Optional[_Request]] = [None] * n_slots
        self._done: Dict[int, _Request] = {}
        self._next_id = 0
        self._admit_many = make_admit_many(engine.target, engine.draft, engine.head_mode)
        self.stats = BatcherStats()
        self.paged = cfg.kv_layout == "paged"
        paged_kw = {}
        self.allocator: Optional[PageAllocator] = None
        if self.paged:
            P = cfg.kv_page_size
            self._pages_per_seq = (self.max_seq_len + P - 1) // P
            n_pages = cfg.kv_pages or (n_slots * self._pages_per_seq + 1)
            self.allocator = PageAllocator(n_pages, P)
            paged_kw = dict(paged=True, page_size=P, n_pages=n_pages,
                            table=torch.zeros((n_slots, self._pages_per_seq), dtype=torch.int32))
        with torch.inference_mode():
            self.state = init_state(engine.target, engine.draft, n_slots, self.max_seq_len,
                                    engine.device, max_new_tokens=cfg.max_new_tokens,
                                    kv_dtype=engine.kv_dtype, seed=cfg.seed,
                                    init_k=engine.controller.k, **paged_kw)
            self._loop = None
            if not engine.flags.sync_steps:
                self._loop = make_decode_loop(engine._step_in_place, pool=engine.graph_pool)
                self._loop.bind(self.state)

    def submit(self, prompt: str, max_new_tokens: Optional[int] = None) -> int:
        """Queue a prompt; returns its req_id."""
        max_new = max_new_tokens or self.engine.config.max_new_tokens
        ids = self.engine.encode(prompt, max_new, self.max_seq_len)
        req = _Request(self._next_id, prompt, ids, max_new)
        self._next_id += 1
        self._requests[req.req_id] = req
        self.scheduler.submit(req.req_id, len(ids), max_new)
        return req.req_id

    # ------------------------------------------------------------------
    def _plan_admissions(self) -> List[_Request]:
        """Host-side admission decisions (queue order, slots, pages): pops
        the chosen requests and sets req.slot / req.pages."""
        eng = self.engine
        free = [s for s in range(self.n_slots) if self._slots[s] is None]
        plans: List[_Request] = []
        if not free or not self.scheduler.pending():
            return plans
        if not self.paged:
            for rid, slot in zip(self.scheduler.admit(len(free)), free):
                req = self._requests.pop(rid)
                req.slot = slot
                plans.append(req)
            return plans
        # Paged: memory-aware admission, one at a time. A request whose pages
        # the pool cannot give goes back to the queue and admission stops
        # (the scheduler's overdue rule keeps it from starving).
        for slot in free:
            if not self.scheduler.pending():
                break
            (rid,) = self.scheduler.admit(1)
            req = self._requests[rid]
            need = self.allocator.pages_needed(
                len(req.ids) + req.max_new_tokens + eng._max_k + 2)
            pages = self.allocator.alloc(need)
            if pages is None:
                self.scheduler.submit(rid, len(req.ids), req.max_new_tokens)
                break
            req.pages = pages
            req.slot = slot
            self._requests.pop(rid)
            plans.append(req)
        return plans

    @torch.inference_mode()
    def _admit_pending(self) -> None:
        """Admit what the free slots and pages allow: requests sorted by
        length, in power-of-two groups, one [G, P] prefill each."""
        group = sorted(self._plan_admissions(), key=lambda r: len(r.ids))
        while group:
            n = 1
            while n * 2 <= len(group):
                n *= 2
            self._admit_group(group[:n])
            group = group[n:]

    def _admit_group(self, reqs: List[_Request]) -> None:
        """One admission wave. P is the page size (paged) or 32
        (contiguous), doubled until it holds the longest prompt, so the
        prefill shapes stay few."""
        dev = self.engine.device
        G = len(reqs)
        bucket = self.engine.config.kv_page_size if self.paged else 32
        need = max(_round_up(max(len(r.ids), 1), bucket) for r in reqs)
        lane = self.state.tokens.shape[1]
        P = bucket
        while P < need:
            P *= 2
        if P > lane:
            P = need
        rows = np.zeros((G, P), np.int32)
        meta = np.zeros((3, G), np.int32)  # prompt_lens, slots, max_news
        table_rows = np.zeros((G, self._pages_per_seq if self.paged else 1), np.int32)
        for i, req in enumerate(reqs):
            rows[i, : len(req.ids)] = req.ids
            meta[:, i] = (len(req.ids), req.slot, req.max_new_tokens)
            if self.paged:
                table_rows[i, : len(req.pages)] = req.pages
        plens, slots, max_news = torch.from_numpy(meta).to(dev)
        self.state = self._admit_many(
            self.state, torch.from_numpy(rows).to(dev), plens, slots, max_news,
            torch.from_numpy(table_rows).to(dev) if self.paged else None)
        self.stats.admit_waves += 1
        for req in reqs:
            self._slots[req.slot] = req
            self.stats.admitted += 1

    @torch.inference_mode()
    def step_chunk(self, n: int = POLL_EVERY) -> None:
        """n decode steps over all slots, then one host read of the flags,
        which retires the requests that finished."""
        occupied = sum(r is not None for r in self._slots)
        if self._loop is None:
            for _ in range(n):
                self.state = self.engine._step(self.state)
        else:
            self._loop(self.state, n)  # raises if the state's tensors were replaced
        self.stats.steps += n
        self.stats.occupied_slot_steps += n * occupied
        self._retire_finished()

    def _retire_finished(self) -> None:
        st = self.state
        flags = torch.stack([st.active.to(torch.int32), st.lengths, st.proposed,
                             st.accepted]).cpu().numpy()
        active, lengths, proposed, accepted = flags[0].astype(bool), flags[1], flags[2], flags[3]
        retiring = [s for s, r in enumerate(self._slots) if r is not None and not active[s]]
        if not retiring:
            return
        tokens = st.tokens.cpu().numpy()
        logprobs = st.token_logprobs.cpu().numpy()
        eng = self.engine
        for slot in retiring:
            req = self._slots[slot]
            plen = len(req.ids)
            gen = tokens[slot, plen: lengths[slot]].tolist()
            prop, acc = int(proposed[slot]), int(accepted[slot])
            req.result = {
                "req_id": req.req_id,
                "text": eng.tokenizer.decode([t for t in gen if t != eng.eos_token_id]),
                "generated_ids": gen,
                "token_logprobs": [round(float(x), 6) for x in logprobs[slot, plen: lengths[slot]]],
                "prompt_logprobs": [None] + [round(float(x), 6) for x in logprobs[slot, 1:plen]],
                "generated_tokens": len(gen),
                "proposed": prop,
                "accepted": acc,
                "acceptance_rate": acc / prop if prop else 0.0,
                "prompt_tokens_reused": 0,
                "latency_ms": (time.perf_counter() - req.submitted_at) * 1e3,
                "slot": slot,
                # OpenAI semantics: "length" = ran to the token budget,
                # "stop" = EOS (or the end of the buffer).
                "finish_reason": "length" if len(gen) >= req.max_new_tokens else "stop",
            }
            self._done[req.req_id] = req
            self._slots[slot] = None
            self.stats.retired += 1
            self.stats.committed_tokens += len(gen)
            if self.paged:
                self.allocator.free(req.pages)
                req.pages = None
        if self.paged:
            # An inactive lane still rides every step and writes K+1 junk
            # rows at its stale offset: through a zeroed table row they land
            # in the dummy page 0, never in freed pages another request
            # may own next.
            idx = torch.tensor(retiring, dtype=torch.long, device=st.tokens.device)
            for cache in (st.target_cache, st.draft_cache):
                if cache is not None:
                    cache.table[idx] = 0

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

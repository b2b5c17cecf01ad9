"""Multi-process continuous batching: coordinator-planned, collectively
executed (port of llm_inference_lab_tpu/core/multihost_batching.py).

Every rank runs the same loop. The host decisions that could differ
between ranks (admission: which request, which slot, which pages; the
chunk's K; growth and preemption; the loop's end) are made by the
coordinator (rank 0, which owns the queue, the scheduler and the page
allocator) and sent to every rank in one fixed-shape int32 broadcast a
poll (``_sync_poll``); growth plans ride a second one (``_plan_growth``).
Every rank keeps the host bookkeeping of every slot; its decode state holds
its own slots (n_slots / data rows, at its KV heads), and a paged pool is
full-size on every rank, indexed by the coordinator's global page ids.
Retirement reads the all-gathered flags, tokens and log-probs, so every
rank retires the same slots at the same poll. The control traffic is
CPU tensors over the mesh's gloo group, whatever the data plane's backend.

A rank's step has collectives only inside its model and expert groups (the
tensor- and expert-parallel forward); ranks of different data rows meet at
the polls. Under prefix caching a page is written only by the rank whose
slot admitted the prompt, so after each wave the pages the wave registered
are copied from that rank to the same pages of every other data row
(``_share_pages``: JAX's pool is one array replicated over data, its page
axis never on data), and a later request on any row that reuses them reads
the same rows. ``cancel`` is the coordinator's: it records the request, the
next poll's broadcast carries it, and every rank deactivates the slot that
holds it at that poll (it retires at the next with its tokens so far) or,
for a request still queued, gives it the coordinator's cancelled result.

    initialize_multihost()
    mesh = make_multihost_mesh(model_per_host=...)
    eng = Engine(cfg, mesh=mesh)
    batcher = MultiHostBatcher(eng, n_slots=8)
    if batcher.is_coordinator:
        for p in prompts:
            batcher.submit(p)
    results = batcher.run()   # collective; authoritative on the coordinator

JAX's ``_supports_*`` switches are kept: no incremental, overlapped or
fused admission (one-shot waves); lazy pages, growth and preemption are
supported. In one process the class is ContinuousBatcher with those
switches. A data row's ranks may span the stage, expert, seq and model
axes: each holds the row's slots (its cache slice of T under seq, its
stage's layers under stage) and steps with its groups' collectives.

A rolling-buffer (``kv_ring``) engine serves here under the data and model
axes (JAX refuses the ring with the seq axis, as the port's engine does):
every ring prompt is admitted one-shot, a prompt longer than the ring as
ceil(P / C) back-to-back forwards of C = prefill_chunk rows through a
ring-sized scratch, then one splice (ContinuousBatcher._admit_long_ring).
The chunk count is a function of the prompt's length, which every rank
holds from the coordinator's plan, so every rank of the slot's model group
runs the same forwards in the same order, and no control traffic is added.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from llm_inference_lab_tpu_torch.constrain.runtime import STACK_DEPTH
from llm_inference_lab_tpu_torch.core.batching import (
    _F32_CONTROLS,
    CONTROLS,
    ContinuousBatcher,
    _Request,
    derive_request_seed,
)
from llm_inference_lab_tpu_torch.core.state import N_BIAS
from llm_inference_lab_tpu_torch.parallel.mesh import CONTROL

# Header columns of an admission: slot, context length, remaining budget,
# req_id, top_k, reuse_len, resolved seed, FSM initial, LoRA id, pages,
# FSM lexer state, FSM stack height, prompt length, whole budget (the last
# two differ from the context's for a request resumed after a preemption).
_HEADER = 14
_GROW_KINDS = {"grow": 1, "truncate": 2, "preempt": 3}


def _count(t0: float) -> None:
    """One control collective, begun at t0, in parallel/mesh.py CONTROL."""
    CONTROL["calls"] += 1
    CONTROL["seconds"] += time.perf_counter() - t0


class MultiHostBatcher(ContinuousBatcher):
    """ContinuousBatcher whose host decisions are the coordinator's,
    broadcast; all device work stays on each rank's own slots."""

    _supports_incremental_admit = False
    _supports_overlap_admit = False
    _supports_fused_admit = False
    _coordinated = True

    def __init__(self, engine, n_slots: int = 8, **kw):
        mesh = engine.mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.n_procs = mesh.size if mesh is not None else 1
        self.is_coordinator = self.rank == 0
        super().__init__(engine, n_slots=n_slots, **kw)
        self._group = mesh.control if mesh is not None else None
        self._data = mesh.shape["data"] if mesh is not None else 1
        # Ranks a data row (its stage, expert, seq and model ranks): a run of
        # consecutive ranks, since data is the mesh's major axis
        # (parallel/mesh.py AXES), so row d's first rank is d * _per_row.
        self._per_row = self.n_procs // self._data
        self._cancels: List[int] = []  # the coordinator's, not yet broadcast
        self._row_buf = self.max_seq_len
        self._tab_buf = self._pages_per_seq if self.paged else 1
        self._k_sync = int(super()._current_k())

    # -- host-decision overrides ---------------------------------------
    def submit(self, prompt: str, max_new_tokens: Optional[int] = None, **kw) -> int:
        if not self.is_coordinator:
            raise RuntimeError("submit() is coordinator-only (rank 0 owns the queue); the other "
                               "ranks just call run()")
        return super().submit(prompt, max_new_tokens, **kw)

    def cancel(self, req_id: int) -> bool:
        """ContinuousBatcher.cancel on the coordinator's decisions: a queued
        request is dropped at admission there; the cancel rides the next
        poll's broadcast, at which every rank deactivates the slot holding
        the request (it retires at the next poll with the tokens it has) or
        gives a queued one the cancelled result. False for a request neither
        queued nor in a slot."""
        if self.n_procs == 1:
            return super().cancel(req_id)
        if not self.is_coordinator:
            raise RuntimeError("cancel() is coordinator-only (rank 0 owns the queue); the other "
                               "ranks apply it at the next poll")
        req = self._requests.get(req_id)
        queued = req is not None and req.slot is None
        if not queued and all(r is None or r.req_id != req_id for r in self._slots):
            return False
        if queued:
            req.cancelled = True
        self._cancels.append(req_id)
        return True

    def _apply_cancels(self, ids: np.ndarray) -> None:
        """The broadcast cancels, on every rank at the same poll: a slot that
        holds one is deactivated (it retires at the next poll, cancelled);
        a queued one, which the coordinator drops at admission, gets its
        cancelled result on the other ranks."""
        for rid in (int(x) for x in ids if x >= 0):
            slot = next((s for s, r in enumerate(self._slots)
                         if r is not None and r.req_id == rid), None)
            if slot is not None:
                self._slots[slot].cancelled = True
                self._deactivate(slot)
            elif not self.is_coordinator and rid not in self._done:
                self._finish_cancelled(_Request(rid, "", [], 0))

    def _current_k(self) -> int:
        # K picks the step: every rank steps at the coordinator's value.
        if getattr(self, "n_procs", 1) == 1:
            return super()._current_k()
        return self._k_sync

    def _fsm_of(self, req: _Request) -> tuple:
        state = getattr(req, "fsm_state", None)  # a placeholder's, from the broadcast
        return state if state is not None else super()._fsm_of(req)

    # -- the gathers ----------------------------------------------------
    def _gather_rows(self, t: torch.Tensor) -> np.ndarray:
        """Every data rank's rows of a state tensor [rows, ...], in slot
        order, on every rank (the first rank of each data row stands for it:
        its stage, expert, seq and model ranks hold the same rows)."""
        src = t.detach().cpu().contiguous()  # waits for the chunk (not counted)
        t0 = time.perf_counter()
        parts = [torch.empty_like(src) for _ in range(self.n_procs)]
        dist.all_gather(parts, src, group=self._group)
        _count(t0)
        return torch.cat([parts[d * self._per_row] for d in range(self._data)]).numpy()

    def _fetch_flags(self) -> tuple:
        if self.n_procs == 1:
            return super()._fetch_flags()
        st = self.state
        f = self._gather_rows(torch.stack([
            st.active.to(torch.int32), st.proposed.to(torch.int32),
            st.accepted.to(torch.int32), st.lengths.to(torch.int32),
            st.steps.to(torch.int32).expand(st.lengths.shape[0])], dim=1))
        # A step counts where a lane of its rank was active: the fleet's
        # count is the largest.
        return (f[:, 0].astype(bool), f[:, 1].copy(), f[:, 2].copy(), f[:, 3].copy(),
                int(f[:, 4].max()))

    def _fetch_tokens(self, flags=None) -> tuple:
        if self.n_procs == 1:
            return super()._fetch_tokens(flags)
        st = self.state
        return (self._gather_rows(st.tokens), self._gather_rows(st.lengths),
                self._gather_rows(st.token_logprobs))

    def _fetch_tops(self):
        if self.n_procs == 1 or not self.engine.config.logprobs_topk:
            return super()._fetch_tops()
        return self._gather_rows(self.state.top_ids), self._gather_rows(self.state.top_lps)

    def _broadcast(self, buf: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        t = torch.from_numpy(buf)
        dist.broadcast(t, src=0, group=self._group)
        _count(t0)
        return t.numpy()

    # -- growth ----------------------------------------------------------
    def _plan_growth(self, lengths: np.ndarray, proposed: np.ndarray,
                     accepted: np.ndarray) -> List[tuple]:
        """The coordinator plans (its allocator is the only source of
        truth); the ordered ops ride one fixed-shape broadcast; every rank
        redoes the plan's host bookkeeping and applies the same ops
        (_apply_growth) to the slots it holds."""
        if self.n_procs == 1:
            return super()._plan_growth(lengths, proposed, accepted)
        if not self.lazy_pages:
            return []
        B, M = self.n_slots, self._pages_per_seq
        # Rows: (kind, slot, proposed, accepted, watermark, table row[M]);
        # kind 0 ends the list. At most a grow a slot and a preemption an
        # occupied slot.
        buf = np.zeros((2 * B, 5 + M), np.int32)
        ops: List[tuple] = []
        if self.is_coordinator:
            ops = super()._plan_growth(lengths, proposed, accepted)
            for i, op in enumerate(ops):
                buf[i, 0], buf[i, 1] = _GROW_KINDS[op[0]], op[1]
                if op[0] == "grow":
                    buf[i, 5:] = op[2]
                elif op[0] == "preempt":
                    buf[i, 2:5] = op[3:6]
        buf = self._broadcast(buf)
        if self.is_coordinator:
            return ops
        for row in buf:
            kind, slot = int(row[0]), int(row[1])
            if kind == 0:
                break
            if kind == 1:
                req = self._slots[slot]
                req.pages = [int(p) for p in row[5:] if p]
                ops.append(("grow", slot, np.array(row[5:], np.int32)))
            elif kind == 2:
                ops.append(("truncate", slot))
            else:
                req = self._slots[slot]
                self._slots[slot] = None
                self._counted[slot] = self._sched_len[slot] = 0
                if req is not None and req.pages:
                    self.allocator.free(req.pages)
                ops.append(("preempt", slot, req, int(row[2]), int(row[3]), int(row[4])))
        return ops

    # -- the one broadcast a poll ----------------------------------------
    def _sync_poll(self) -> dict:
        """The coordinator plans admissions, K and the queue's state; every
        rank gets the same fixed-shape int32 payload (the sampling floats as
        their bits, the cancels since the last poll) and applies the same
        cancels, then runs the same admissions (under prefix caching, then
        shares the pages they registered)."""
        B, L, T = self.n_slots, self._row_buf, self._tab_buf
        header = np.zeros((B, _HEADER), np.int32)
        rows = np.zeros((B, L), np.int32)
        tables = np.zeros((B, T), np.int32)
        stacks = np.zeros((B, STACK_DEPTH), np.int32)
        samp = np.zeros((B, len(_F32_CONTROLS)), np.float32)
        bias_ids = np.full((B, N_BIAS), -1, np.int32)
        bias_vals = np.zeros((B, N_BIAS), np.float32)
        meta = np.zeros((3,), np.int32)  # (n_admit, pending, k)
        cancels = np.full((B,), -1, np.int32)  # request ids, -1 empty
        plans: List[_Request] = []
        if self.is_coordinator:
            sent, self._cancels = self._cancels[:B], self._cancels[B:]
            cancels[:len(sent)] = sent
            plans = self._plan_admissions()
            seed0 = self.engine.config.seed
            for i, req in enumerate(plans):
                vals = self._values(req)
                lex, stack, sp = self._fsm_of(req)
                ids = req.admit_ids
                header[i] = (req.slot, len(ids), req.remaining_new, req.req_id, vals["top_k"],
                             req.reuse_len, derive_request_seed(seed0, req.req_id, req.seed),
                             req.fsm_init, req.lora_id, len(req.pages or ()), lex, sp,
                             len(req.ids), req.max_new_tokens)
                stacks[i] = stack
                rows[i, :len(ids)] = ids
                samp[i] = [vals[name] for name in _F32_CONTROLS]
                for j, (tid, bias) in enumerate((req.logit_bias or {}).items()):
                    bias_ids[i, j], bias_vals[i, j] = int(tid), float(bias)
                if self.paged:
                    tables[i, :len(req.pages)] = req.pages
            meta[:] = (len(plans), self.scheduler.pending(), super()._current_k())
        parts = (header, rows, tables, stacks, samp.view(np.int32), bias_ids,
                 bias_vals.view(np.int32), meta, cancels)
        if self.n_procs > 1:
            flat = self._broadcast(np.concatenate([p.reshape(-1) for p in parts]))
            out, at = [], 0
            for p in parts:
                out.append(flat[at:at + p.size].reshape(p.shape))
                at += p.size
            header, rows, tables, stacks, samp_bits, bias_ids, bias_bits, meta, cancels = out
            samp, bias_vals = samp_bits.view(np.float32), bias_bits.view(np.float32)
            self._apply_cancels(cancels)
        n_admit, pending, self._k_sync = (int(x) for x in meta)
        if not self.is_coordinator:
            plans = [self._placeholder(header[i], rows[i], tables[i], stacks[i], samp[i],
                                       bias_ids[i], bias_vals[i]) for i in range(n_admit)]
        self._admit_planned(plans)
        self._share_pages(plans)
        return {"pending": pending, "admitted": n_admit}

    def _share_pages(self, plans: List[_Request]) -> None:
        """Under prefix caching on several data rows: the pages a wave's
        admissions registered (each prompt's full chunks past its reused
        prefix, PrefixPageCache.register's) copied from the rank whose slot
        wrote them to the same page of every other data row's rank with the
        same stage, expert, seq and model coordinates (a paged pool is whole
        on every seq rank): k, v and the int8 scales of both
        caches, in one all-gather of bytes over the control group."""
        if not (self.prefix_caching and self._data > 1):
            return
        P = self.engine.config.kv_page_size
        pages, writers = [], []
        for req in plans:
            for j in range(req.reuse_len // P, len(req.admit_ids) // P):
                pages.append(req.pages[j])
                writers.append(req.slot // self._rows)
        if not pages:
            return
        leaves = [t for c in (self.state.target_cache, self.state.draft_cache) if c is not None
                  for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None]
        dev = leaves[0].device
        idx = torch.tensor(pages, device=dev)
        src = torch.cat([t.index_select(1, idx).contiguous().view(torch.uint8).reshape(-1)
                         for t in leaves]).cpu()  # waits for the admissions (not counted)
        t0 = time.perf_counter()
        got = [torch.empty_like(src) for _ in range(self.n_procs)]
        dist.all_gather(got, src, group=self._group)
        _count(t0)
        mine = self.rank // self._per_row
        for w in sorted(set(writers) - {mine}):
            part = got[self.rank + (w - mine) * self._per_row].to(dev)
            sel = torch.tensor([i for i, x in enumerate(writers) if x == w], device=dev)
            at = 0
            for t in leaves:
                shape = (t.shape[0], len(pages), *t.shape[2:])
                n = math.prod(shape) * t.element_size()
                blk = part[at:at + n].clone().view(t.dtype).reshape(shape)
                t.index_copy_(1, idx[sel], blk.index_select(1, sel))
                at += n

    def _placeholder(self, head, row, table, stack, samp, bias_ids, bias_vals) -> _Request:
        """A request with what every rank's admission and retirement read:
        its prompt and the context it resumes with, budget, controls, key,
        FSM, adapter, slot and pages. Its result has the coordinator's ids
        (not its text's prompt, nor a resumed request's counts from before
        its preemption)."""
        (slot, clen, _, rid, top_k, reuse_len, seed, fsm_init, lora_id, n_pages, lex, sp,
         plen, max_new) = (int(x) for x in head)
        names = {state: name for name, state in CONTROLS.items()}
        controls = {names[k]: float(v) for k, v in zip(_F32_CONTROLS, samp)}
        controls["top_k"] = top_k
        req = _Request(rid, "", [int(t) for t in row[:plen]], max_new, controls=controls,
                       logit_bias={int(t): float(v) for t, v in zip(bias_ids, bias_vals)
                                   if t >= 0} or None,
                       seed=seed, fsm_init=fsm_init, lora_id=lora_id)
        req.slot, req.reuse_len = slot, reuse_len
        if clen != plen:
            req.resume_ids = [int(t) for t in row[:clen]]
        req.fsm_state = (lex, stack.copy(), sp)
        if self.paged:
            req.pages = [int(p) for p in table[:n_pages]]
        return req

    # -- the collective drain --------------------------------------------
    @torch.inference_mode()
    def run(self, max_steps: Optional[int] = None) -> List[dict]:
        """Drain the queue and every slot on every rank in lockstep: a sync
        poll, a chunk of poll_every steps, the retirement poll, and again.
        Results are authoritative on the coordinator (the other ranks
        return placeholders' results with the same ids). A queued request
        the empty pool cannot hold raises on every rank."""
        if self.n_procs == 1:
            return super().run(max_steps)
        info = self._sync_poll()
        steps, limit = 0, max_steps or 10_000_000
        while steps < limit:
            occupied = any(s is not None for s in self._slots)
            if not occupied and info["pending"] == 0:
                break
            if not occupied:
                raise RuntimeError("a queued request needs more KV pages than the pool holds")
            self.step_chunk(self.poll_every)
            steps += self.poll_every
            self._retire_finished()
            info = self._sync_poll()
        self._retire_finished()
        self._flush_stale_tables()
        return [self._done[rid].result for rid in sorted(self._done)]

"""Speculative-decoding step, baseline step and prefill.

Port of llm_inference_lab_tpu/core/specstep.py for vanilla drafting with a
fixed K and greedy longest_prefix acceptance. Per spec step:

  1. Draft K tokens autoregressively (K single-token draft forwards).
  2. Verify with ONE target forward over [last_committed, d_1..d_K]: K+1
     logit rows.
  3. Acceptance: accept_len a in [0, K] per sequence (verify_prefix).
  4. Bonus token from target row a: covers the partial-accept bonus, the
     all-accepted bonus and the all-rejected fallback alike.
  5. Commit: write a+1 tokens, advance lengths, truncate at EOS and at the
     budget, deactivate finished lanes. KV "rollback" is just not advancing
     the length.

The steps are plain functions of tensors that never read a value back to the
host. A step advances ``steps`` by ``active.any()`` and commits nothing on an
inactive lane, so a step run after every lane finished changes no field (JAX's
while_loop runs no body then). Each comes in two forms: functional (a new
state; core/engine.py's host loop under ``EnvFlags(sync_steps=True)``) and
in place (``in_place=True``: the results written into the state's own
tensors), which ``make_decode_loop`` captures in a CUDA graph and replays.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, Optional

import torch

from llm_inference_lab_tpu_torch.core.policies import longest_prefix
from llm_inference_lab_tpu_torch.core.state import FIELDS, DecodeState, assign, state_tensors
from llm_inference_lab_tpu_torch.models import transformer
from llm_inference_lab_tpu_torch.models.base import Model
from llm_inference_lab_tpu_torch.ops import kernel_wrappers
from llm_inference_lab_tpu_torch.ops.sampling import sample_tokens


def _gather_last(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """tokens[b, lengths[b]-1]: the last committed token per sequence."""
    idx = (lengths - 1).clamp_min(0).long()
    return tokens.gather(1, idx[:, None])[:, 0]


def _write_rows(buf: torch.Tensor, vals: torch.Tensor, start: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """buf[b, start[b] : start[b]+n] = vals[b] for active rows, with the start
    clamped so the block fits (dynamic_update_slice semantics)."""
    n = vals.shape[1]
    start = start.clamp(0, buf.shape[1] - n)
    idx = start[:, None].long() + torch.arange(n, device=buf.device)[None]
    written = buf.scatter(1, idx, vals.to(buf.dtype))
    return torch.where(active[:, None], written, buf)


def _in_place(step):
    """step's results written into the state's own tensors (assign): a graph
    captured over them advances them on every replay. The KV caches are
    written in place by the forwards already."""

    def step_in_place(state: DecodeState) -> DecodeState:
        return assign(state, step(state))

    return step_in_place


def _advance(state: DecodeState) -> torch.Tensor:
    """steps + 1 when a lane is active, else steps: the step counts as JAX's
    while_loop counts bodies."""
    return state.steps + state.active.any().to(torch.int32)


def make_spec_step(target_model: Model, draft_model: Model, *, k: int,
                   eos_token_id: Optional[int] = None, in_place: bool = False):
    """Build step(state) -> state for greedy vanilla speculative decoding."""
    K = int(k)

    def step(state: DecodeState) -> DecodeState:
        B, max_len = state.tokens.shape
        dev = state.tokens.device
        last = _gather_last(state.tokens, state.lengths)  # [B]
        base = state.lengths - 1  # write/read offset: cache holds [0, L-1)

        # ---- 1. Draft K tokens ----
        x, drafts = last, []
        for i in range(K):
            pos = base + i
            logits, _ = draft_model.forward(x[:, None], pos[:, None], state.draft_cache, pos)
            x = sample_tokens(logits[:, 0])
            drafts.append(x)
        d = torch.stack(drafts, dim=1)  # [B, K]

        # ---- 2. Verify: ONE forward over K+1 positions ----
        arange = torch.arange(K + 1, dtype=torch.int32, device=dev)[None, :]
        verify_in = torch.cat([last[:, None], d], dim=1)
        positions = base[:, None] + arange
        target_logits, _ = target_model.forward(verify_in, positions, state.target_cache, base)

        # ---- 3. Acceptance ----
        a = longest_prefix(d, target_logits).clamp(0, K)

        # ---- 4. Bonus token ----
        bonus_logits = target_logits[torch.arange(B, device=dev), a.long()]
        bonus = sample_tokens(bonus_logits)

        # ---- 5. Commit ----
        d_pad = torch.cat([d, d[:, -1:]], dim=1)  # [B, K+1]
        write_vals = torch.where(arange < a[:, None], d_pad, bonus[:, None])
        commit = a + 1
        if eos_token_id is not None:
            is_eos = (write_vals == eos_token_id) & (arange < commit[:, None])
            first_eos = torch.where(is_eos, arange, K + 1).amin(dim=1)
            commit = torch.where(is_eos.any(dim=1), first_eos + 1, commit)
        remaining = state.prompt_lens + state.max_new - state.lengths
        commit = torch.minimum(commit, remaining.clamp_min(0))
        commit = torch.minimum(commit, max_len - state.lengths - 1)
        commit = torch.where(state.active, commit, 0)

        new_tokens = _write_rows(state.tokens, write_vals, state.lengths, state.active)
        # Target log-prob of every written slot: row i of the verify logits is
        # the target distribution at write slot i.
        logz = torch.logsumexp(target_logits, dim=-1)  # [B, K+1]
        tok_logit = target_logits.gather(-1, write_vals[..., None].long())[..., 0]
        new_lp = _write_rows(state.token_logprobs, tok_logit - logz, state.lengths,
                             state.active)

        new_lengths = state.lengths + commit
        if eos_token_id is not None:
            hit_eos = ((write_vals == eos_token_id) & (arange < commit[:, None])).any(dim=1)
        else:
            hit_eos = torch.zeros_like(state.active)
        exhausted = (new_lengths - state.prompt_lens) >= state.max_new
        no_room = new_lengths + K + 1 > max_len  # next step writes K+1 rows
        act = state.active.to(torch.int32)
        return replace(
            state,
            tokens=new_tokens,
            lengths=new_lengths,
            active=state.active & ~hit_eos & ~exhausted & ~no_room,
            proposed=state.proposed + K * act,
            accepted=state.accepted + a * act,
            bonus=state.bonus + act,
            token_logprobs=new_lp,
            steps=_advance(state),
        )

    return _in_place(step) if in_place else step


def make_baseline_step(target_model: Model, *, eos_token_id: Optional[int] = None,
                       in_place: bool = False):
    """Non-speculative greedy step: forward the last token, take the argmax."""

    def step(state: DecodeState) -> DecodeState:
        max_len = state.tokens.shape[1]
        last = _gather_last(state.tokens, state.lengths)
        base = state.lengths - 1
        logits, _ = target_model.forward(last[:, None], base[:, None], state.target_cache, base)
        row = logits[:, 0].float()
        nxt = sample_tokens(row)
        commit = state.active.to(torch.int32)
        remaining = state.prompt_lens + state.max_new - state.lengths
        commit = torch.minimum(commit, remaining.clamp_min(0))
        new_tokens = _write_rows(state.tokens, nxt[:, None], state.lengths, state.active)
        lp = row.gather(-1, nxt[:, None].long())[:, 0] - torch.logsumexp(row, dim=-1)
        new_lp = _write_rows(state.token_logprobs, lp[:, None], state.lengths, state.active)
        new_lengths = state.lengths + commit
        if eos_token_id is not None:
            hit_eos = (nxt == eos_token_id) & (commit > 0)
        else:
            hit_eos = torch.zeros_like(state.active)
        exhausted = (new_lengths - state.prompt_lens) >= state.max_new
        no_room = new_lengths + 2 > max_len
        return replace(
            state,
            tokens=new_tokens,
            lengths=new_lengths,
            active=state.active & ~hit_eos & ~exhausted & ~no_room,
            bonus=state.bonus + commit,
            token_logprobs=new_lp,
            steps=_advance(state),
        )

    return _in_place(step) if in_place else step


def make_prefill(target_model: Model, draft_model: Optional[Model], chunk: Optional[int] = None):
    """Prompt prefill: populate both caches over the right-padded prompt
    block and score the prompt tokens (prompt logprobs) from the target
    logits. Junk KV rows beyond each prompt sit at positions the mask never
    reaches until they are overwritten.

    One forward over the whole block, or with `chunk` set and P > chunk
    (P a multiple of chunk) one forward per chunk of the block, in order
    (JAX's lax.scan over chunks is a Python loop here): chunk i's queries at
    positions i*chunk .. i*chunk + chunk - 1 attend to the rows the earlier
    chunks wrote and their own. Activations are then O(chunk) rows, and a
    rolling-buffer cache shorter than the prompt is written before it wraps
    past rows a query still needs. Row j of chunk i scores the prompt token
    at position i*chunk + j + 1."""

    def prefill(state: DecodeState, prompt_block: torch.Tensor,
                prompt_lens: torch.Tensor) -> DecodeState:
        B, P = prompt_block.shape
        dev = prompt_block.device
        lp_buf = state.token_logprobs.clone()
        C = chunk if chunk is not None and P > chunk else P
        if P % C:
            raise ValueError(f"prompt block of {P} is not a multiple of the chunk {C}")
        arange = torch.arange(C, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        for c0 in range(0, P, C):
            tok = prompt_block[:, c0:c0 + C]
            positions = c0 + arange
            start = torch.full((B,), c0, dtype=torch.int32, device=dev)
            lg, _ = target_model.forward(tok, positions, state.target_cache, start)
            if draft_model is not None:
                draft_model.forward(tok, positions, state.draft_cache, start)
            # Row j scores the next prompt token, 0 past the prompt; the last
            # row of the block has none: C - 1 rows score in the last chunk.
            n = min(C, P - 1 - c0)
            lg32 = lg[:, :n].float()
            nxt = prompt_block[:, c0 + 1:c0 + 1 + n, None].long()
            row_lp = lg32.gather(-1, nxt)[..., 0] - torch.logsumexp(lg32, dim=-1)
            lp_buf[:, c0 + 1:c0 + 1 + n] = torch.where(
                positions[:, :n] + 1 < prompt_lens[:, None], row_lp, 0.0)
        tokens = state.tokens.clone()
        tokens[:, :P] = prompt_block
        return replace(state, tokens=tokens, lengths=prompt_lens, prompt_lens=prompt_lens,
                       active=prompt_lens > 0, token_logprobs=lp_buf)

    return prefill


def _launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, and the forwards and layers run."""
    counts = {name: w.launches for name, w in kernel_wrappers().items()}
    counts["forwards"], counts["layers"] = transformer.forward.calls, transformer.forward.layers
    return counts


def _set_launch_counts(counts: Dict[str, int]) -> None:
    for name, w in kernel_wrappers().items():
        w.launches = counts[name]
    transformer.forward.calls, transformer.forward.layers = counts["forwards"], counts["layers"]


class DecodeLoop:
    """Port of llm_inference_lab_tpu/core/specstep.py ``make_decode_loop``:
    n decode steps over one fixed set of state tensors with no host read.

    ``loop(state, n)`` ties the loop to `state`'s tensors at its first call
    (``bind``) and refuses any other state. On the card it captures the
    in-place step once in a ``torch.cuda.CUDAGraph`` and replays the graph n
    times; on the CPU it runs the in-place step n times. JAX's loop stops
    when no lane is active: here a step after every lane finished changes
    nothing, so the caller picks n and polls between calls
    (core/engine.py, core/batching.py).

    The wrappers' launch counts see no replay. ``per_replay`` holds the
    kernel launches, forwards and layers of the captured step, ``replays``
    this loop's replays, and the class-wide ``replayed`` the sums of
    per_replay over every replay of every loop, with "replays" beside them.
    Where capture fails (a host read or a synchronisation inside the step)
    it raises: there is no eager fallback on the card."""

    replayed: Dict[str, int] = {}

    def __init__(self, step, pool=None):
        self.step = step  # in place
        self.pool = pool  # a graph pool handle, shared by the loops of one engine
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.bound: Optional[tuple] = None
        self.per_replay: Dict[str, int] = {}
        self.replays = 0
        self.capture_s: Optional[float] = None  # host seconds of the capture
        self.pool_bytes: Optional[int] = None  # memory the capture reserved

    @torch.inference_mode()
    def bind(self, state: DecodeState) -> None:
        """Tie the loop to state's tensors; on the card capture the step over
        them."""
        if self.bound is not None:
            raise ValueError("this decode loop is already bound to a state")
        if state.tokens.is_cuda:
            self._capture(state)
        self.bound = state_tensors(state)

    @torch.inference_mode()
    def __call__(self, state: DecodeState, n: int) -> DecodeState:
        if self.bound is None:
            self.bind(state)
        elif not all(a is b for a, b in zip(self.bound, state_tensors(state), strict=True)):
            raise ValueError("the decode loop was bound to another state's tensors")
        if state.tokens.is_cuda:
            self.replay(n)
        else:
            for _ in range(n):
                self.step(state)
        return state

    def replay(self, n: int) -> None:
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        tally = DecodeLoop.replayed
        for name, count in self.per_replay.items():
            tally[name] = tally.get(name, 0) + count * n
        tally["replays"] = tally.get("replays", 0) + n

    def _capture(self, state: DecodeState) -> None:
        dev = state.tokens.device
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph, pool=self.pool)
        side = capture.capture_stream
        fields = [getattr(state, name) for name in FIELDS]
        saved = [t.clone() for t in fields]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # Warm-up on the capture stream: every kernel's first launch (its
            # build and module load) and cuBLAS's workspace for this stream
            # happen here, not under capture. The fields then get their
            # values back; the step's cache rows land where the next step
            # writes the same rows before anything reads them.
            self.step(state)
            for t, v in zip(fields, saved):
                t.copy_(v)
        torch.cuda.synchronize(dev)
        del saved
        before = _launch_counts()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        try:
            with capture:
                self.step(state)
        except RuntimeError as err:
            _set_launch_counts(before)
            raise RuntimeError("capturing the decode step in a CUDA graph failed (a host read "
                               "or a synchronisation inside the step?)") from err
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = _launch_counts()
        self.per_replay = {name: after[name] - before[name] for name in after}
        _set_launch_counts(before)  # capturing launched nothing
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph


def make_decode_loop(step, pool=None) -> DecodeLoop:
    """The decode loop over an in-place step (make_spec_step or
    make_baseline_step with in_place=True); pool: a graph pool handle
    (torch.cuda.graph_pool_handle) its graph may share."""
    return DecodeLoop(step, pool)

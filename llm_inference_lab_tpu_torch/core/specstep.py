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
host: the decode loop in core/engine.py polls ``active.any()`` once per step.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from llm_inference_lab_tpu_torch.core.policies import longest_prefix
from llm_inference_lab_tpu_torch.core.state import DecodeState
from llm_inference_lab_tpu_torch.models.base import Model
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


def make_spec_step(target_model: Model, draft_model: Model, *, k: int,
                   eos_token_id: Optional[int] = None):
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
            steps=state.steps + 1,
        )

    return step


def make_baseline_step(target_model: Model, *, eos_token_id: Optional[int] = None):
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
            steps=state.steps + 1,
        )

    return step


def make_prefill(target_model: Model, draft_model: Optional[Model]):
    """Single-shot prompt prefill: populate both caches over the right-padded
    prompt block in one forward each, and score the prompt tokens (prompt
    logprobs) from the target logits. Junk KV rows beyond each prompt sit at
    positions the mask never reaches until they are overwritten."""

    def prefill(state: DecodeState, prompt_block: torch.Tensor,
                prompt_lens: torch.Tensor) -> DecodeState:
        B, P = prompt_block.shape
        dev = prompt_block.device
        positions = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        lg, _ = target_model.forward(prompt_block, positions, state.target_cache, zeros)
        if draft_model is not None:
            draft_model.forward(prompt_block, positions, state.draft_cache, zeros)
        lg32 = lg[:, :-1].float()
        row_lp = (lg32.gather(-1, prompt_block[:, 1:, None].long())[..., 0]
                  - torch.logsumexp(lg32, dim=-1))
        row_lp = torch.where(positions[:, 1:] < prompt_lens[:, None], row_lp, 0.0)
        lp_buf = state.token_logprobs.clone()
        lp_buf[:, 1:P] = row_lp
        tokens = state.tokens.clone()
        tokens[:, :P] = prompt_block
        return replace(state, tokens=tokens, lengths=prompt_lens, prompt_lens=prompt_lens,
                       active=prompt_lens > 0, token_logprobs=lp_buf)

    return prefill

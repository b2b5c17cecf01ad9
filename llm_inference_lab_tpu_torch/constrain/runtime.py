"""Device-side constrained-decoding runtime: token masks and FSM transitions
over the precompiled effect tables (jsonfsm.TokenTables), in torch.

Port of llm_inference_lab_tpu/constrain/runtime.py. Per-slot FSM state lives
in DecodeState:
  fsm_lex   [B] int32    — lexer state; -1 = slot unconstrained, -2 = dead
  fsm_stack [B, D] int32 — nesting symbols (SYM_OBJ/SYM_ARR), bottom-first
  fsm_sp    [B] int32    — stack height

``token_mask`` is two [B, V] gathers from the [S, V] tables plus MAX_POP
stack-tail compares; ``transition`` applies a chosen token's stack effect as
a masked [B, D] update. Everything is integer and boolean work on the
tables' device with no host read, so a CUDA graph captures it, and every
result equals JAX's exactly. JAX skips the mask at run time when no slot is
constrained (``lax.cond``); a graph cannot branch, so the port's engine
builds a constrained step beside the unconstrained one and the host, which
knows what it admitted, picks (core/engine.py, core/batching.py).

Soundness: a dead slot (a draft fed an invalid token during the verify
walk) masks everything but EOS, and acceptance can never commit past the
invalidating position because the masked target distribution gives it -inf.

``walk_tokens`` runs ``transition`` over a token list on the host tables:
the batcher restores a preempted request's FSM with it when the request is
readmitted by recompute (JAX resets it to the initial state there).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from llm_inference_lab_tpu_torch.constrain.jsonfsm import MAX_POP, MAX_PUSH, TokenTables

UNCONSTRAINED = -1
DEAD_STATE = -2
STACK_DEPTH = 32  # max JSON nesting per slot


def device_tables(tt: TokenTables, device) -> Dict[str, object]:
    """The effect tables on `device`, uploaded once and gathered from by every
    step: int16 states (schema DFAs exceed 127 states), int8 effects, bool
    accepting, the base-state -> top-conditioned row maps (int64 indices)."""

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return {
        "state_out": up(tt.state_out, torch.int16),  # [S_ext, V]
        "n_pop": up(tt.n_pop, torch.int8),
        "pop_syms": up(tt.pop_syms, torch.int8),  # [S_ext, V, MAX_POP]
        "n_push": up(tt.n_push, torch.int8),
        "push_syms": up(tt.push_syms, torch.int8),  # [S_ext, V, MAX_PUSH]
        "accepting": up(tt.accepting, torch.bool),  # [S_ext]
        "variant_obj": up(tt.variant_obj, torch.int64),  # [S_base]
        "variant_arr": up(tt.variant_arr, torch.int64),
        "eos_id": int(tt.eos_id),
        "initial": int(tt.initial),
        "initial_objonly": int(tt.initial_objonly),
    }


def table_bytes(tbl: Dict[str, object]) -> int:
    """Device bytes of the tables."""
    return sum(t.numel() * t.element_size() for t in tbl.values() if isinstance(t, torch.Tensor))


def _top(stack: torch.Tensor, sp: torch.Tensor, j: int) -> torch.Tensor:
    """stack[b, clamp(sp[b] - 1 - j, 0, D - 1)]: the symbol j below the top."""
    idx = (sp - 1 - j).clamp(0, stack.shape[1] - 1)
    return stack.gather(1, idx[:, None].long())[:, 0]


def effective_lex(tbl: Dict[str, object], lex: torch.Tensor, stack: torch.Tensor,
                  sp: torch.Tensor) -> torch.Tensor:
    """Row index [B] int64 to gather from: split states (',' routing consults
    the stack top) use their OBJ/ARR variant row when the slot's top symbol
    is known; everything else (and empty stacks) uses the base row."""
    S_base = tbl["variant_obj"].shape[0]
    lex_c = lex.clamp(0, S_base - 1).long()
    top = torch.where(sp > 0, _top(stack, sp, 0), 0)
    return torch.where(top == 1, tbl["variant_obj"][lex_c],
                       torch.where(top == 2, tbl["variant_arr"][lex_c], lex_c))


def token_mask(tbl: Dict[str, object], lex: torch.Tensor, stack: torch.Tensor,
               sp: torch.Tensor) -> torch.Tensor:
    """[B, V] bool: which tokens each slot's state may emit."""
    D = stack.shape[1]
    lex_c = effective_lex(tbl, lex, stack, sp)
    so = tbl["state_out"][lex_c]  # [B, V]
    n_pop = tbl["n_pop"][lex_c].int()
    n_push = tbl["n_push"][lex_c].int()
    pops = tbl["pop_syms"][lex_c]  # [B, V, MAX_POP]
    valid = (so >= 0) & (n_pop <= sp[:, None])
    for j in range(MAX_POP):
        valid &= (n_pop <= j) | (pops[..., j] == _top(stack, sp, j)[:, None])
    valid &= (sp[:, None] - n_pop + n_push) <= D
    # Dead slots (an invalid token slipped in through an unmasked draft)
    # emit nothing but EOS from here on.
    dead = lex == DEAD_STATE
    valid &= ~dead[:, None]
    # EOS: only when the text is a complete value, or the slot is dead or
    # starved (EOS then ends the stream instead of sampling garbage).
    eos = tbl["eos_id"]
    acc = (tbl["accepting"][lex_c] & (sp == 0)) | dead | ~valid.any(dim=-1)
    valid[:, eos] = acc
    # Unconstrained slots pass everything through.
    return valid | (lex == UNCONSTRAINED)[:, None]


def apply_mask(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """-inf out invalid tokens, in f32 (shapes broadcast: [B, V] or [B, K, V])."""
    return torch.where(mask, logits.float(), float("-inf"))


def transition(tbl: Dict[str, object], lex: torch.Tensor, stack: torch.Tensor,
               sp: torch.Tensor, tok: torch.Tensor,
               active: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance each slot's FSM by one committed token tok [B]. Total: an
    invalid token sends the slot to DEAD_STATE (the mask then gives EOS
    only); EOS in an accepting state is a no-op. Unconstrained and dead
    slots, and rows with active False, are unchanged."""
    D = stack.shape[1]
    V = tbl["state_out"].shape[1]
    lex_c = effective_lex(tbl, lex, stack, sp)
    tok_c = tok.clamp(0, V - 1).long()
    so = tbl["state_out"][lex_c, tok_c].int()
    n_pop = tbl["n_pop"][lex_c, tok_c].int()
    n_push = tbl["n_push"][lex_c, tok_c].int()
    pushes = tbl["push_syms"][lex_c, tok_c].int()  # [B, MAX_PUSH]
    pop_req = tbl["pop_syms"][lex_c, tok_c].int()  # [B, MAX_POP]
    ok = (so >= 0) & (n_pop <= sp)
    for j in range(MAX_POP):
        ok &= (n_pop <= j) | (pop_req[:, j] == _top(stack, sp, j))
    is_eos = tok == tbl["eos_id"]
    eos_ok = is_eos & tbl["accepting"][lex_c] & (sp == 0)

    base = sp - n_pop
    rel = torch.arange(D, dtype=torch.int32, device=stack.device)[None, :] - base[:, None]
    write = (rel >= 0) & (rel < n_push[:, None])
    val = pushes.gather(1, rel.clamp(0, MAX_PUSH - 1).long())
    new_stack = torch.where(write, val, stack)
    new_sp = (base + n_push).clamp(0, D)
    new_lex = torch.where(ok, so, DEAD_STATE)
    new_lex = torch.where(eos_ok, lex, new_lex)
    moved = ok & ~is_eos
    new_stack = torch.where(moved[:, None], new_stack, stack)
    new_sp = torch.where(moved, new_sp, sp)

    frozen = lex < 0  # unconstrained or already dead
    if active is not None:
        frozen = frozen | ~active
    return (torch.where(frozen, lex, new_lex).to(lex.dtype),
            torch.where(frozen[:, None], stack, new_stack).to(stack.dtype),
            torch.where(frozen, sp, new_sp).to(sp.dtype))


def walk_window(tbl: Dict[str, object], lex: torch.Tensor, stack: torch.Tensor,
                sp: torch.Tensor, toks: torch.Tensor):
    """FSM states BEFORE each of the K+1 verify positions, walking the draft
    window toks [B, K]: (lexs [B, K+1], stacks [B, K+1, D], sps [B, K+1])."""
    lexs, stacks, sps = [lex], [stack], [sp]
    for i in range(toks.shape[1]):
        lex, stack, sp = transition(tbl, lex, stack, sp, toks[:, i])
        lexs.append(lex)
        stacks.append(stack)
        sps.append(sp)
    return torch.stack(lexs, 1), torch.stack(stacks, 1), torch.stack(sps, 1)


def window_mask(tbl: Dict[str, object], lexs: torch.Tensor, stacks: torch.Tensor,
                sps: torch.Tensor) -> torch.Tensor:
    """[B, K1, V] masks for every walked position (flattened batch)."""
    B, K1 = lexs.shape
    m = token_mask(tbl, lexs.reshape(B * K1), stacks.reshape(B * K1, -1), sps.reshape(B * K1))
    return m.reshape(B, K1, -1)


def init_fsm(B: int):
    """Unconstrained initial FSM arrays (host numpy)."""
    return (np.full((B,), UNCONSTRAINED, np.int32), np.zeros((B, STACK_DEPTH), np.int32),
            np.zeros((B,), np.int32))


def walk_tokens(tbl: Dict[str, object], lex: int,
                tokens: Iterable[int]) -> Tuple[int, np.ndarray, int]:
    """One slot's FSM after committing `tokens` from state `lex` with an
    empty stack: ``transition`` token by token over `tbl` (device_tables on
    the CPU share the host arrays). Returns (lex, stack [STACK_DEPTH] int32,
    sp)."""
    state = (torch.tensor([lex], dtype=torch.int32),
             torch.zeros((1, STACK_DEPTH), dtype=torch.int32),
             torch.zeros((1,), dtype=torch.int32))
    for tok in tokens:
        state = transition(tbl, *state, torch.tensor([int(tok)], dtype=torch.int32))
    return int(state[0][0]), state[1][0].numpy(), int(state[2][0])

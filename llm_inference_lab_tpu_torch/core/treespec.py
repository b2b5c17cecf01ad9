"""Tree speculation: verify a tree of draft candidates in one forward.

Port of llm_inference_lab_tpu/core/treespec.py (``TreeConfig``,
``make_tree_spec_step``). The draft is a static tree (branching factors per
depth, e.g. [3, 2]: 3 children of the last committed token, 2 of each of
those, 9 nodes), drafted by Medusa heads over the target's hidden-state
carry: the node at depth d and branch rank c takes head d-1's c-th most
likely token (one head call over the [B * depth, D] head inputs). The
target verifies every root-to-leaf path in ONE forward over
[last_committed, node_1 .. node_N]: node i is written at cache slot base + i
but attends by ancestry (the tree mask; kernels D and F's tree variant on
the card) at logical position base + depth(i). Acceptance walks the depths
greedily, taking at each the first child whose token is the target's argmax
at its parent; the bonus comes from the deepest accepted node's row. Commit
writes the accepted path and the bonus, and compacts the accepted nodes' KV
rows from their tree slots to the contiguous slots base + 1 .. base + a
that the cache invariant expects (a gather into a temporary, then the
scatter: a source slot is never before its destination, so the two
overlap), scales included for int8, through the page table for a paged
cache. The carry becomes the deepest accepted node's hidden row.

As the chain step (core/specstep.py), the step never reads a value back to
the host, comes functional or in place (``in_place=True``, which
``make_decode_loop`` captures in a CUDA graph), advances ``steps`` and the
key only when a lane is active, and commits nothing on an inactive lane.
Greedy decoding or the engine's sampling for the bonus token; with
per_request_sampling each slot's logit_bias on every verify row before the
walk and the bonus drawn under each row's own filters and key (JAX
treespec.py:185-236); the top-N capture from the rows that predicted each
written token (logprobs_topk). The tree takes no penalties (config.py and
the batcher refuse them, as JAX's engine does).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from llm_inference_lab_tpu_torch.core.specstep import (
    _BONUS,
    _advance,
    _Controls,
    _gather_last,
    _in_place,
    _next_key,
    _top_n,
    _write_rows,
    hidden_carry,
)
from llm_inference_lab_tpu_torch.core.state import DecodeState
from llm_inference_lab_tpu_torch.models.base import Model
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache
from llm_inference_lab_tpu_torch.ops.sampling import fold, sample_tokens


@dataclass(frozen=True)
class TreeConfig:
    """Static tree topology from per-depth branching factors. Node 0 is the
    root (the last committed token, depth 0); proposal nodes are 1..N in
    breadth-first order."""

    branching: Tuple[int, ...] = (3, 2)

    @property
    def depth(self) -> int:
        return len(self.branching)

    @property
    def num_nodes(self) -> int:  # proposal nodes (excluding the root)
        n, level = 0, 1
        for b in self.branching:
            level *= b
            n += level
        return n

    def build(self):
        """(parent [N+1], depth [N+1], branch_rank [N+1], ancestor_mask
        [N+1, N+1]) as numpy arrays; ancestor_mask[i, j] is True iff j is i
        or an ancestor of i (what node i may attend to within the chunk)."""
        parents, depths, ranks, prev_level = [-1], [0], [0], [0]
        for d, b in enumerate(self.branching, start=1):
            level = []
            for p in prev_level:
                for c in range(b):
                    parents.append(p)
                    depths.append(d)
                    ranks.append(c)
                    level.append(len(parents) - 1)
            prev_level = level
        n = len(parents)
        anc = np.zeros((n, n), bool)
        for i in range(n):
            j = i
            while j != -1:
                anc[i, j] = True
                j = parents[j]
        return (np.array(parents, np.int32), np.array(depths, np.int32),
                np.array(ranks, np.int32), anc)


def _compact(cache, take_from: torch.Tensor, dst: torch.Tensor) -> None:
    """Every layer's KV rows (and int8 scales) at slots take_from [B, n] to
    slots dst [B, n] of their lanes, in place: gathered first, so a source
    that is another entry's destination is read before it is written. A
    contiguous cache's slots clip to its length, as the forward's write
    does (the engine's headroom keeps every active lane inside it); a paged
    cache's page ordinals clip to the table width, as JAX's compact_paged
    does."""
    tensors = [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]
    if isinstance(cache, PagedKVCache):
        P, M = cache.page_size, cache.table.shape[1]

        def where(slots):
            ordinal = torch.div(slots, P, rounding_mode="floor").clamp(0, M - 1).long()
            return cache.table.long().gather(1, ordinal), torch.remainder(slots, P).long()

        (sp, so), (dp, do) = where(take_from), where(dst)
        src_idx, dst_idx = (slice(None), sp, slice(None), so), (slice(None), dp, slice(None), do)
    else:
        T = cache.k.shape[3]
        lanes = torch.arange(dst.shape[0], device=dst.device)[:, None]
        src_idx = (slice(None), lanes, slice(None), take_from.clamp(0, T - 1).long())
        dst_idx = (slice(None), lanes, slice(None), dst.clamp(0, T - 1).long())
    for t in tensors:
        t[dst_idx] = t[src_idx]  # the right side is a copy: gather, then scatter


def make_tree_spec_step(target_model: Model, tree: TreeConfig, *, draft_params: dict,
                        greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
                        top_p: float = 1.0, min_p: float = 0.0,
                        eos_token_id: Optional[int] = None,
                        per_request_sampling: bool = False, logprobs_topk: int = 0,
                        in_place: bool = False):
    """Build step(state) -> state for tree speculation. draft_params:
    {"medusa_proj": [>= depth, D, D]} (head d drafts depth d+1). The tree's
    verify chunk is num_nodes + 1 rows, which the card's attention takes up
    to 32. per_request_sampling: each slot's logit_bias on the verify rows,
    the bonus under each row's filters from its key at site num_nodes."""
    D_tree = tree.depth
    parents_np, depths_np, ranks_np, anc_np = tree.build()
    N = tree.num_nodes
    S = N + 1
    max_branch = max(tree.branching)
    proj = draft_params.get("medusa_proj")
    if proj is None or proj.shape[0] < D_tree:
        raise ValueError(f"a tree of depth {D_tree} needs draft_params['medusa_proj'] with at "
                         f"least {D_tree} heads")
    dev = proj.device
    compute_dtype = target_model.config.dtype
    stochastic = not (greedy or temperature <= 0.0)
    samp = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p, greedy=greedy)
    # Per-request: the bias and the rows' keys; no penalties (1, 0, 0).
    ctl = _Controls(target_model.config.vocab_size, per_request_sampling, penalize=False)
    # The tree's constants on the device, made once (a captured step may
    # not copy from the host).
    parents = torch.from_numpy(parents_np).long().to(dev)
    node_depth = torch.from_numpy(depths_np[1:]).long().to(dev)
    node_rank = torch.from_numpy(ranks_np[1:]).long().to(dev)
    depths = torch.from_numpy(depths_np).to(dev)
    anc_mask = torch.from_numpy(anc_np).to(dev)
    children = [torch.from_numpy(np.nonzero(depths_np == d)[0]).long().to(dev)
                for d in range(1, D_tree + 1)]
    jdx = torch.arange(D_tree + 1, dtype=torch.int32, device=dev)[None]  # [1, D+1]

    def step(state: DecodeState) -> DecodeState:
        B, max_len = state.tokens.shape
        lane = torch.arange(B, device=dev)
        last = _gather_last(state.tokens, state.lengths)
        base = state.lengths - 1

        # ---- 1. Draft the tree: heads' top-max_branch, one head call ----
        h = state.last_hidden.to(compute_dtype)  # [B, D]
        inputs = torch.matmul(h, proj[:D_tree].to(compute_dtype)).transpose(0, 1)  # [B, Dt, D]
        logits = target_model.head(inputs.reshape(B * D_tree, -1)).reshape(B, D_tree, -1)
        cand = torch.topk(logits, max_branch, dim=-1).indices.to(torch.int32)  # [B, Dt, mb]
        node_tokens = cand[:, node_depth - 1, node_rank]  # [B, N]

        # ---- 2. Verify: ONE forward over the whole tree ----
        verify_in = torch.cat([last[:, None], node_tokens], dim=1)  # [B, S]
        positions = base[:, None] + depths[None]  # logical positions, by depth
        target_logits, _, hidden = target_model.forward(
            verify_in, positions, state.target_cache, base, return_hidden=True,
            tree_mask=anc_mask)
        ctx = ctl.context(state)
        target_logits = ctl.apply(state, ctx, target_logits, None)

        # ---- 3. Acceptance: walk the deepest matching path ----
        tgt_ids = torch.argmax(target_logits, dim=-1).to(torch.int32)  # [B, S]
        cur = torch.zeros((B,), dtype=torch.long, device=dev)  # accepted node (root 0)
        alive = torch.ones((B,), dtype=torch.bool, device=dev)
        a = torch.zeros((B,), dtype=torch.int32, device=dev)
        path_nodes = []
        for ids in children:
            is_child = parents[ids][None] == cur[:, None]  # [B, n_d]
            want = tgt_ids.gather(1, cur[:, None])  # [B, 1]
            match = is_child & (verify_in[:, ids] == want)
            pick = torch.argmax(match.to(torch.int8), dim=1)  # the first match
            alive = alive & match.any(dim=1)
            cur = torch.where(alive, ids[pick], cur)
            a = a + alive.to(torch.int32)
            path_nodes.append(cur)
        path = torch.stack(path_nodes, 1)  # [B, Dt]: node at depth j+1 (stale past a)

        # ---- 4. Bonus from the deepest accepted node's row ----
        bonus_logits = target_logits[lane, cur].float()
        if per_request_sampling:
            bonus = sample_tokens(None, bonus_logits, **ctl.row_samp(state, ctx, N))
        else:
            bonus = sample_tokens(fold(state.rng, _BONUS) if stochastic else None,
                                  bonus_logits, **samp, row0=state.row0)

        # ---- 5. Commit: tokens, logprobs, KV compaction, the carry ----
        path_tokens = verify_in.gather(1, path)  # [B, Dt]
        padded = torch.cat([path_tokens, path_tokens[:, -1:]], dim=1)  # [B, Dt+1]
        write_vals = torch.where(jdx < a[:, None], padded, bonus[:, None])
        commit = a + 1
        if eos_token_id is not None:
            is_eos = (write_vals == eos_token_id) & (jdx < commit[:, None])
            first_eos = torch.where(is_eos, jdx, D_tree + 1).amin(dim=1)
            commit = torch.where(is_eos.any(dim=1), first_eos + 1, commit)
        remaining = state.prompt_lens + state.max_new - state.lengths
        commit = torch.minimum(commit, remaining.clamp_min(0))
        commit = torch.minimum(commit, max_len - state.lengths - 1)
        commit = torch.where(state.active, commit, 0)
        new_tokens = _write_rows(state.tokens, write_vals, state.lengths, state.active)

        # Write slot j's token was predicted by the row of its parent on the
        # path: the root's for j = 0, path[:, j-1] after (the bonus's row is
        # cur, where the path froze).
        pred_rows = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev), path], dim=1)
        rows_lp = target_logits[lane[:, None], pred_rows]  # [B, Dt+1, V]
        logz = torch.logsumexp(rows_lp, dim=-1)
        tok_logit = rows_lp.gather(-1, write_vals[..., None].long())[..., 0]
        new_lp = _write_rows(state.token_logprobs, tok_logit - logz, state.lengths,
                             state.active)
        tops = _top_n(state, rows_lp, logz, logprobs_topk)

        # Accepted node j (tree slot base + path[:, j]) moves to slot
        # base + 1 + j; past a the row at the destination stays (a no-op).
        dst = base[:, None] + jdx[:, 1:]
        take_from = torch.where(jdx[:, 1:] <= a[:, None], base[:, None] + path, dst)
        _compact(state.target_cache, take_from, dst)

        new_lengths = state.lengths + commit
        if eos_token_id is not None:
            hit_eos = ((write_vals == eos_token_id) & (jdx < commit[:, None])).any(dim=1)
        else:
            hit_eos = torch.zeros_like(state.active)
        exhausted = (new_lengths - state.prompt_lens) >= state.max_new
        no_room = new_lengths + S + 1 > max_len  # the next step writes S rows
        act = state.active.to(torch.int32)
        return replace(
            state,
            tokens=new_tokens,
            lengths=new_lengths,
            active=state.active & ~hit_eos & ~exhausted & ~no_room,
            proposed=state.proposed + N * act,
            accepted=state.accepted + a * act,
            bonus=state.bonus + act,
            token_logprobs=new_lp,
            steps=_advance(state),
            rng=_next_key(state) if stochastic else state.rng,
            **hidden_carry(state, hidden[lane, cur].float()),
            **tops,
        )

    return _in_place(step) if in_place else step

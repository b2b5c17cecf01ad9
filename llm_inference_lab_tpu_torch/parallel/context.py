"""Context (sequence) parallelism: ring attention for the long-prompt
prefill (port of llm_inference_lab_tpu/parallel/context.py).

The sequence axis of Q, K and V is split over the mesh's seq axis: each rank
keeps its S / n query rows resident and the K/V blocks hop i -> i + 1
around the seq group, so at step t rank i holds the block that started on
rank (i - t) mod n. Masking is by absolute position (rank i's rows sit at
[i S/n, (i + 1) S/n)), so a block wholly in a row's future contributes
nothing.

JAX accumulates an online softmax over the blocks in f32. The port runs each
block through kernel E's shard variant (ops/flash_prefill.py
flash_prefill_shard: the rows against the keys of positions [t0, t0 + S/n),
out and log-sum-exp in f32) and merges the n blocks' rows by log-sum-exp
in ascending block order (ops/flash_decode.py merge_shards): the same
softmax, summed in another order. JAX's loop makes n hops, the last one
restoring the blocks' placement; the port makes n - 1 (the last hop's block
is never attended), which changes no result. Each hop sends K and V in one
buffer.

Two layers, as in JAX:

  ring_attention_shard(q, k, v, group, lengths)  - the per-rank body: this
      rank's rows, K/V rotating over the AxisGroup of the seq axis.
  ring_self_attention(q, k, v, mesh, axis, lengths) - globally shaped
      [B, S, H, D] arrays on every rank; S must divide by the axis; each
      rank runs its rows and the rows are gathered back.

The prefill of Engine.generate under a seq axis runs every layer's attention
through ring_attention_shard (models/transformer.py, cp) and writes, as each
block passes, the block's rows that fall in the rank's slice of the
T-split cache (``on_block``): the ring already carries every row to every
rank, so the cache writes need no traffic of their own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from llm_inference_lab_tpu_torch.ops.flash_decode import merge_shards
from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill_shard


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                         lengths: Optional[torch.Tensor] = None,
                         on_block: Optional[Callable] = None) -> torch.Tensor:
    """This rank's ring attention. q [B, S, H, D], k, v [B, S, KVH, D]: the
    rank's sequence shard (rows at absolute positions [r S, (r + 1) S), r
    its index on the seq group, an AxisGroup of parallel/mesh.py). lengths
    [B]: the global valid lengths (keys at positions >= length are dead;
    None: all valid). on_block(src, k_blk, v_blk): called with each block
    the rank holds ([B, S, KVH, D] views, src the rank it started on).
    Returns the causal attention of the rank's rows, [B, S, H, D] in q's
    dtype."""
    n, me = group.size, group.rank
    B, S, H, D = q.shape
    q_pos = me * S + torch.arange(S, dtype=torch.int32, device=q.device)
    q_pos = q_pos[None].expand(B, S)
    if lengths is not None:
        # Keys at positions >= length are dead: a row at p sees [0, min(p,
        # length - 1)].
        q_pos = torch.minimum(q_pos, lengths.to(torch.int32)[:, None] - 1)
    q_pos = q_pos.contiguous()
    q = q.contiguous()
    # K and V as [2, B, KVH, S, D] planes: one buffer a hop.
    blk = torch.stack([k.transpose(1, 2), v.transpose(1, 2)]).contiguous()
    parts = [None] * n
    for t in range(n):
        src = (me - t) % n
        if on_block is not None:
            on_block(src, blk[0].transpose(1, 2), blk[1].transpose(1, 2))
        parts[src] = flash_prefill_shard(q, blk[0], blk[1], q_pos, src * S)
        if t < n - 1:
            blk = group.ring_pass(blk)
    out, _ = merge_shards(torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts]))
    return out.to(q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                        axis: str = "seq", lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Context-parallel causal self-attention over globally shaped inputs on
    every rank: q [B, S, H, D], k, v [B, S, KVH, D]; S must divide by
    mesh.shape[axis]. Each rank runs its S / n rows through the ring and the
    ranks' rows are gathered: [B, S, H, D] on every rank."""
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError(f"seq len {q.shape[1]} not divisible by {axis}={n}")
    group = mesh.axis(axis)
    per = q.shape[1] // n
    rows = slice(group.rank * per, (group.rank + 1) * per)
    out = ring_attention_shard(q[:, rows], k[:, rows], v[:, rows], group, lengths)
    return group.all_gather(out, dim=1)

"""Pipeline parallelism: layer stages over the mesh's stage axis (port of
llm_inference_lab_tpu/parallel/pipeline.py forward_pp).

GPipe, as JAX schedules it:
  - Stage s holds layers [s L/S, (s+1) L/S) of the target and the same
    layers of its cache (parallel/sharding.py slices the stacked leaves and
    the rank's config says n_layers = L / S from layer0 = s L / S).
  - The embedding and the head stay outside the loop, whole on every stage
    (stage 0 embeds; every stage computes the head).
  - The batch splits into M microbatches (_pick_microbatches) and the loop
    runs M + S - 1 ticks: at tick t stage s runs microbatch t - s. Stage 0
    takes its rows of the embedding, every later stage receives them from
    stage s - 1 (send/recv), and the last stage banks them.
  - The last stage's final-normed rows are broadcast to every stage, so
    every stage computes the same logits and ids.

JAX runs the schedule as one program (a scan over ticks, a ppermute a tick)
and computes garbage rows on a stage's idle ticks, keeping their KV out of
the cache. Here a stage does nothing on an idle tick (so nothing is
written), and the same tick loop on every rank keeps every send matched by
its receive: stage s sends microbatch i at tick i + s and stage s + 1
receives it at tick i + s + 1. A stage's layers run as the one-process
forward runs them (models/transformer.py run_layers), so a pipeline moves
bits between processes and changes no sum. The stage axis composes with the
data axis (each data row its own pipeline) and with the model axis (a
stage's layers keep their Megatron shards and its model group's
collectives).

JAX's forward_pp skips Gemma's embedding scale and Gemma-2's sandwich norms
and window gate, which its unpipelined forward applies; the port's stages
run the forward's own layers, so every family computes what it computes in
one process.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from llm_inference_lab_tpu_torch.models import transformer
from llm_inference_lab_tpu_torch.models.base import KVCache
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache


def _pick_microbatches(batch_local: int, n_stages: int, requested: Optional[int]) -> int:
    """Largest divisor of the local batch <= requested (default: the local
    batch itself, microbatches of one row, the smallest bubble)."""
    m = min(requested or batch_local, batch_local)
    while batch_local % m:
        m -= 1
    return max(m, 1)


def _rows(cache: KVCache, rows: slice) -> KVCache:
    """The cache of a microbatch's rows: views, written in place."""
    def part(t):
        return None if t is None else t[:, rows]

    return KVCache(part(cache.k), part(cache.v), part(cache.k_scale), part(cache.v_scale),
                   cache.t0)


def forward_pp(cfg, params: Any, tokens: torch.Tensor, positions: torch.Tensor, cache,
               cache_lens: torch.Tensor, return_hidden: bool = False,
               tree_mask: Optional[torch.Tensor] = None,
               lora_ids: Optional[torch.Tensor] = None, logits: bool = True, cp: bool = False):
    """models/transformer.py forward's contract under a stage axis (cfg a
    RankConfig with ``pp``; params and cache this stage's layers): (logits
    [B, S, V] f32, cache) and with return_hidden the final-normed rows,
    every stage the same. JAX's refusals: the ring prefill (cp), the tree
    and a paged cache."""
    if cp:
        raise NotImplementedError("ring-attention prefill under pipeline parallelism is not "
                                  "supported")
    if tree_mask is not None:
        raise NotImplementedError("tree speculation under pipeline parallelism is not supported")
    if isinstance(cache, PagedKVCache):
        raise NotImplementedError("paged KV under pipeline parallelism is not supported")
    pp = cfg.pp
    n_stages, s = pp.size, pp.rank
    B, S = tokens.shape
    M = _pick_microbatches(B, n_stages, cfg.pp_microbatches)
    mb = B // M
    x = transformer.embed(cfg, params, tokens, positions) if s == 0 else None
    like = torch.empty((mb, S, cfg.d_model), dtype=cfg.dtype, device=tokens.device)
    last = s == n_stages - 1
    hidden = torch.empty((B, S, cfg.d_model), dtype=cfg.dtype, device=tokens.device)
    for t in range(M + n_stages - 1):
        i = t - s  # this stage's microbatch at tick t
        if not 0 <= i < M:
            continue  # an idle tick: nothing runs, nothing is written
        rows = slice(i * mb, (i + 1) * mb)
        # A microbatch through this stage's layers is a forward of them.
        forward_pp.calls += 1
        transformer.forward.calls += 1
        transformer.forward.layers += cfg.n_layers
        inp = x[rows] if s == 0 else pp.recv_prev(like)
        ctx = transformer.context(cfg, params, tokens[rows], positions[rows], _rows(cache, rows),
                                  cache_lens[rows], lora_ids=None)
        h, n = transformer.run_layers(cfg, params, inp, ctx, final_norm=last)
        if last:
            hidden[rows] = n
        else:
            pp.send_next(h)
    hidden = pp.broadcast_last(hidden)
    out = transformer.lm_head_logits(cfg, params, hidden) if logits else None
    if return_hidden:
        return out, cache, hidden
    return out, cache


forward_pp.calls = 0  # the microbatches this rank's stage has run through its layers

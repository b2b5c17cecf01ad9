"""Speculative-decoding step, baseline step and prefill.

Port of llm_inference_lab_tpu/core/specstep.py (``make_spec_step``,
``make_baseline_step``, ``make_prefill``, ``make_decode_loop``) for vanilla
drafting from a draft model, ngram drafting from the token buffer and
Medusa-lite and EAGLE-lite drafting from the target's hidden state, the
five acceptance policies (core/policies.py), greedy decoding or
engine-level sampling (ops/sampling.py), a fixed K or the device-side
adaptive K. (Tree speculation's step is core/treespec.py's.) Per spec step:

  1. Draft K tokens: K single-token draft forwards (vanilla), or the
     continuation of the last earlier occurrence of the last n committed
     tokens (ngram: no draft model, no draft cache), or the target's own
     head over K inputs made from its hidden-state carry, in ONE head call
     of [B * K, D] rows (medusa: K projections of the carry; eagle: the
     carry extrapolated K times).
  2. Verify with ONE target forward over [last_committed, d_1..d_K]: K+1
     logit rows.
  3. Acceptance: accept_len a in [0, K] per sequence, from the policy.
  4. Bonus token from target row a (or, under ``rejection``, from the
     residual distribution): covers the partial-accept bonus, the
     all-accepted bonus and the all-rejected fallback alike.
  5. Commit: write a+1 tokens, advance lengths, truncate at EOS and at the
     budget, deactivate finished lanes. KV "rollback" is just not advancing
     the length. In the head modes the verify row a's hidden state (the one
     that predicted the bonus) becomes ``last_hidden``, and the old one
     ``prev_hidden``, on active lanes.

The steps are plain functions of tensors that never read a value back to the
host. A step advances ``steps`` by ``active.any()`` and commits nothing on an
inactive lane, so a step run after every lane finished changes no field (JAX's
while_loop runs no body then). A step that draws random numbers advances the
state's key (``rng``) the same way: its draws are a hash of the key, so every
replay of a captured step draws anew. Each step comes in two forms:
functional (a new state; core/engine.py's host loop under
``EnvFlags(sync_steps=True)``) and in place (``in_place=True``: the results
written into the state's own tensors), which ``make_decode_loop`` captures in
a CUDA graph and replays.

A step built with a grammar's tables (``constrain_tbl``, constrain/runtime.py
``device_tables``) masks every sampling site and advances each slot's FSM by
what it commits, as JAX's does: the draft rows (where the draft shares the
target's vocabulary), the verify rows over the FSM walked through the draft
window (the soundness guarantee: an invalid token gets -inf before
acceptance and the bonus), and the baseline's row, each after penalties and
logit_bias. JAX skips the mask at run time when no slot is constrained; a
graph cannot branch, so the engine builds this step beside the
unconstrained one and the host picks.

Every target forward (the verify, the baseline's, the prefill's) takes the
state's ``lora_ids``: with a LoRA pack in the target's params each row adds
its slot's adapter delta (JAX specstep.py passes them to the same
forwards). Draft forwards stay on the base model; Medusa and EAGLE draft
from the adapted target's hidden state.
"""

from __future__ import annotations

import gc
import time
from dataclasses import replace
from typing import Callable, Dict, Optional

import torch

from llm_inference_lab_tpu_torch.constrain import runtime as fsm
from llm_inference_lab_tpu_torch.core import policies
from llm_inference_lab_tpu_torch.core.state import FIELDS, DecodeState, assign, state_tensors
from llm_inference_lab_tpu_torch.models import transformer
from llm_inference_lab_tpu_torch.models.base import Model, cache_slots
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache, page_slots
from llm_inference_lab_tpu_torch.ops import kernel_wrappers
from llm_inference_lab_tpu_torch.ops.sampling import (
    apply_penalties,
    fold,
    fold_rows,
    logit_bias_row,
    sample_tokens,
    token_counts,
)

# Sites of the step's keys, folded into the state's key (JAX splits it into
# these four): the next step's key, the draft positions', the policy's and
# the bonus token's.
_NEXT, _DRAFT, _POLICY, _BONUS = range(4)


def _gather_last(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """tokens[b, lengths[b]-1]: the last committed token per sequence."""
    idx = (lengths - 1).clamp_min(0).long()
    return tokens.gather(1, idx[:, None])[:, 0]


def _write_rows(buf: torch.Tensor, vals: torch.Tensor, start: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """buf[b, start[b] : start[b]+n] = vals[b] for active rows, with the start
    clamped so the block fits (dynamic_update_slice semantics); trailing
    dims (the top-N buffers' N) ride along."""
    n = vals.shape[1]
    start = start.clamp(0, buf.shape[1] - n)
    idx = start[:, None].long() + torch.arange(n, device=buf.device)[None]
    trail = (1,) * (buf.ndim - 2)
    written = buf.scatter(1, idx.reshape(idx.shape + trail).expand(vals.shape),
                          vals.to(buf.dtype))
    return torch.where(active.reshape(active.shape + (1,) + trail), written, buf)


def _top_n(state: DecodeState, logits: torch.Tensor, logz: torch.Tensor, n: int) -> dict:
    """The top-N capture at commit (JAX's logprobs_topk): the n largest
    logits [B, S, V] of each write slot, as ids and log-probs (minus logz
    [B, S]), written from each active lane's length; nothing when n is 0."""
    if not n:
        return {}
    vals, ids = torch.topk(logits, n, dim=-1)
    lps = vals - logz[..., None]
    return dict(top_ids=_write_rows(state.top_ids, ids.to(torch.int32), state.lengths,
                                    state.active),
                top_lps=_write_rows(state.top_lps, lps, state.lengths, state.active))


class _Controls:
    """The per-request and penalty path of a step (JAX make_spec_step's
    ``sctx``, ``_ctx_penalize`` and ``_draft_samp``): penalties (static
    engine values, or each slot's under per_request_sampling) and each
    slot's logit_bias, applied before temperature and the filters, and the
    sampling settings of each site. Per-request rows draw from their slot's
    key folded with their committed length and the site (the draft position
    i, K for the bonus), so a request's stream depends on its own seed,
    prompt and parameters only.

    Everything is branch-free (JAX skips the counts and the bias with
    lax.cond when no slot uses them; a captured graph cannot branch on the
    host): at the off values the arithmetic leaves every logit as it is
    (x / 1, x * 1, x - 0 - 0, x + 0)."""

    def __init__(self, vocab: int, per_request: bool, penalties: tuple = (1.0, 0.0, 0.0),
                 draft_vocab_ok: bool = True, penalize: bool = True):
        self.V = vocab
        self.per_request = per_request
        self.static_pen = penalties
        self.use_pen = penalize and (per_request or penalties != (1.0, 0.0, 0.0))
        self.use_bias = per_request
        # Counts and bias rows are indexed by the target's ids: a draft of
        # another vocabulary proposes unpenalized (static penalties refuse
        # it, as JAX's do).
        self.draft_ok = draft_vocab_ok
        if self.use_pen and not per_request and not draft_vocab_ok:
            raise ValueError("penalties need draft and target to share a vocabulary")

    @property
    def active(self) -> bool:
        return self.use_pen or self.use_bias

    def context(self, state: DecodeState) -> dict:
        """What a step computes once: [B, V] counts of the committed text,
        the [B, V] bias row and the rows' keys at this length."""
        ctx = {}
        if self.per_request:
            ctx["row_keys"] = fold(state.slot_rng, state.lengths.long())
        if self.use_pen:
            ctx["counts"] = token_counts(state.tokens, state.lengths, self.V)
        if self.use_bias:
            ctx["bias"] = logit_bias_row(state.bias_ids, state.bias_vals, self.V)
        return ctx

    def penalties(self, state: DecodeState) -> tuple:
        if self.per_request:
            return state.rep_penalty, state.presence_penalty, state.freq_penalty
        return self.static_pen

    def apply(self, state: DecodeState, ctx: dict, logits: torch.Tensor, counts,
              draft_side: bool = False) -> torch.Tensor:
        """Penalties with `counts` ([B, V] or [B, S, V]) and then the bias,
        on logits [B, V] or [B, S, V], in f32."""
        if not self.active or (draft_side and not self.draft_ok):
            return logits
        x = logits.float()
        if self.use_pen:
            x = apply_penalties(x, counts, *self.penalties(state))
        if self.use_bias:
            bias = ctx["bias"]
            x = x + (bias[:, None] if x.ndim == 3 else bias)
        return x

    def bump(self, counts: Optional[torch.Tensor], tok: torch.Tensor) -> Optional[torch.Tensor]:
        """counts after each row commits tok [B] (the draft's incremental
        counts)."""
        if not self.use_pen:
            return counts
        return counts.scatter_add(1, tok[:, None].long(), torch.ones_like(counts[:, :1]))

    def window_counts(self, counts: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """[B, K+1, V]: row i counts the committed text and d_1..d_i (JAX's
        exclusive cumsum of one_hot(d)), the counts each verify row's write
        slot has seen."""
        B, K = d.shape
        dev = d.device
        before = (torch.arange(K, device=dev)[None, None, :]
                  < torch.arange(K + 1, device=dev)[None, :, None]).to(counts.dtype)
        return counts[:, None].expand(B, K + 1, self.V).contiguous().scatter_add_(
            2, d[:, None, :].expand(B, K + 1, K).long(), before.expand(B, K + 1, K))

    def row_samp(self, state: DecodeState, ctx: dict, site: Optional[int],
                 temp_scale: float = 1.0):
        """sample_tokens' keyword arguments for the rows at `site` (None: the
        rows' keys as they are, the baseline's one site): each slot's filters
        (its temperature / temp_scale) and keys."""
        keys = ctx["row_keys"] if site is None else fold_rows(ctx["row_keys"], site)
        return dict(temperature=state.temperature / temp_scale, top_k=state.top_k,
                    top_p=state.top_p, min_p=state.min_p, greedy=False, row_keys=keys)


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


def _next_key(state: DecodeState) -> torch.Tensor:
    """The key after this step: advanced when a lane is active."""
    return torch.where(state.active.any(), fold(state.rng, _NEXT), state.rng)


def _cache_row(cache, ring_len: Optional[int], pos: torch.Tensor):
    """Every tensor of a KV cache and the index of the row at position
    pos[b] of each lane b in them (the slot a forward starting at pos
    writes): t[index] is that row of every layer, [B, L, KVH(, D)]."""
    if isinstance(cache, PagedKVCache):
        page, off = page_slots(cache.table, pos, 1, cache.page_size)
        index = (slice(None), page[:, 0], slice(None), off[:, 0])
    else:
        b, slot, _ = cache_slots(pos, 1, cache.max_seq_len, ring_len)
        index = (slice(None), b[:, 0], slice(None), slot[:, 0])
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None], index


def make_spec_step(target_model: Model, draft_model: Optional[Model], *, k: int,
                   policy_fn: Callable = policies.longest_prefix,
                   policy_params: Optional[dict] = None, greedy: bool = True,
                   temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                   min_p: float = 0.0, draft_temperature_scale: float = 1.5,
                   eos_token_id: Optional[int] = None, draft_mode: str = "vanilla",
                   ngram_cfg: Optional[dict] = None, adaptive_cfg: Optional[dict] = None,
                   draft_params: Optional[dict] = None, medusa_cfg: Optional[dict] = None,
                   eagle_cfg: Optional[dict] = None, repetition_penalty: float = 1.0,
                   presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
                   per_request_sampling: bool = False, logprobs_topk: int = 0,
                   constrain_tbl: Optional[dict] = None, in_place: bool = False):
    """Build step(state) -> state for speculative decoding.

    draft_mode "vanilla" drafts with draft_model, sampling at temperature /
    draft_temperature_scale (greedy: the argmax); "ngram" proposes the K
    tokens after the last earlier occurrence of the last n committed tokens
    (ngram_cfg {"n": n}; the last token where there is none or the
    continuation leaves the committed text), with point-mass draft logits
    (0 at the proposal, -30 elsewhere). The [B, K, V] draft logits are built
    only for a policy with ``needs_draft_logits``. ``rejection`` gets the
    filtered target and draft distributions (its params are set here, as
    JAX's engine sets them) and its bonus comes from the residual,
    sampled at temperature 1; every other policy's bonus is target row a
    under the engine's filters.

    adaptive_cfg (device-side adaptive K: min_k, target_acceptance, window,
    step_size): k is the upper bound and each lane's K is
    clamp(state.ctrl_k, min_k, k). JAX runs only eff_k_max = the largest
    active lane's K draft forwards; a graph has no data-dependent trip
    count, so here all k run, and a forward past eff_k_max proposes 0 (as
    JAX's unwritten draft buffer holds) and puts back the draft-cache row it
    wrote, so the cache holds what JAX's does. Acceptance clips to each
    lane's K, and each active lane's EMA and K update after the step.

    draft_mode "medusa" (draft_params {"medusa_proj": [>= K, D, D]},
    medusa_cfg's temperature and top_p) proposes, for each i < K, a token of
    the target's head over last_hidden @ proj[i] (the carry cast to the
    model dtype): the argmax when greedy, else a draw at medusa's
    temperature and top_p. "eagle" (eagle_cfg's alpha) proposes the argmax
    of the head over h_{i+1} = h_i + alpha (h_i - h_{i-1}), from h_0 =
    last_hidden and h_{-1} = prev_hidden (f32, cast for the head). JAX calls
    the head once a draft position; no head input depends on an earlier
    head's logits here (penalties and a bias act on its output), so the K
    inputs go through ONE head call of [B * K, D] rows. Both draft all K heads under
    the device-side adaptive controller, and acceptance clips, as JAX's
    do. With penalties or a bias the K proposals are still taken in order,
    each from its head's row penalized with the counts of the drafts before
    it.

    Penalties (static, or each slot's under per_request_sampling) and each
    slot's logit_bias apply to every draft row and verify row before
    temperature and the filters; verify row i with the counts of the text
    and d_1..d_i (_Controls). per_request_sampling: every sampling site
    (the draft, the bonus) reads each slot's filters and draws from its own
    key; a row at temperature <= 0 is greedy; not with ``rejection``.
    logprobs_topk N: the top-N alternatives of every written slot, from the
    verify logits, into ``top_ids`` / ``top_lps``.

    constrain_tbl: the grammar's device tables. The draft rows are masked
    by each slot's FSM advanced over the drafts before them (vanilla with a
    draft of the target's vocabulary, Medusa and EAGLE, which then propose
    one position at a time; ngram has no draft logits); verify row i by the
    FSM walked over d_1..d_i; the FSM advances by the committed drafts and
    the bonus. The policy sees the masked draft and target logits."""
    if per_request_sampling and policy_fn is policies.rejection:
        raise NotImplementedError("per-request sampling parameters are not supported with the "
                                  "rejection policy (its distributions are the engine's)")
    K = int(k)
    if draft_mode not in ("vanilla", "ngram", "medusa", "eagle"):
        raise ValueError(f"unknown chain draft_mode {draft_mode!r} (tree speculation is "
                         "core/treespec.py's step)")
    if draft_mode == "vanilla" and draft_model is None:
        raise ValueError("vanilla drafting needs a draft model")
    heads = draft_mode in ("medusa", "eagle")
    if draft_mode == "medusa":
        proj = (draft_params or {}).get("medusa_proj")
        if proj is None or proj.shape[0] < K:
            raise ValueError(f"medusa drafting at K={K} needs draft_params['medusa_proj'] with "
                             f"at least {K} heads")
    medusa_cfg = dict(medusa_cfg or {})
    m_temp = float(medusa_cfg.get("temperature", 0.7))
    m_top_p = float(medusa_cfg.get("top_p", 0.9))
    eagle_alpha = float((eagle_cfg or {}).get("alpha", 0.7))
    compute_dtype = target_model.config.dtype
    policy_params = dict(policy_params or {})
    draft_temp = temperature / draft_temperature_scale
    rejecting = policy_fn is policies.rejection
    if rejecting:
        # min(1, p_t / p_d) is exact only with the distributions the target
        # and the draft really sample from.
        policy_params.update(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
                             draft_temperature=draft_temp, draft_greedy=greedy)
    need_draft_logits = bool(getattr(policy_fn, "needs_draft_logits", True))
    stochastic = not (greedy or temperature <= 0.0)
    head_sampled = draft_mode == "medusa" and not greedy  # medusa draws at its own temperature
    draws = stochastic or rejecting or head_sampled  # the step draws from its key
    samp = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p, greedy=greedy)
    draft_samp = dict(samp, temperature=draft_temp)
    adaptive = adaptive_cfg is not None
    a_min_k = int((adaptive_cfg or {}).get("min_k", 1))
    a_target = float((adaptive_cfg or {}).get("target_acceptance", 0.5))
    a_alpha = 2.0 / (float((adaptive_cfg or {}).get("window", 32)) + 1.0)
    a_step = int((adaptive_cfg or {}).get("step_size", 1))
    ngram_n = int((ngram_cfg or {}).get("n", 2))
    vocab_ok = not (draft_mode == "vanilla"
                    and draft_model.config.vocab_size != target_model.config.vocab_size)
    ctl = _Controls(target_model.config.vocab_size, per_request_sampling,
                    (repetition_penalty, presence_penalty, frequency_penalty),
                    draft_vocab_ok=vocab_ok)
    # The tables are indexed by the target's ids: a draft of another
    # vocabulary proposes unmasked (the verify side keeps the output sound).
    fsm_draft = constrain_tbl is not None and vocab_ok and draft_mode != "ngram"

    def draft_fsm(state):
        return (state.fsm_lex, state.fsm_stack, state.fsm_sp) if fsm_draft else None

    def draft_vanilla(state, last, base, key, eff_k_max, ctx):
        x, drafts, logit_rows = last, [], []
        cnt = ctx.get("counts")
        f = draft_fsm(state)
        for i in range(K):
            pos = base + i
            # Past min_k a forward may lie beyond eff_k_max: keep the draft
            # cache row it writes, to put back.
            extra = adaptive and i >= a_min_k
            if extra:
                tensors, index = _cache_row(state.draft_cache, draft_model.config.kv_ring_len,
                                            pos)
                saved = [t[index] for t in tensors]
            logits, _ = draft_model.forward(x[:, None], pos[:, None], state.draft_cache, pos)
            row = ctl.apply(state, ctx, logits[:, 0], cnt, draft_side=True)
            if f is not None:
                row = fsm.apply_mask(row, fsm.token_mask(constrain_tbl, *f))
            if per_request_sampling:
                x = sample_tokens(None, row, **ctl.row_samp(state, ctx, i,
                                                             draft_temperature_scale))
            else:
                x = sample_tokens(fold(key, i) if stochastic else None, row, **draft_samp,
                                  row0=state.row0)
            if ctl.draft_ok:
                cnt = ctl.bump(cnt, x)
            if f is not None:
                f = fsm.transition(constrain_tbl, *f, x)
            if extra:
                ran = eff_k_max > i
                for t, old in zip(tensors, saved):
                    t[index] = torch.where(ran, t[index], old)
                x = torch.where(ran, x, 0)
                if need_draft_logits:
                    row = torch.where(ran, row, 0.0)
            drafts.append(x)
            if need_draft_logits:
                logit_rows.append(row)
        return torch.stack(drafts, 1), torch.stack(logit_rows, 1) if need_draft_logits else None

    def draft_ngram(state, last, base, key, eff_k_max, ctx):
        # Proposals are lookups: penalties and the bias act on the verify
        # side only (a proposal they would change fails verification).
        tokens, lengths = state.tokens, state.lengths
        T = tokens.shape[1]
        N = ngram_n
        dev = tokens.device
        qpos = lengths[:, None] - N + torch.arange(N, dtype=torch.int32, device=dev)[None]
        query = tokens.gather(1, qpos.clamp(0, T - 1).long())  # the last N committed tokens
        # Window at position p: tokens[p : p+N] (N rolled views).
        shifted = torch.stack([torch.roll(tokens, -i, dims=1) for i in range(N)], dim=-1)
        match = (shifted == query[:, None, :]).all(dim=-1)  # [B, T]
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
        # Matches inside the committed text, before the query's own place.
        hit = match & (pos < lengths[:, None] - N)
        best = torch.argmax(torch.where(hit, pos, -1), dim=1).to(torch.int32)  # the last one
        prop_pos = best[:, None] + N + torch.arange(K, dtype=torch.int32, device=dev)[None]
        cont = tokens.gather(1, prop_pos.clamp(0, T - 1).long())
        usable = hit.any(dim=1)[:, None] & (prop_pos < lengths[:, None])
        d = torch.where(usable, cont, last[:, None])
        if not need_draft_logits:
            return d, None
        V = target_model.config.vocab_size
        onehot = torch.arange(V, dtype=torch.int32, device=dev)[None, None] == d[..., None]
        return d, torch.where(onehot, 0.0, -30.0)

    def head_proposals(state, inputs, key, ctx):
        """One head call over inputs [B, K, D] (the model dtype): the K
        proposals [B, K] and, for a policy that reads them, the f32 head
        logits [B, K, V]. With penalties or a bias, proposal i is taken from
        its row penalized with the counts of the proposals before it."""
        B = inputs.shape[0]
        logits = target_model.head(inputs.reshape(B * K, -1)).reshape(B, K, -1)
        f = draft_fsm(state)
        if not ctl.active and not head_sampled and f is None:
            return torch.argmax(logits, dim=-1).to(torch.int32), (
                logits if need_draft_logits else None)
        cnt, ds, rows = ctx.get("counts"), [], []
        for i in range(K):
            row = ctl.apply(state, ctx, logits[:, i], cnt)
            if f is not None:
                row = fsm.apply_mask(row, fsm.token_mask(constrain_tbl, *f))
            if not head_sampled:
                d_i = torch.argmax(row, dim=-1).to(torch.int32)
            else:
                d_i = sample_tokens(None if per_request_sampling else fold(key, i), row,
                                    temperature=m_temp, top_p=m_top_p,
                                    row_keys=(fold_rows(ctx["row_keys"], i)
                                              if per_request_sampling else None),
                                    row0=state.row0)
            cnt = ctl.bump(cnt, d_i)
            if f is not None:
                f = fsm.transition(constrain_tbl, *f, d_i)
            ds.append(d_i)
            rows.append(row)
        return torch.stack(ds, 1), torch.stack(rows, 1) if need_draft_logits else None

    def draft_medusa(state, last, base, key, eff_k_max, ctx):
        h = state.last_hidden.to(compute_dtype)  # [B, D]
        inputs = torch.matmul(h, proj[:K].to(compute_dtype))  # [K, B, D], one batched product
        return head_proposals(state, inputs.transpose(0, 1), key, ctx)

    def draft_eagle(state, last, base, key, eff_k_max, ctx):
        h_prev, h_cur, hs = state.prev_hidden, state.last_hidden, []
        for _ in range(K):
            h_prev, h_cur = h_cur, h_cur + eagle_alpha * (h_cur - h_prev)
            hs.append(h_cur)
        return head_proposals(state, torch.stack(hs, 1).to(compute_dtype), key, ctx)

    draft_fn = {"vanilla": draft_vanilla, "ngram": draft_ngram, "medusa": draft_medusa,
                "eagle": draft_eagle}[draft_mode]

    def step(state: DecodeState) -> DecodeState:
        B, max_len = state.tokens.shape
        dev = state.tokens.device
        last = _gather_last(state.tokens, state.lengths)  # [B]
        base = state.lengths - 1  # write/read offset: cache holds [0, L-1)
        if adaptive:
            # Each lane's K; the draft runs to the largest over active lanes
            # (an inactive lane must not extend it).
            eff_k = state.ctrl_k.clamp(a_min_k, K)
            eff_k_max = torch.where(state.active, eff_k, a_min_k).amax()
        else:
            eff_k, eff_k_max = K, K

        # ---- 1. Draft K tokens ----
        ctx = ctl.context(state)
        d, draft_logits = draft_fn(state, last, base,
                                   fold(state.rng, _DRAFT) if stochastic or head_sampled
                                   else None, eff_k_max, ctx)

        # ---- 2. Verify: ONE forward over K+1 positions ----
        arange = torch.arange(K + 1, dtype=torch.int32, device=dev)[None, :]
        verify_in = torch.cat([last[:, None], d], dim=1)
        positions = base[:, None] + arange
        target_logits, _, *hidden = target_model.forward(verify_in, positions,
                                                         state.target_cache, base,
                                                         return_hidden=heads,
                                                         lora_ids=state.lora_ids)
        if ctl.active:
            # Verify row i predicts write slot i, having seen the text and
            # d_1..d_i: the counts the draft saw when it proposed d_{i+1}.
            target_logits = ctl.apply(state, ctx, target_logits,
                                      ctl.window_counts(ctx["counts"], d) if ctl.use_pen
                                      else None)
        if constrain_tbl is not None:
            # The soundness guarantee: walk the drafts through each slot's
            # FSM and -inf every invalid token at every verify position.
            walked = fsm.walk_window(constrain_tbl, state.fsm_lex, state.fsm_stack,
                                     state.fsm_sp, d)
            target_logits = fsm.apply_mask(target_logits,
                                           fsm.window_mask(constrain_tbl, *walked))

        # ---- 3. Acceptance ----
        a = policy_fn(fold(state.rng, _POLICY) if rejecting else None, d, draft_logits,
                      target_logits, **policy_params,
                      **({"row0": state.row0} if rejecting else {})).clamp(0, K)
        if adaptive:
            # Positions past a lane's K were never proposed. Then each
            # active lane's EMA and K (the hysteresis rule of
            # AdaptiveKController, per lane).
            a = torch.minimum(a, eff_k)
            rate = a.float() / eff_k.clamp_min(1).float()
            new_ema = torch.where(state.active, state.acc_ema + a_alpha * (rate - state.acc_ema),
                                  state.acc_ema)
            stepped = torch.where(
                new_ema > a_target + 0.1, torch.clamp_max(state.ctrl_k + a_step, K),
                torch.where(new_ema < a_target - 0.1,
                            torch.clamp_min(state.ctrl_k - a_step, a_min_k), state.ctrl_k))
            new_ctrl_k = torch.where(state.active, stepped, state.ctrl_k)
        else:
            new_ema, new_ctrl_k = state.acc_ema, state.ctrl_k

        # ---- 4. Bonus token ----
        key_bonus = fold(state.rng, _BONUS) if stochastic else None
        if rejecting:
            # A final distribution (filters and temperature applied): sampled
            # at temperature 1, or it would be scaled twice.
            bonus_logits = policies.rejection_bonus_logits(
                draft_logits, target_logits, a, temperature=temperature, top_k=top_k,
                top_p=top_p, min_p=min_p, draft_temperature=draft_temp, draft_greedy=greedy)
            bonus = sample_tokens(key_bonus, bonus_logits, temperature=1.0, greedy=greedy,
                                  row0=state.row0)
        else:
            bonus_logits = target_logits[torch.arange(B, device=dev), a.long()]
            if per_request_sampling:  # site K: the draft's sites are 0 .. K-1
                bonus = sample_tokens(None, bonus_logits, **ctl.row_samp(state, ctx, K))
            else:
                bonus = sample_tokens(key_bonus, bonus_logits, **samp, row0=state.row0)

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
        tops = _top_n(state, target_logits, logz, logprobs_topk)

        new_lengths = state.lengths + commit
        if eos_token_id is not None:
            hit_eos = ((write_vals == eos_token_id) & (arange < commit[:, None])).any(dim=1)
        else:
            hit_eos = torch.zeros_like(state.active)
        exhausted = (new_lengths - state.prompt_lens) >= state.max_new
        no_room = new_lengths + K + 1 > max_len  # next step writes K+1 rows
        act = state.active.to(torch.int32)
        carry = {}
        if heads:
            # The hidden row that predicted the bonus: the next step's heads.
            h_row = hidden[0][torch.arange(B, device=dev), a.long()].float()
            carry = hidden_carry(state, h_row)
        if constrain_tbl is not None:
            carry |= fsm_commit(constrain_tbl, state, walked, commit, a, bonus, K)
        return replace(
            state,
            tokens=new_tokens,
            lengths=new_lengths,
            active=state.active & ~hit_eos & ~exhausted & ~no_room,
            proposed=state.proposed + eff_k * act,
            accepted=state.accepted + a * act,
            bonus=state.bonus + act,
            token_logprobs=new_lp,
            steps=_advance(state),
            rng=_next_key(state) if draws else state.rng,
            ctrl_k=new_ctrl_k,
            acc_ema=new_ema,
            **carry,
            **tops,
        )

    return _in_place(step) if in_place else step


def fsm_commit(tbl: dict, state: DecodeState, walked: tuple, commit: torch.Tensor,
               a: torch.Tensor, bonus: torch.Tensor, K: int) -> dict:
    """Each slot's FSM after the commit (JAX specstep.py:720-752): the walked
    state before position min(commit, K), or, when the bonus committed
    (commit == a + 1), the state at a advanced by the bonus; inactive
    lanes keep theirs."""
    lexs, stacks, sps = walked
    rows = torch.arange(lexs.shape[0], device=lexs.device)
    idx, at = commit.clamp_max(K).long(), a.long()
    b_lex, b_stack, b_sp = fsm.transition(tbl, lexs[rows, at], stacks[rows, at], sps[rows, at],
                                          bonus)
    use_b = commit == a + 1
    act = state.active
    new_lex = torch.where(use_b, b_lex, lexs[rows, idx])
    new_stack = torch.where(use_b[:, None], b_stack, stacks[rows, idx])
    new_sp = torch.where(use_b, b_sp, sps[rows, idx])
    return dict(fsm_lex=torch.where(act, new_lex, state.fsm_lex),
                fsm_stack=torch.where(act[:, None], new_stack, state.fsm_stack),
                fsm_sp=torch.where(act, new_sp, state.fsm_sp))


def hidden_carry(state: DecodeState, h_row: torch.Tensor) -> dict:
    """The hidden carry after a step: h_row [B, D] f32 becomes last_hidden and
    the old last_hidden prev_hidden, on active lanes (an inactive lane keeps
    both)."""
    act = state.active[:, None]
    return dict(last_hidden=torch.where(act, h_row, state.last_hidden),
                prev_hidden=torch.where(act, state.last_hidden, state.prev_hidden))


def make_baseline_step(target_model: Model, *, greedy: bool = True, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                       eos_token_id: Optional[int] = None, repetition_penalty: float = 1.0,
                       presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
                       per_request_sampling: bool = False, logprobs_topk: int = 0,
                       constrain_tbl: Optional[dict] = None, in_place: bool = False):
    """Non-speculative step: forward the last token, then the argmax
    (greedy) or a draw under the engine's filters; penalties and the bias
    (as the spec step's) before either, and with per_request_sampling each
    row's own filters and key (JAX's row key: the slot's folded with the
    committed length, no site). constrain_tbl: the row masked by each
    slot's FSM after the bias, which then advances by the committed
    token."""
    stochastic = not (greedy or temperature <= 0.0)
    samp = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p, greedy=greedy)
    ctl = _Controls(target_model.config.vocab_size, per_request_sampling,
                    (repetition_penalty, presence_penalty, frequency_penalty))

    def step(state: DecodeState) -> DecodeState:
        max_len = state.tokens.shape[1]
        last = _gather_last(state.tokens, state.lengths)
        base = state.lengths - 1
        logits, _ = target_model.forward(last[:, None], base[:, None], state.target_cache, base,
                                         lora_ids=state.lora_ids)
        ctx = ctl.context(state)
        # The logprobs describe the distribution sampled from: penalized.
        row = ctl.apply(state, ctx, logits[:, 0].float(), ctx.get("counts"))
        if constrain_tbl is not None:
            row = fsm.apply_mask(row, fsm.token_mask(constrain_tbl, state.fsm_lex,
                                                     state.fsm_stack, state.fsm_sp))
        if per_request_sampling:
            nxt = sample_tokens(None, row, **ctl.row_samp(state, ctx, None))
        else:
            nxt = sample_tokens(fold(state.rng, _BONUS) if stochastic else None, row, **samp,
                                row0=state.row0)
        commit = state.active.to(torch.int32)
        remaining = state.prompt_lens + state.max_new - state.lengths
        commit = torch.minimum(commit, remaining.clamp_min(0))
        new_tokens = _write_rows(state.tokens, nxt[:, None], state.lengths, state.active)
        logz = torch.logsumexp(row, dim=-1)
        lp = row.gather(-1, nxt[:, None].long())[:, 0] - logz
        new_lp = _write_rows(state.token_logprobs, lp[:, None], state.lengths, state.active)
        tops = _top_n(state, row[:, None], logz[:, None], logprobs_topk)
        new_lengths = state.lengths + commit
        if eos_token_id is not None:
            hit_eos = (nxt == eos_token_id) & (commit > 0)
        else:
            hit_eos = torch.zeros_like(state.active)
        exhausted = (new_lengths - state.prompt_lens) >= state.max_new
        no_room = new_lengths + 2 > max_len
        fsm_new = {}
        if constrain_tbl is not None:
            fsm_new = dict(zip(("fsm_lex", "fsm_stack", "fsm_sp"), fsm.transition(
                constrain_tbl, state.fsm_lex, state.fsm_stack, state.fsm_sp, nxt,
                active=state.active & (commit > 0))))
        return replace(
            state,
            tokens=new_tokens,
            lengths=new_lengths,
            active=state.active & ~hit_eos & ~exhausted & ~no_room,
            bonus=state.bonus + commit,
            token_logprobs=new_lp,
            steps=_advance(state),
            rng=_next_key(state) if stochastic else state.rng,
            **tops,
            **fsm_new,
        )

    return _in_place(step) if in_place else step


def make_prefill(target_model: Model, draft_model: Optional[Model], chunk: Optional[int] = None,
                 hidden: bool = False):
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
    at position i*chunk + j + 1.

    hidden (the head modes): the target's hidden row that predicted the
    last prompt token (index prompt_len - 2, clamped at 0), taken from the
    chunk that holds it, seeds last_hidden and prev_hidden (f32)."""

    def prefill(state: DecodeState, prompt_block: torch.Tensor,
                prompt_lens: torch.Tensor) -> DecodeState:
        B, P = prompt_block.shape
        dev = prompt_block.device
        lp_buf = state.token_logprobs.clone()
        C = chunk if chunk is not None and P > chunk else P
        if P % C:
            raise ValueError(f"prompt block of {P} is not a multiple of the chunk {C}")
        arange = torch.arange(C, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        h_idx = (prompt_lens - 2).clamp_min(0).long()
        h_last = torch.zeros_like(state.last_hidden)
        for c0 in range(0, P, C):
            tok = prompt_block[:, c0:c0 + C]
            positions = c0 + arange
            start = torch.full((B,), c0, dtype=torch.int32, device=dev)
            lg, _, *hid = target_model.forward(tok, positions, state.target_cache, start,
                                               return_hidden=hidden, lora_ids=state.lora_ids)
            if hidden:
                local = h_idx - c0
                sel = hid[0][torch.arange(B, device=dev), local.clamp(0, C - 1)].float()
                h_last = torch.where(((local >= 0) & (local < C))[:, None], sel, h_last)
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
        carry = dict(last_hidden=h_last, prev_hidden=h_last.clone()) if hidden else {}
        return replace(state, tokens=tokens, lengths=prompt_lens, prompt_lens=prompt_lens,
                       active=prompt_lens > 0, token_logprobs=lp_buf, **carry)

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
    it raises: there is no eager fallback on the card. ``eager=True``
    (decided by the engine at its construction: a tensor-parallel mesh,
    whose collectives a graph cannot hold) runs the in-place step n times on
    the card too, as on the CPU; nothing is captured."""

    replayed: Dict[str, int] = {}

    def __init__(self, step, pool=None, eager: bool = False):
        self.step = step  # in place
        self.pool = pool  # a graph pool handle, shared by the loops of one engine
        self.eager = eager
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
        if state.tokens.is_cuda and not self.eager:
            self._capture(state)
        self.bound = state_tensors(state)

    @torch.inference_mode()
    def __call__(self, state: DecodeState, n: int) -> DecodeState:
        if self.bound is None:
            self.bind(state)
        elif not all(a is b for a, b in zip(self.bound, state_tensors(state), strict=True)):
            raise ValueError("the decode loop was bound to another state's tensors")
        if state.tokens.is_cuda and not self.eager:
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
        # Dead objects in reference cycles (a batcher with its graph and
        # caches) are freed now and not by a collection inside the capture,
        # where destroying a graph or freeing its pool's memory would
        # invalidate the capture; the collector stays off until it ends.
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capture:
                self.step(state)
        except RuntimeError as err:
            _set_launch_counts(before)
            raise RuntimeError("capturing the decode step in a CUDA graph failed (a host read "
                               "or a synchronisation inside the step?)") from err
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = _launch_counts()
        self.per_replay = {name: after[name] - before[name] for name in after}
        _set_launch_counts(before)  # capturing launched nothing
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph


def make_decode_loop(step, pool=None, eager: bool = False) -> DecodeLoop:
    """The decode loop over an in-place step (make_spec_step or
    make_baseline_step with in_place=True); pool: a graph pool handle
    (torch.cuda.graph_pool_handle) its graph may share; eager: run the step
    without a graph on the card too."""
    return DecodeLoop(step, pool, eager)

"""Acceptance policies (port of llm_inference_lab_tpu/core/policies.py).

Contract, as in JAX:

    policy(key, draft_tokens, draft_logits, target_logits, **params)
        -> accept_len [B] int32 in [0, K]
      draft_tokens:  [B, K] int32
      draft_logits:  [B, K, V] f32, the draft distribution at each proposed
                     position (None where the step builds none: a policy
                     whose ``needs_draft_logits`` is False never reads it)
      target_logits: [B, K+1, V] f32; only the first K rows take part (row
                     K is the bonus distribution)
      key:           the step's policy key (ops/sampling.py); only
                     ``rejection`` draws from it

``longest_prefix`` is kernel C (ops/verify.py). The others are plain tensor
code, as in JAX, where none of them is a Pallas kernel.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from llm_inference_lab_tpu_torch.ops.sampling import proposal_log_probs, uniform
from llm_inference_lab_tpu_torch.ops.verify import verify_prefix


def _prefix_len(accept_mask: torch.Tensor) -> torch.Tensor:
    """[B, K] bool -> [B] int32 length of the all-True prefix."""
    return torch.cumprod(accept_mask.to(torch.int32), dim=-1).sum(-1).to(torch.int32)


def longest_prefix(key, draft_tokens, draft_logits, target_logits, **_):
    """Greedy argmax match. The [:, :-1] view is passed as it is: the
    verify_prefix kernel reads it through its strides, with no copy."""
    accept_len, _ = verify_prefix(draft_tokens, target_logits[:, :-1])
    return accept_len


def conf_threshold(key, draft_tokens, draft_logits, target_logits, *, tau: float = 0.5, **_):
    """Accept while the draft's largest softmax probability is >= tau."""
    conf = torch.softmax(draft_logits.float(), dim=-1).amax(dim=-1)
    return _prefix_len(conf >= tau)


def topk_agree(key, draft_tokens, draft_logits, target_logits, *, k: int = 5, **_):
    """Accept while the draft token is among the target's top k. A token is
    in the top k when fewer than k tokens rank above it: a larger logit, or
    an equal one at a lower index (lax.top_k's order on ties)."""
    tl = target_logits[:, :-1]
    own = tl.gather(-1, draft_tokens[..., None].long())
    ids = torch.arange(tl.shape[-1], device=tl.device)
    above = (tl > own) | ((tl == own) & (ids < draft_tokens[..., None]))
    return _prefix_len(above.sum(-1) < k)


def typical(key, draft_tokens, draft_logits, target_logits, *, p: float = 0.9, **_):
    """Accept while the target's probability of the draft token is >= p."""
    probs = torch.softmax(target_logits[:, :-1].float(), dim=-1)
    p_draft = probs.gather(-1, draft_tokens[..., None].long())[..., 0]
    return _prefix_len(p_draft >= p)


def rejection_ratio(draft_tokens, draft_logits, target_logits, *, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                    draft_temperature: float = 1.0, draft_greedy: bool = False):
    """[B, K] min(1, p_t(d_i) / p_d(d_i)) over the filtered sampling
    distributions of target and draft (the draft's greedy point mass
    included)."""
    lp_t = proposal_log_probs(target_logits[:, :-1], temperature, top_k, top_p, min_p)
    lp_d = proposal_log_probs(draft_logits, draft_temperature, top_k, top_p, min_p,
                              greedy=draft_greedy)
    idx = draft_tokens[..., None].long()
    lpt_i, lpd_i = lp_t.gather(-1, idx)[..., 0], lp_d.gather(-1, idx)[..., 0]
    # p_d(d_i) > 0 by construction; the -30 floor covers numeric edge cases.
    ratio = torch.exp(torch.clamp_max(lpt_i - torch.clamp_min(lpd_i, -30.0), 0.0))
    return torch.where(torch.isfinite(lpt_i), ratio, 0.0)


def rejection(key, draft_tokens, draft_logits, target_logits, **params):
    """Stochastic speculative sampling: accept d_i with probability
    min(1, p_t / p_d) (Leviathan et al.), distribution-exact with the
    residual bonus of ``rejection_bonus_logits``. params: temperature,
    top_k, top_p, min_p, draft_temperature, draft_greedy."""
    ratio = rejection_ratio(draft_tokens, draft_logits, target_logits, **params)
    return _prefix_len(uniform(key, draft_tokens.shape) < ratio)


def rejection_bonus_logits(draft_logits, target_logits, accept_len, temperature: float = 1.0,
                           top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                           draft_temperature: float = 1.0,
                           draft_greedy: bool = False) -> torch.Tensor:
    """Log-probs of the bonus distribution: the residual max(0, p_t - p_d)
    at the first rejected position, the target's sampling distribution
    where every draft was accepted (or the residual is empty). Final: sample
    it at temperature 1 with no further filter."""
    B, K, V = draft_logits.shape
    idx = torch.clamp_max(accept_len, K - 1).long()
    rows = torch.arange(B, device=draft_logits.device)
    lp_t = proposal_log_probs(target_logits[rows, idx], temperature, top_k, top_p, min_p)
    lp_d = proposal_log_probs(draft_logits[rows, idx], draft_temperature, top_k, top_p, min_p,
                              greedy=draft_greedy)
    resid = torch.clamp_min(torch.exp(lp_t) - torch.exp(lp_d), 0.0)
    total = resid.sum(-1, keepdim=True)
    resid_logits = torch.where(resid > 0, torch.log(torch.clamp_min(resid, 1e-30)),
                               float("-inf"))
    resid_logits = torch.where(total > 1e-9, resid_logits, lp_t)
    lp_full = proposal_log_probs(target_logits[:, K], temperature, top_k, top_p, min_p)
    return torch.where((accept_len >= K)[:, None], lp_full, resid_logits)


POLICIES: Dict[str, Callable] = {
    "longest_prefix": longest_prefix,
    "conf_threshold": conf_threshold,
    "topk_agree": topk_agree,
    "typical": typical,
    "rejection": rejection,
}

# Policies that only compare ids never read draft_logits, so the spec step
# builds no [B, K, V] draft-logit stack for them.
longest_prefix.needs_draft_logits = False
topk_agree.needs_draft_logits = False
typical.needs_draft_logits = False
conf_threshold.needs_draft_logits = True
rejection.needs_draft_logits = True


def create_policy(name: str) -> Callable:
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; known: {sorted(POLICIES)}") from None

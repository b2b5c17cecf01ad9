"""The acceptance policies of the port (core/policies.py) against the JAX
package's core/policies.py on the CPU, on logits and drafts from a numpy
seed: the four deterministic policies' accept_len exactly, the rejection
ratio and the residual bonus distribution within 1e-6, and the port of
JAX's test_rejection_is_distribution_exact (the emitted token follows the
target's sampling distribution within total variation 0.02)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.core import policies as jp
from llm_inference_lab_tpu.ops.sampling import proposal_log_probs as jax_proposal
from llm_inference_lab_tpu_torch.core import policies as tp
from llm_inference_lab_tpu_torch.ops import sampling as ts

B, K, V = 16, 6, 500


def _inputs(seed):
    """Target logits [B, K+1, V] with a spread of peakedness, draft logits
    [B, K, V], and drafts: mostly the target's argmax, else one of its top 8
    or a random token, so every policy accepts partial prefixes."""
    rng = np.random.default_rng(seed)
    sharp = rng.uniform(0.5, 16.0, (B, K + 1, 1))
    tl = (rng.normal(0, 1, (B, K + 1, V)) * sharp).astype(np.float32)
    dl = (rng.normal(0, 1, (B, K, V)) * rng.uniform(0.5, 16.0, (B, K, 1))).astype(np.float32)
    order = np.argsort(-tl[:, :K], axis=-1, kind="stable")
    pick = rng.choice(3, size=(B, K), p=[0.7, 0.2, 0.1])
    draft = np.where(pick == 0, order[..., 0],
                     np.where(pick == 1, np.take_along_axis(
                         order, rng.integers(1, 8, (B, K, 1)), -1)[..., 0],
                              rng.integers(0, V, (B, K))))
    tl[3, 2, :4] = tl[3, 2].max() + 1.0  # a four-way tie at the top
    draft[3, 2] = 2
    return draft.astype(np.int32), dl, tl


@pytest.mark.parametrize("name,params", [
    ("longest_prefix", {}), ("conf_threshold", {}), ("conf_threshold", {"tau": 0.2}),
    ("topk_agree", {}), ("topk_agree", {"k": 2}), ("typical", {}), ("typical", {"p": 0.3}),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_deterministic_policies_equal_jax(name, params, seed):
    draft, dl, tl = _inputs(seed)
    got = tp.create_policy(name)(None, torch.from_numpy(draft), torch.from_numpy(dl),
                                 torch.from_numpy(tl), **params).numpy()
    want = np.asarray(jp.create_policy(name)(None, jnp.asarray(draft), jnp.asarray(dl),
                                             jnp.asarray(tl), **params))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert 0 < got.sum() < B * K  # partial prefixes


SETTINGS = [dict(), dict(temperature=0.8, top_p=0.95, draft_temperature=0.8 / 1.5),
            dict(temperature=1.3, top_k=20, min_p=0.05, draft_temperature=1.3 / 1.5),
            dict(draft_greedy=True)]


@pytest.mark.parametrize("kw", SETTINGS)
def test_rejection_ratio_and_bonus_match_jax(kw):
    """min(1, p_t / p_d) at every draft, as JAX's rejection computes it,
    within 1e-6, and the distribution of rejection_bonus_logits at accept
    lengths 0..K (K: the free row): its masses exp(logits) within 1e-6.
    (The logits are logs of p_t - p_d: where both are tiny the difference
    cancels, and its log moves with the last bit of either exp.)"""
    draft, dl, tl = _inputs(2)
    got = tp.rejection_ratio(torch.from_numpy(draft), torch.from_numpy(dl),
                             torch.from_numpy(tl), **kw).numpy()
    t_kw = {k: v for k, v in kw.items() if k in ("temperature", "top_k", "top_p", "min_p")}
    lp_t = jax_proposal(jnp.asarray(tl[:, :-1]), **t_kw)
    lp_d = jax_proposal(jnp.asarray(dl), kw.get("draft_temperature", 1.0), kw.get("top_k", 0),
                        kw.get("top_p", 1.0), kw.get("min_p", 0.0),
                        greedy=kw.get("draft_greedy", False))
    lpt = jnp.take_along_axis(lp_t, jnp.asarray(draft)[..., None], -1)[..., 0]
    lpd = jnp.take_along_axis(lp_d, jnp.asarray(draft)[..., None], -1)[..., 0]
    want = jnp.where(jnp.isfinite(lpt), jnp.exp(jnp.minimum(lpt - jnp.maximum(lpd, -30.0), 0.0)),
                     0.0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    a = np.arange(B, dtype=np.int32) % (K + 1)
    got = tp.rejection_bonus_logits(torch.from_numpy(dl), torch.from_numpy(tl),
                                    torch.from_numpy(a), **kw).numpy()
    want = np.asarray(jp.rejection_bonus_logits(jnp.asarray(dl), jnp.asarray(tl),
                                                jnp.asarray(a), **kw))
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0, atol=1e-6)
    full = a == K  # the target's own sampling distribution: log-probs alike
    np.testing.assert_array_equal(np.isinf(got[full]), np.isinf(want[full]))
    np.testing.assert_allclose(got[full], want[full], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature,top_p,draft_scale,min_p", [
    (1.0, 1.0, 1.0, 0.0), (0.7, 1.0, 1.5, 0.0), (1.3, 0.9, 1.5, 0.0), (0.8, 1.0, 1.5, 0.15),
    (1.0, 0.9, 1.0, 0.1)])
def test_rejection_is_distribution_exact(temperature, top_p, draft_scale, min_p):
    """JAX's test of the speculative-sampling theorem with the port's draws:
    draft one token from the draft's filtered distribution, accept it by
    ``rejection`` or emit the residual bonus; the emitted tokens follow the
    target's sampling distribution (TV < 0.02 over 40000 trials)."""
    n = 40000
    rng = np.random.default_rng(42)
    tl_row = (rng.normal(0, 1, 16) * 2.0).astype(np.float32)
    dl_row = (rng.normal(0, 1, 16) * 2.0).astype(np.float32)
    draft_temp = temperature / draft_scale
    dl = torch.from_numpy(dl_row).expand(n, 1, 16)
    tl = torch.from_numpy(tl_row).expand(n, 2, 16)
    key = torch.tensor(ts.seed_key(42))
    d_tok = ts.sample_tokens(ts.fold(key, 1), dl[:, 0], temperature=draft_temp, top_p=top_p,
                             min_p=min_p)[:, None]
    kw = dict(temperature=temperature, top_p=top_p, min_p=min_p, draft_temperature=draft_temp)
    a = tp.rejection(ts.fold(key, 2), d_tok, dl, tl, **kw)
    bonus = ts.sample_tokens(ts.fold(key, 3), tp.rejection_bonus_logits(dl, tl, a, **kw),
                             temperature=1.0)
    emitted = torch.where(a == 1, d_tok[:, 0], bonus).numpy()
    emp = np.bincount(emitted, minlength=16) / n
    want = np.exp(np.asarray(jax_proposal(jnp.asarray(tl_row), temperature, 0, top_p, min_p)))
    tv = 0.5 * np.abs(emp - want).sum()
    assert tv < 0.02, (tv, emp, want)


def test_create_policy_and_needs_draft_logits_match_jax():
    assert list(tp.POLICIES) == list(jp.POLICIES)
    for name in jp.POLICIES:
        assert tp.create_policy(name) is tp.POLICIES[name]
        assert tp.POLICIES[name].needs_draft_logits == jp.POLICIES[name].needs_draft_logits
    with pytest.raises(ValueError, match="unknown policy"):
        tp.create_policy("nope")

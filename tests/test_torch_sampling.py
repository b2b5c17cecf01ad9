"""Sampling in the port (ops/sampling.py) against the JAX package's
ops/sampling.py on the CPU: the filters and the proposal distribution
within 1e-6, the argmax fallbacks exactly, and the draws from the port's
counter-based key statistically (total variation 0.02 from the softmax, as
JAX's own tests/test_policies.py bounds its check). Then the key in the
decode step: the same seed draws the same, consecutive steps draw anew, the
in-place step draws what the functional one draws, and the decode loop
equals the host loop under sampling. Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops import sampling as js
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.state import FIELDS, assign, state_tensors
from llm_inference_lab_tpu_torch.ops import sampling as ts
from test_torch_decode_loop import one_thread  # noqa: F401

GRID = [  # temperature, top_k, top_p, min_p
    (1.0, 0, 1.0, 0.0), (0.8, 0, 0.95, 0.0), (0.7, 5, 1.0, 0.0), (1.3, 0, 0.9, 0.1),
    (0.8, 8, 0.9, 0.05), (2.0, 0, 1.0, 0.2), (0.5, 50, 0.5, 0.0), (1.0, 1, 0.9, 0.0),
]


def _logits(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).normal(0, 1, shape) * scale).astype(np.float32)


@pytest.mark.parametrize("temperature,top_k,top_p,min_p", GRID)
def test_filtered_logits_and_proposal_match_jax(temperature, top_k, top_p, min_p):
    """[3, 5, 1000] logits: the filtered logits and the proposal log-probs
    within 1e-6 (relative and absolute) of JAX's, with -inf at exactly the
    same places."""
    x = _logits(7, (3, 5, 1000))
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    for port_fn, jax_fn in ((ts.filtered_logits, js.filtered_logits),
                            (ts.proposal_log_probs, js.proposal_log_probs)):
        got = port_fn(torch.from_numpy(x), **kw).numpy()
        want = np.asarray(jax_fn(jnp.asarray(x), **kw))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_greedy_proposal_is_a_point_mass_at_jax_argmax():
    x = _logits(8, (4, 300))
    x[1, 17] = x[1, 3] = x[1].max() + 1.0  # a tie: the lower index
    got = ts.proposal_log_probs(torch.from_numpy(x), greedy=True).numpy()
    want = np.asarray(js.proposal_log_probs(jnp.asarray(x), greedy=True))
    np.testing.assert_array_equal(got, want)


def test_argmax_temperature_zero_and_nan_fallbacks_match_jax():
    """Greedy and temperature 0 give the argmax (first index on ties); a row
    all NaN or all -inf, or with a NaN, falls back to the argmax of its
    logits when sampling; every id is in [0, V). Exactly JAX's ids."""
    x = _logits(9, (6, 64))
    x[0, 5] = x[0, 40] = 50.0
    x[1] = np.nan
    x[2] = -np.inf
    x[3, 7] = np.nan
    key = torch.tensor(ts.seed_key(3))
    for kw in (dict(greedy=True), dict(temperature=0.0), dict(temperature=-1.0)):
        got = ts.sample_tokens(key, torch.from_numpy(x), **kw).numpy()
        want = np.asarray(js.sample_tokens(jax.random.PRNGKey(0), jnp.asarray(x), **kw))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jnp.argmax(jnp.asarray(x), -1)))
    got = ts.sample_tokens(key, torch.from_numpy(x), temperature=0.9, top_p=0.9).numpy()
    want = np.asarray(js.sample_tokens(jax.random.PRNGKey(0), jnp.asarray(x), temperature=0.9,
                                       top_p=0.9))
    np.testing.assert_array_equal(got[1:4], want[1:4])
    assert got.dtype == np.int32 and ((got >= 0) & (got < 64)).all()


@pytest.mark.parametrize("temperature,top_k,top_p,min_p", GRID)
def test_sample_frequencies_follow_the_softmax(temperature, top_k, top_p, min_p):
    """2**16 draws (one row of 24 logits repeated) within total variation
    0.02 of exp(proposal_log_probs), the distribution JAX samples from."""
    row = _logits(10, (24,))
    n = 1 << 16
    key = torch.tensor(ts.seed_key(11))
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    ids = ts.sample_tokens(key, torch.from_numpy(np.tile(row, (n, 1))), **kw).numpy()
    emp = np.bincount(ids, minlength=24) / n
    want = np.exp(np.asarray(js.proposal_log_probs(jnp.asarray(row), **kw)))
    tv = 0.5 * np.abs(emp - want).sum()
    assert tv < 0.02, (tv, emp, want)


def test_uniform_draws_are_a_function_of_the_key():
    """The same key draws the same numbers; another key (the next step's,
    fold(key, 0), or another seed's) draws others; uniforms lie in (0, 1)
    with mean 1/2; Python ints and tensors fold alike."""
    key = torch.tensor(ts.seed_key(5))
    a, b = ts.uniform(key, (64, 1000)), ts.uniform(key, (64, 1000))
    assert torch.equal(a, b)
    for other in (ts.fold(key, 0), torch.tensor(ts.seed_key(6))):
        c = ts.uniform(other, (64, 1000))
        assert (a != c).float().mean() > 0.99
    assert 0 < float(a.min()) and float(a.max()) < 1 and abs(float(a.mean()) - 0.5) < 0.01
    assert int(ts.fold(key, 7)) == ts.fold(ts.seed_key(5), 7)
    k, seen = ts.seed_key(0), set()  # no key stays put, seed 0's included
    for _ in range(1000):
        seen.add(k)
        k = ts.fold(k, 0)
    assert len(seen) == 1000
    assert ts.uniform(key, (3, 4, 5)).shape == (3, 4, 5)


SAMPLED = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=3, max_new_tokens=12,
               max_seq_len=256, greedy=False, temperature=0.8, top_p=0.95)
PROMPTS = ["sampling check " * 3, "the key advances"]


@pytest.fixture(scope="module")
def engines():
    """A sampled llama-tiny engine (rejection, adaptive-device K), its host
    loop twin on the same weights, and a sampled baseline."""
    cfg = EngineConfig(policy="rejection", controller="adaptive-device",
                       controller_params={"max_k": 4}, **SAMPLED)
    eng = Engine(cfg, device="cpu")
    host = Engine(cfg, device="cpu", flags=EnvFlags(sync_steps=True),
                  target_params=eng.target.params, draft_params=eng.draft.params)
    base = Engine(EngineConfig(**{**SAMPLED, "draft_model": None}), device="cpu",
                  target_params=eng.target.params)
    return eng, host, base


@pytest.mark.parametrize("which", ["spec", "baseline"])
def test_in_place_step_draws_what_the_functional_step_draws(engines, which):
    """Functional and in-place steps from one prefill, sampled: every field
    (the key included) and every cache tensor equal bit for bit after each
    step; the key advances at each step with an active lane and not after."""
    eng = engines[0] if which == "spec" else engines[2]
    block, plens, max_len = eng._prompt_block(PROMPTS)
    prompt = torch.from_numpy(block), torch.from_numpy(plens)
    functional = eng._prefill(eng._init_state(2, max_len, seed=4), *prompt)
    in_place = eng._init_state(2, max_len, seed=4)
    assign(in_place, eng._prefill(in_place, *prompt))
    keys = [int(in_place.rng)]
    for _ in range(eng.config.max_new_tokens + 2):
        was_active = bool(in_place.active.any())
        functional = eng._step(functional)
        eng._step_in_place(in_place)
        for x, y in zip(state_tensors(functional), state_tensors(in_place)):
            assert (x is None) == (y is None) and (x is None or torch.equal(x, y))
        keys.append(int(in_place.rng))
        assert (keys[-1] != keys[-2]) == was_active
    assert not in_place.active.any()
    assert len(set(keys)) == int(in_place.steps) + 1


def test_seed_repeats_and_another_seed_differs(engines):
    eng = engines[0]
    a, b = eng.generate_batch(PROMPTS, seed=1), eng.generate_batch(PROMPTS, seed=1)
    c = eng.generate_batch(PROMPTS, seed=2)
    assert [r["generated_ids"] for r in a] == [r["generated_ids"] for r in b]
    assert [r["generated_ids"] for r in a] != [r["generated_ids"] for r in c]
    for r in a:
        assert np.all(np.isfinite(r["token_logprobs"]))
        assert 1 <= np.min(r["controller"]["final_k"]) <= np.max(r["controller"]["final_k"]) <= 4


@pytest.mark.parametrize("which", ["spec", "baseline"])
def test_decode_loop_equals_host_loop_under_sampling(engines, which):
    """The decode loop (reused decode state, reset with the call's seed)
    and the host loop give the same ids, logprobs, steps, proposed,
    accepted and ctrl_k, over two calls with two seeds."""
    eng, host, base = engines
    if which == "baseline":
        eng = base
        host = Engine(base.config, device="cpu", flags=EnvFlags(sync_steps=True),
                      target_params=base.target.params)
    for seed in (3, 8):
        got, want = eng.generate_batch(PROMPTS, seed=seed), host.generate_batch(PROMPTS, seed=seed)
        for g, w in zip(got, want):
            for key in ("generated_ids", "token_logprobs", "steps", "proposed", "accepted",
                        "controller"):
                assert g[key] == w[key], key
    assert len({tuple(r["generated_ids"]) for r in got}) == 2
    assert set(FIELDS) >= {"rng", "ctrl_k", "acc_ema"}

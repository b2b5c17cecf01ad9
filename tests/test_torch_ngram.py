"""ngram drafting (core/specstep.py ``draft_mode="ngram"``) against the JAX
package on the CPU.

The draft proposes the K tokens after the last earlier occurrence of the
last n committed tokens, or the last token where there is none or the
continuation leaves the committed text; it needs no draft model and no
draft cache. The proposals (and their point-mass draft logits) on seeded
token buffers equal JAX's exactly; llama-tiny ngram generation at B=1 and
B=3, and through the batcher, gives JAX's ids, proposed, accepted, bonus
tokens and steps, with acceptance above 0; the decode loop (the in-place
step) equals the host loop. Weights come from the JAX package
(convert.params_from_jax), projections x10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.core.specstep import make_spec_step as jax_spec_step
from llm_inference_lab_tpu.core.state import init_state as jax_init_state
from llm_inference_lab_tpu.models.fake import make_fake_model as jax_fake
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.specstep import make_spec_step
from llm_inference_lab_tpu_torch.core.state import init_state
from llm_inference_lab_tpu_torch.models.fake import make_fake_model
from test_torch_decode_loop import one_thread  # noqa: F401

B, T, K = 7, 64, 5


def _buffers(seed):
    """[B, T] token buffers over a 4-token alphabet (many matches) and their
    committed lengths, with: a row of distinct tokens (no match), a row of a
    repeated pair (the last match's continuation leaves the committed text),
    and a row shorter than the n-gram."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 5, (B, T)).astype(np.int32)
    lengths = rng.integers(8, T - K - 2, B).astype(np.int32)
    tokens[1] = np.arange(10, 10 + T)
    tokens[2, :] = np.tile([7, 9], T // 2)
    lengths[3] = 1
    return tokens, lengths


def _capture(store):
    """A policy that records the drafts and draft logits it is given and
    accepts nothing."""
    def policy(key, draft_tokens, draft_logits, target_logits, **_):
        store["d"], store["logits"] = draft_tokens, draft_logits
        return draft_tokens[:, 0] * 0

    policy.needs_draft_logits = True
    return policy


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_ngram_proposals_equal_jax(n, seed):
    """One spec step over the same token buffers: the proposals and the
    point-mass draft logits (0 at the proposal, -30 elsewhere) equal JAX's;
    the no-match row and the too-short row propose their last token; the
    repeated pair's continuation falls back to the last token where it
    leaves the committed text."""
    tokens, lengths = _buffers(seed)
    ours, theirs = {}, {}
    state = init_state(make_fake_model(), None, B, T, "cpu")
    state.tokens.copy_(torch.from_numpy(tokens))
    state.lengths.copy_(torch.from_numpy(lengths))
    state.active.fill_(True)
    make_spec_step(make_fake_model(), None, k=K, policy_fn=_capture(ours), draft_mode="ngram",
                   ngram_cfg={"n": n})(state)
    jm = jax_fake()
    jstate = jax_init_state(jm, None, B, T).replace(
        tokens=jnp.asarray(tokens), lengths=jnp.asarray(lengths), active=jnp.ones(B, bool))
    jax_spec_step(jm, None, k=K, policy_fn=_capture(theirs), draft_mode="ngram",
                  ngram_cfg={"n": n}, jit=False)(jm.params, None, jstate)
    d = ours["d"].numpy()
    np.testing.assert_array_equal(d, np.asarray(theirs["d"]))
    np.testing.assert_array_equal(ours["logits"].numpy(), np.asarray(theirs["logits"]))
    last = tokens[np.arange(B), lengths - 1]
    assert (d[1] == last[1]).all() and (d[3] == last[3]).all()
    assert (d[2] == last[2]).any() and (d != last[:, None]).any()


MULT = 10


@functools.lru_cache(maxsize=None)
def _target():
    m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(2), dtype=jnp.float32)
    m.params = jax.tree_util.tree_map(lambda a: a * MULT if a.ndim >= 2 else a, m.params)
    return m


NGRAM = dict(base_model="llama-tiny", draft_model=None, draft_mode="ngram", max_draft=4,
             max_new_tokens=32, max_seq_len=256, dtype="float32")
# The random model seldom repeats itself: ngram accepts 4 of 112 proposals
# on the first prompt, 1 of 124 on the second.
PROMPTS = ["abcabcabc xyz abcabc", "abc " * 8, "hello world"]
KEYS = ("generated_ids", "proposed", "accepted", "bonus_tokens", "steps")


def _port(flags=None, **kw):
    return Engine(EngineConfig(**dict(NGRAM, **kw)), device="cpu", flags=flags,
                  target_params=params_from_jax(_target().params))


def _jax(**kw):
    return JaxEngine(JaxEngineConfig(implementation="hf", **dict(NGRAM, **kw)),
                     target_model=_target())


@pytest.fixture(scope="module")
def engines():
    return _port(), _port(EnvFlags(sync_steps=True)), _jax()


@pytest.mark.parametrize("batch", [1, 3])
def test_ngram_generate_equals_jax_and_the_host_loop(engines, batch):
    """ngram generate_batch at B=1 and B=3: ids, proposed, accepted, bonus
    and steps equal JAX's Engine and the port's host loop (token logprobs
    within 1e-4 of JAX's, exactly the host loop's); acceptance above 0;
    no draft model and no draft cache; at B=1 the ids equal the greedy
    baseline's."""
    eng, host, jeng = engines
    prompts = PROMPTS[:batch]
    got, want = eng.generate_batch(prompts), jeng.generate_batch(prompts)
    again = host.generate_batch(prompts)
    for g, w, h in zip(got, want, again, strict=True):
        for key in KEYS:
            assert g[key] == w[key] == h[key], (key, g[key], w[key], h[key])
        np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"], rtol=0, atol=1e-4)
        assert g["token_logprobs"] == h["token_logprobs"]
        assert g["draft_mode"] == "ngram"
    assert sum(r["accepted"] for r in got) > 0
    assert eng.draft is None and all(s.draft_cache is None
                                     for s, _ in eng._decode_states.values())
    if batch == 1:
        base = _port(draft_mode="vanilla").generate_batch(prompts)
        assert [r["generated_ids"] for r in got] == [r["generated_ids"] for r in base]


SERVE_REQUESTS = [("abcabcabc xyz abcabc", 32), ("hello world", 9), ("ab" * 10, 30),
                  ("abc " * 8, 12)]


def _serve(b):
    for prompt, budget in SERVE_REQUESTS:
        b.submit(prompt, max_new_tokens=budget)
    b._admit_pending()
    for _ in range(200):
        if not any(s is not None for s in b._slots):
            break
        b.step_chunk(1)
        b._retire_finished()
        b._admit_pending()
    return [b._done[i].result for i in sorted(b._done)]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ngram_batcher_equals_jax(layout):
    """The batcher with ngram drafting (2 slots, 4 requests, one step a
    poll): ids, proposed and accepted equal JAX's batcher and the port's
    host-step batcher; acceptance above 0; no draft cache."""
    kw = dict(kv_layout=layout, kv_page_size=16)
    want = _serve(JaxBatcher(JaxEngine(JaxEngineConfig(implementation="hf", kv_lazy_pages=False,
                                                       **dict(NGRAM, **kw)),
                                       target_model=_target()), n_slots=2))
    kw["kv_lazy_pages"] = False
    b = ContinuousBatcher(_port(**kw), n_slots=2)
    assert b.state.draft_cache is None
    got = _serve(b)
    host = _serve(ContinuousBatcher(_port(EnvFlags(sync_steps=True), **kw), n_slots=2))
    for g, w, h in zip(got, want, host, strict=True):
        for key in ("generated_ids", "proposed", "accepted", "finish_reason"):
            assert g[key] == w[key] == h[key], (key, g[key], w[key], h[key])
    assert sum(r["accepted"] for r in got) > 0


def test_batcher_refuses_adaptive_controllers():
    """The batcher once refused both adaptive controllers; it now serves
    them as JAX's does (K from the scheduler's EMA a chunk, or each slot's
    K on the device): the ngram batcher's greedy ids equal the fixed-K
    batcher's, and under the host controller ids, proposed and accepted
    equal JAX's batcher's."""
    kw = dict(kv_layout="paged", kv_page_size=16, kv_lazy_pages=False)
    fixed = _serve(ContinuousBatcher(_port(**kw), n_slots=2))
    for name in ("adaptive", "adaptive-device"):
        ctl = dict(controller=name, controller_params={"min_k": 1, "max_k": 6,
                                                       "target_acceptance": 0.05})
        got = _serve(ContinuousBatcher(_port(**ctl, **kw), n_slots=2))
        assert [r["generated_ids"] for r in got] == [r["generated_ids"] for r in fixed], name
        if name == "adaptive":
            want = _serve(JaxBatcher(JaxEngine(JaxEngineConfig(
                implementation="hf", **dict(NGRAM, **ctl, **kw)), target_model=_target()),
                n_slots=2))
            for g, w in zip(got, want, strict=True):
                for key in ("generated_ids", "proposed", "accepted", "finish_reason"):
                    assert g[key] == w[key], (key, g[key], w[key])


def test_config_refuses_settings_outside_the_slice():
    for kw, err in ((dict(draft_mode="tree", kv_ring=True, prefill_chunk=32), ValueError),
                    (dict(draft_mode="tree", policy="typical"), NotImplementedError),
                    (dict(draft_mode="tree", controller="adaptive"), NotImplementedError),
                    (dict(draft_mode="lookahead"), ValueError),
                    (dict(policy="nope"), ValueError), (dict(controller="pid"), ValueError),
                    (dict(implementation="vllm"), ValueError),
                    (dict(implementation="fake", kv_layout="paged"), NotImplementedError),
                    (dict(ngram={"n": 0}), ValueError)):
        with pytest.raises(err):
            EngineConfig(**dict(NGRAM, **kw)).validate()

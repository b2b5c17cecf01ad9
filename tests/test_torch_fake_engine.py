"""The fake model (models/fake.py), the five policies and the three K
controllers through the port's Engine, against the JAX package on the CPU.

The fake model is the JAX package's central fixture: its next token is a
pure function of (token, position), and its draft ("fake-draft") misses 15%
of the target's predictions. The greedy runs hold the port's ids,
proposed, accepted, bonus tokens and steps to JAX's Engine exactly for
every deterministic policy; ``rejection`` draws its acceptance from the
key even under greedy decoding, and torch's numbers are not JAX's, so its
acceptance is held statistically. The controllers' K, ctrl_k and
acceptance trajectories, step by step, equal JAX's. JAX's observed loop
(the host adaptive controller, or any controller under
``EnvFlags(sync_steps=True)``) counts one step more than it commits in:
its poll lags a step; the port's loop runs that step too but its ``steps``
does not count it. A llama-tiny run of the device controller holds the
draft-cache rows of the forwards past each step's K to JAX's (they are
put back), through equal ids and acceptance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.config import EnvFlags as JaxEnvFlags
from llm_inference_lab_tpu.core import controllers as jc
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.core.state import init_state as jax_init_state
from llm_inference_lab_tpu.models.base import KVCache as JaxKVCache
from llm_inference_lab_tpu.models.fake import make_fake_model as jax_fake
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core import controllers as tc
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import registry
from llm_inference_lab_tpu_torch.models.base import KVCache
from llm_inference_lab_tpu_torch.models.fake import make_fake_model
from test_torch_decode_loop import one_thread  # noqa: F401

PROMPTS = ["fake model parity", "the quick brown fox " * 3, "ab"]
FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=4,
            max_new_tokens=32, max_seq_len=256)
SYNC = EnvFlags(sync_steps=True)


@pytest.mark.parametrize("miss", [0, 150])
def test_fake_forward_matches_jax(miss):
    """Logits of seeded tokens at seeded positions: the prediction (the
    argmax) exact, every logit within one f32 ulp (XLA's and torch's f32
    cos round differently in the last bit for about 6% of arguments), and
    the cache written exactly as JAX writes it (v alike)."""
    rng = np.random.default_rng(miss)
    B, S, T = 3, 6, 64
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    base = rng.integers(0, T - S, B).astype(np.int32)
    positions = base[:, None] + np.arange(S, dtype=np.int32)[None]
    jm, tm = jax_fake(miss_permille=miss), make_fake_model(miss_permille=miss)
    jlog, jcache = jm.apply_fn(jm.params, jnp.asarray(tokens), jnp.asarray(positions),
                               JaxKVCache.create(jm.config, B, T), jnp.asarray(base))
    cache = KVCache.create(tm.config, B, T, "cpu")
    tlog, _ = tm.forward(torch.from_numpy(tokens), torch.from_numpy(positions), cache,
                         torch.from_numpy(base))
    jlog = np.asarray(jlog)
    np.testing.assert_array_equal(tlog.argmax(-1).numpy(), jlog.argmax(-1))
    np.testing.assert_array_max_ulp(tlog.numpy(), jlog, maxulp=1)
    for got in (cache.k, cache.v):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jcache.k.astype(jnp.float32)))
    assert tm.config.vocab_size == jm.config.vocab_size and tm.config.dtype == torch.bfloat16


def test_registry_fake_entries():
    assert registry.create("fake").params["miss_permille"] == 0
    assert registry.create("fake-draft").params["miss_permille"] == 150
    assert registry.create("llama-3.2-3b", implementation="fake").config.name == "llama-3.2-3b"


def _jax(cfg, flags=None):
    return JaxEngine(JaxEngineConfig(**cfg), flags=flags or JaxEnvFlags())


def _port(cfg, flags=None):
    return Engine(EngineConfig(**cfg), device="cpu", flags=flags)


KEYS = ("generated_ids", "proposed", "accepted", "bonus_tokens", "steps")


@pytest.mark.parametrize("policy", ["longest_prefix", "conf_threshold", "topk_agree", "typical"])
def test_greedy_policies_equal_jax(policy):
    """K=4, three prompts in one batch: ids, proposed, accepted, bonus
    tokens and steps equal JAX's; the draft's misses give partial
    acceptance. longest_prefix and typical (whose bar of 0.9 only the
    argmax can pass) keep the greedy baseline's ids; conf_threshold and
    topk_agree accept tokens the target would not pick, in both packages."""
    cfg = dict(FAKE, policy=policy)
    got, want = _port(cfg).generate_batch(PROMPTS), _jax(cfg).generate_batch(PROMPTS)
    for g, w in zip(got, want, strict=True):
        for key in KEYS:
            assert g[key] == w[key], (key, g[key], w[key])
        assert g["policy"] == policy and g["impl"] == "fake"
    if policy in ("longest_prefix", "typical"):
        base = _port(dict(FAKE, draft_model=None)).generate_batch(PROMPTS)
        assert [r["generated_ids"] for r in got] == [r["generated_ids"] for r in base]
    accepted, proposed = (sum(r[key] for r in got) for key in ("accepted", "proposed"))
    if policy == "conf_threshold":  # the draft's top token has p about 0.9 >= tau 0.5
        assert accepted == proposed
    else:  # typical: the target's top token has p near its bar of 0.9
        assert 0 < accepted < proposed


def test_rejection_under_greedy_is_statistically_jax():
    """rejection at greedy: p_d is the draft's point mass, so a draft is
    kept with probability p_t(d) from the key. Over 8 prompts of 64 new
    tokens (about 400 proposals) the acceptance is within 0.1 of JAX's;
    every id is in the vocabulary; the device loop equals the host loop."""
    cfg = dict(FAKE, policy="rejection", max_new_tokens=64)
    prompts = [f"rejection check {i} " * (1 + i % 3) for i in range(8)]
    got, want = _port(cfg).generate_batch(prompts), _jax(cfg).generate_batch(prompts)

    def rate(rs):
        return sum(r["accepted"] for r in rs) / sum(r["proposed"] for r in rs)

    assert abs(rate(got) - rate(want)) < 0.1, (rate(got), rate(want))
    assert all(0 <= t < 256 for r in got for t in r["generated_ids"])
    host = _port(cfg, SYNC).generate_batch(prompts)
    for g, h in zip(got, host, strict=True):
        for key in KEYS:
            assert g[key] == h[key]


def _record_port(eng):
    """Wrap the port engine's steps: (ctrl_k, sum proposed, sum accepted)
    after each step, and the K of each step."""
    rows, ks = [], []

    def wrap(fn, k):
        def step(state):
            state = fn(state)
            ks.append(k)
            rows.append((state.ctrl_k.tolist(), int(state.proposed.sum()),
                         int(state.accepted.sum())))
            return state
        return step

    eng._step = wrap(eng._step, eng._k)
    inner = eng._step_at

    def step_at(k):
        fn, fn_in_place = inner(k)
        return wrap(fn, k), wrap(fn_in_place, k)

    eng._step_at = step_at
    return rows, ks


def _record_jax(jeng):
    rows, ks = [], []
    inner = jeng._get_step

    def get_step(k):
        fn = inner(k)

        def step(tp, dp, state):
            state = fn(tp, dp, state)
            ks.append(k)
            rows.append((np.asarray(state.ctrl_k).tolist(), int(jnp.sum(state.proposed)),
                         int(jnp.sum(state.accepted))))
            return state
        return step

    jeng._get_step = get_step
    return rows, ks


CONTROLLERS = {
    "fixed": {},
    "adaptive": dict(controller="adaptive", max_draft=2,
                     controller_params={"min_k": 1, "max_k": 6, "target_acceptance": 0.6,
                                        "window": 4}),
    "adaptive-device": dict(controller="adaptive-device", max_draft=2,
                            controller_params={"min_k": 1, "max_k": 5, "target_acceptance": 0.7,
                                               "window": 4}),
}


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_controller_trajectories_equal_jax(name):
    """Step by step under the host loop (sync_steps): the K of each step,
    each lane's ctrl_k and the sums of proposed and accepted equal JAX's
    observed loop, which runs one step more at the end (changing none of
    them). The results (ids, proposed, accepted, bonus, the controller's
    info) equal JAX's; the port's steps are JAX's minus that step. Then the
    port's default loop (the decode loop, or one step a K for the host
    controller) gives the same results, and its steps equal JAX's device
    loop's where JAX has one."""
    cfg = dict(FAKE, **CONTROLLERS[name])
    eng, jeng = _port(cfg, SYNC), _jax(cfg, JaxEnvFlags(sync_steps=True))
    rows, ks = _record_port(eng)
    jrows, jks = _record_jax(jeng)
    got, want = eng.generate_batch(PROMPTS), jeng.generate_batch(PROMPTS)
    if name == "adaptive":
        assert ks == jks and len(set(ks)) > 2, (ks, jks)
    else:
        assert ks[:len(rows)] == [eng._k] * len(rows)
    assert jrows[:-1] == rows[:len(jrows) - 1] and jrows[-1] == jrows[-2]
    if name == "adaptive-device":
        assert len({tuple(r[0]) for r in rows}) > 2  # K moves
    for g, w in zip(got, want, strict=True):
        for key in KEYS[:-1] + ("controller",):
            assert g[key] == w[key], (key, g[key], w[key])
        assert g["steps"] == w["steps"] - 1
    loop = _port(cfg).generate_batch(PROMPTS)
    for g, lo in zip(got, loop):
        for key in KEYS + ("controller",):
            assert g[key] == lo[key], key
    if name != "adaptive":
        device = _jax(cfg).generate_batch(PROMPTS)
        assert [r["steps"] for r in loop] == [r["steps"] for r in device]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_updates_equal_jax_classes(seed):
    """Seeded (proposed, accepted) sequences through the port's and JAX's
    controller classes: the same K and info after every update."""
    rng = np.random.default_rng(seed)
    params = dict(min_k=1, max_k=int(rng.integers(3, 9)),
                  target_acceptance=float(rng.uniform(0.3, 0.8)),
                  window=int(rng.integers(2, 40)), step_size=int(rng.integers(1, 3)))
    for name in ("fixed", "adaptive", "adaptive-device"):
        kw = {} if name == "fixed" else params
        ours, theirs = tc.create_controller(name, k=3, **kw), jc.create_controller(name, k=3, **kw)
        for _ in range(200):
            prop = int(rng.integers(0, 9))
            acc = int(rng.integers(0, prop + 1))
            ours.update(prop, acc)
            theirs.update(prop, acc)
            assert ours.get_k() == theirs.get_k() and ours.info() == theirs.info()
        if name == "adaptive-device":
            assert ours.adaptive_cfg() == theirs.adaptive_cfg()
    with pytest.raises(ValueError, match="unknown controller"):
        tc.create_controller("nope")


@functools.lru_cache(maxsize=None)
def _llama_pair():
    """llama-tiny target and a draft that agrees with it part of the time
    (projections x10, the draft mixed with a second model), from JAX."""
    def make(seed):
        m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(seed), dtype=jnp.float32)
        m.params = jax.tree_util.tree_map(lambda a: a * 10 if a.ndim >= 2 else a, m.params)
        return m

    target, draft, other = make(1), make(1), make(11)
    draft.params = jax.tree_util.tree_map(lambda a, b: 0.9 * a + 0.1 * b, draft.params,
                                          other.params)
    return target, draft


def _jax_final_state(jeng, block, plens, max_len, cfg):
    """JAX Engine.generate_batch's device-loop decode, returning its final
    state (the JAX engine hands out only results)."""
    state = jax_init_state(jeng.target, jeng.draft, len(plens), max_len,
                           max_new_tokens=cfg["max_new_tokens"], init_k=jeng.controller.k)
    tp, dp = jeng.target.params, jeng.draft.params
    state = jeng._prefill(tp, dp, state, jnp.asarray(block), jnp.asarray(plens))
    return jeng._get_loop(jeng.controller.get_k(0), max_steps=cfg["max_new_tokens"] + 1)(
        tp, dp, state)


def test_device_controller_on_llama_equals_jax():
    """The device controller on llama-tiny (K up to 4, from 2): JAX runs
    only the largest active lane's K draft forwards; the port runs 4 and
    puts back the draft-cache rows of the forwards past it. The final draft
    cache equals JAX's (f32, within 1e-4 of its largest value): a row kept
    would fill the draft cache's hole after a full accept (ROADMAP Queue 3)
    with the right key where JAX keeps a stale one. Ids, proposed,
    accepted, bonus, steps and the final per-lane K equal JAX's."""
    cfg = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=2,
               max_new_tokens=24, max_seq_len=256, dtype="float32",
               controller="adaptive-device",
               controller_params={"min_k": 1, "max_k": 4, "target_acceptance": 0.4,
                                  "window": 3})
    target, draft = _llama_pair()
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                     draft_model=draft)
    want = jeng.generate_batch(PROMPTS[:2])
    eng = Engine(EngineConfig(**cfg), device="cpu", target_params=params_from_jax(target.params),
                 draft_params=params_from_jax(draft.params))
    got = eng.generate_batch(PROMPTS[:2])
    state, plens, _, _ = eng.decode(PROMPTS[:2])
    jstate = _jax_final_state(jeng, *eng._prompt_block(PROMPTS[:2]), cfg)
    np.testing.assert_array_equal(state.tokens.numpy(), np.asarray(jstate.tokens))
    for ours, theirs in ((state.draft_cache.k, jstate.draft_cache.k),
                         (state.draft_cache.v, jstate.draft_cache.v)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-4 * np.abs(theirs).max())
    for g, w in zip(got, want, strict=True):
        for key in KEYS + ("controller",):
            if key == "controller":
                assert g[key]["final_k"] == w[key]["final_k"]
                np.testing.assert_allclose(g[key]["recent_acceptance"],
                                           w[key]["recent_acceptance"], atol=1e-4)
            else:
                assert g[key] == w[key], (key, g[key], w[key])
    assert 0 < sum(r["accepted"] for r in got) < sum(r["proposed"] for r in got)

"""The decode loop on the CPU: core/specstep.py ``make_decode_loop``, the
port of JAX's device-side while_loop, which the engine and the batcher run
by default. On the card it replays a CUDA graph of the in-place step; on the
CPU it runs the same in-place step eagerly, and these tests hold it to the
functional step (bit for bit), to the port's host loop
(``EnvFlags(sync_steps=True)``, exactly) and to the JAX Engine (its device
loop, and its host loop under ``EnvFlags(sync_steps=True)``).

Weights are made by the JAX package in f32 and carried over with
convert.params_from_jax: llama-tiny and mistral-tiny with projections x10,
gemma2-tiny unscaled (at x10 its head repeats one token), norms jittered;
each draft mixes a second model into the target so that it agrees only some
of the time.

The in-place step's tests are in test_torch_decode_loop_step.py and
test_torch_decode_loop_step_gemma.py, the batcher's in
test_torch_decode_loop_batcher.py; they import their helpers from here.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.config import EnvFlags as JaxEnvFlags
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.specstep import make_decode_loop
from llm_inference_lab_tpu_torch.core.state import FIELDS, state_tensors

PROMPTS = ["The quick brown fox jumps over the lazy dog.", "ring cache check " * 7]
MULT = {"llama-tiny": 10, "gemma2-tiny": 1, "mistral-tiny": 10}
# Engine settings of each KV cache kind.
CACHES = {
    "contiguous": {},
    "paged": dict(kv_layout="paged", kv_page_size=16),
    "int8": dict(kv_quantization="int8"),
    "ring": dict(prefill_chunk=32, kv_ring=True),  # mistral-tiny: 128 slots
    "ring int8": dict(prefill_chunk=32, kv_ring=True, kv_quantization="int8"),
}
SYNC = EnvFlags(sync_steps=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run on one intra-op thread: beside the other test
    workers on the same cores, torch's threads wait on each other at every
    small op (a serving test file ran 4x slower at the default count). The
    files that import this fixture share it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(name, seed):
    m = get_model(name, "hf", rng=jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)

    def scale(path, a):
        if "norm" in jax.tree_util.keystr(path):
            return a + jnp.asarray(rng.normal(0, 0.3, a.shape), a.dtype)
        return a * MULT[name] if a.ndim >= 2 else a

    m.params = jax.tree_util.tree_map_with_path(scale, m.params)
    return m


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The JAX target and draft of a model family."""
    target, draft = _jax_model(name, 1), _jax_model(name, 1)
    other = _jax_model(name, 11)
    draft.params = jax.tree_util.tree_map(lambda a, b: 0.9 * a + 0.1 * b, draft.params,
                                          other.params)
    return target, draft


def _config(name, k, **kw):
    return dict(dict(base_model=name, draft_model=name if k else None, max_draft=k or 1,
                     max_new_tokens=16, max_seq_len=512, dtype="float32"), **kw)


def _engine(cfg, flags=None):
    target, draft = _pair(cfg["base_model"])
    return Engine(EngineConfig(**cfg), device="cpu", flags=flags,
                  target_params=params_from_jax(target.params),
                  draft_params=params_from_jax(draft.params) if cfg["draft_model"] else None)


def _fields(state):
    return {name: getattr(state, name).clone() for name in FIELDS}


def _assert_same_tensors(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------ the loop, and JAX
def _eos_run_config():
    """llama-tiny K=2 on both prompts with an EOS id that lane 0 emits
    mid-generation (at its 6th token or later in a run without EOS) and lane
    1 never does."""
    cfg = _config("llama-tiny", 2)
    lane0, lane1 = (r["generated_ids"] for r in _engine(cfg, SYNC).generate_batch(PROMPTS))
    eos = next(t for t in lane0[5:] if t not in lane0[:5] + lane1)
    return dict(cfg, eos_token_id=eos)


RUNS = {
    "llama K=2 B=2 eos": None,  # _eos_run_config()
    "llama baseline": _config("llama-tiny", None),
    "gemma2 K=4": _config("gemma2-tiny", 4),
    "mistral ring K=3": _config("mistral-tiny", 3, **CACHES["ring"]),
}


def _prompts(run):
    return PROMPTS if "B=2" in run else PROMPTS[1:]


@functools.lru_cache(maxsize=None)
def _run_config(run):
    return RUNS[run] or _eos_run_config()


@functools.lru_cache(maxsize=None)
def _jax_results(run, sync=False):
    cfg = _run_config(run)
    target, draft = _pair(cfg["base_model"])
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                     draft_model=draft if cfg["draft_model"] else None,
                     flags=JaxEnvFlags(sync_steps=sync))
    return jeng.generate_batch(_prompts(run))


def _fixed_chunks(n):
    """Engine._run_loop with every chunk n steps (capped at max_new + 1
    steps in all): chunks run past the end of every lane."""

    def run_loop(loop, state, plens, max_new):
        steps = 0
        while bool(state.active.any()) and steps < max_new + 1:
            loop(state, min(n, max_new + 1 - steps))
            steps = int(state.steps)

    return run_loop


KEYS = ("generated_ids", "token_logprobs", "prompt_logprobs", "steps", "proposed", "accepted",
        "bonus_tokens")


@pytest.mark.parametrize("chunk", [1, 3, "engine"])
@pytest.mark.parametrize("run", list(RUNS))
def test_loop_equals_host_loop_and_jax(run, chunk):
    """Engine.generate_batch through the decode loop in chunks of 1 and 3
    steps and on the engine's own schedule: ids, token and prompt logprobs,
    steps, proposed, accepted and bonus tokens equal the port's host loop
    (sync_steps) exactly; ids, steps, proposed, accepted and bonus equal the
    JAX Engine's device loop and token logprobs are within 1e-4 (as in
    tests/test_torch_slice.py). The runs: llama-tiny K=2 on two prompts of
    44 and 119 tokens, lane 0 hitting EOS mid-generation while lane 1
    decodes on, the llama-tiny baseline, gemma2-tiny K=4 (the window of 16
    binds) and mistral-tiny K=3 on its ring."""
    cfg = _run_config(run)
    eng = _engine(cfg)
    if chunk != "engine":
        eng._run_loop = _fixed_chunks(chunk)
    got = eng.generate_batch(_prompts(run))
    host = _engine(cfg, SYNC).generate_batch(_prompts(run))
    want = _jax_results(run)
    assert len(got) == len(host) == len(want) == len(_prompts(run))
    for g, h, w in zip(got, host, want):
        for key in KEYS:
            assert g[key] == h[key], (key, g[key], h[key])
        for key in ("generated_ids", "steps", "proposed", "accepted", "bonus_tokens"):
            assert g[key] == w[key], (key, g[key], w[key])
        np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"], rtol=0, atol=1e-4)
    if "eos" in run:
        lane0, lane1 = got[0]["generated_ids"], got[1]["generated_ids"]
        assert lane0[-1] == cfg["eos_token_id"] and len(lane0) < cfg["max_new_tokens"]
        assert len(lane1) > len(lane0)
    if cfg["draft_model"]:
        assert 0 < sum(r["accepted"] for r in got) < sum(r["proposed"] for r in got)


def test_jax_host_loop_runs_one_step_more():
    """JAX's host loop (EnvFlags(sync_steps=True)) gives the ids, logprobs,
    proposed, accepted and bonus tokens of its device loop, and so of the
    port's loop, but counts one step more: its poll lags a step, so it runs
    one step after the last lane finished. The port's host loop polls before
    each step and counts what JAX's device loop counts."""
    run = "llama K=2 B=2 eos"
    dev, host = _jax_results(run), _jax_results(run, sync=True)
    ours = _engine(_run_config(run)).generate_batch(_prompts(run))
    for d, h, o in zip(dev, host, ours):
        for key in ("generated_ids", "proposed", "accepted", "bonus_tokens"):
            assert d[key] == h[key] == o[key]
        np.testing.assert_allclose(o["token_logprobs"], h["token_logprobs"], rtol=0, atol=1e-4)
        assert h["steps"] == d["steps"] + 1 == o["steps"] + 1


def test_replays_after_every_lane_finished_move_nothing():
    """After a decode, more steps of the engine's loop on its own decode
    state change no field; the committed rows of the caches stay too."""
    eng = _engine(_config("llama-tiny", 2, **CACHES["int8"]))
    eng.generate_batch(PROMPTS)
    (state, loop), = eng._decode_states.values()
    fields = _fields(state)
    n = int((state.lengths - 1).min())
    rows = [c[:, :, :, :n].clone() for c in (state.target_cache.k, state.target_cache.v,
                                             state.target_cache.k_scale)]
    assert not fields["active"].any() and int(fields["steps"]) > 0
    loop(state, 3)
    for name in FIELDS:
        assert torch.equal(fields[name], getattr(state, name)), name
    for before, c in zip(rows, (state.target_cache.k, state.target_cache.v,
                                state.target_cache.k_scale)):
        assert torch.equal(before, c[:, :, :, :n])


def test_engine_schedule_runs_no_step_past_the_end():
    """Without EOS, the engine's chunks (ceil(largest remaining budget / (K +
    1)) steps) run exactly the steps the host loop runs, in about log2 of
    the budget polls; the decode state and its loop are made once per shape
    and reused."""
    cfg = _config("llama-tiny", 1, max_new_tokens=32)
    eng, host = _engine(cfg), _engine(cfg, SYNC)
    calls, steps = [], []
    inner = eng._step_in_place

    def counted(state):
        steps.append(1)
        return inner(state)

    eng._step_in_place = counted
    run_loop = eng._run_loop

    def spy(loop, state, plens, max_new):
        def call(s, n):
            calls.append(n)
            return loop(s, n)

        return run_loop(call, state, plens, max_new)

    eng._run_loop = spy
    r = eng.generate(PROMPTS[1])
    want = host.generate(PROMPTS[1])
    assert r["generated_ids"] == want["generated_ids"] and r["steps"] == want["steps"]
    assert sum(calls) == len(steps) == r["steps"] > 16
    assert len(calls) <= 7, calls
    held = dict(eng._decode_states)
    eng.generate(PROMPTS[1])
    assert eng._decode_states.keys() == held.keys()
    assert all(eng._decode_states[k][0] is held[k][0] for k in held)


def test_decode_returns_a_state_no_later_call_changes():
    """Engine.decode hands out a copy of its decode state: a later decode
    of another prompt of the same shape, which reuses the engine's state,
    leaves the first result as it was."""
    eng = _engine(_config("llama-tiny", 2))
    first, plens, _, _ = eng.decode(PROMPTS[:1])
    kept = copy.deepcopy(first)
    assert not any(a is b for a, b in zip(state_tensors(first),
                                          state_tensors(next(iter(eng._decode_states.values()))[0]))
                   if a is not None)
    eng.decode(["another prompt of the same shape"])
    _assert_same_tensors(first, kept)


def test_loop_refuses_another_state():
    """A loop is bound to the tensors of the state of its first call: it
    refuses any other state, and a second bind."""
    eng = _engine(_config("llama-tiny", 2))
    block, plens, max_len = eng._prompt_block(PROMPTS)
    a = eng._init_state(2, max_len)
    loop = make_decode_loop(eng._step_in_place)
    loop(a, 1)
    with pytest.raises(ValueError, match="another state"):
        loop(copy.deepcopy(a), 1)
    with pytest.raises(ValueError, match="already bound"):
        loop.bind(a)


def test_env_flags_default_to_the_loop():
    """EnvFlags is the port's copy with its one field, sync_steps, False by
    default, and no from_env (the port reads no environment variable)."""
    assert EnvFlags().sync_steps is False and not hasattr(EnvFlags, "from_env")
    eng = _engine(_config("llama-tiny", 1))
    assert eng.flags == EnvFlags()
    assert ContinuousBatcher(eng, 2)._loop is not None
    assert ContinuousBatcher(_engine(_config("llama-tiny", 1), SYNC), 2)._loop is None

"""Medusa-lite and EAGLE-lite drafting (core/specstep.py ``draft_mode``
"medusa" and "eagle") against the JAX package on the CPU.

The heads draft from the target's hidden-state carry (DecodeState
last_hidden / prev_hidden), seeded by the prefill and moved by every step.
On the fake model (whose head is exact) and on llama-tiny f32 (weights and
heads carried over from the JAX package by convert.params_from_jax,
projections x10), generate at B=1 and B=3 and the batcher give JAX's ids,
proposed, accepted, bonus tokens and steps; the ids equal the greedy
baseline's; the in-place step equals the functional one bit for bit; the
port's one batched head call proposes what one head call a position does.
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
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.specstep import make_prefill, make_spec_step
from llm_inference_lab_tpu_torch.core.state import FIELDS, assign, init_state, state_tensors
from llm_inference_lab_tpu_torch.models.fake import make_fake_model

KEYS = ("generated_ids", "proposed", "accepted", "bonus_tokens", "steps")
MODES = ["medusa", "eagle"]
FAKE = dict(implementation="fake", base_model="fake", draft_model=None, max_draft=2,
            max_new_tokens=16, max_seq_len=256)
MULT = 10


@functools.lru_cache(maxsize=None)
def _target():
    m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(2), dtype=jnp.float32)
    m.params = jax.tree_util.tree_map(lambda a: a * MULT if a.ndim >= 2 else a, m.params)
    return m


TINY = dict(base_model="llama-tiny", draft_model=None, max_draft=3, max_new_tokens=24,
            max_seq_len=256, dtype="float32")
PROMPTS = ["abcabcabc xyz abcabc", "abc " * 8, "hello world"]


def _jax(**kw):
    cfg = dict(TINY, **kw)
    return JaxEngine(JaxEngineConfig(implementation="hf", kv_lazy_pages=False, **cfg),
                     target_model=_target())


def _port(jeng=None, flags=None, **kw):
    """The port's engine on llama-tiny with JAX's weights and, when jeng is
    given, its heads."""
    heads = params_from_jax(jeng._draft_params) if jeng is not None and jeng._draft_params \
        else None
    return Engine(EngineConfig(**dict(TINY, **kw)), device="cpu", flags=flags,
                  target_params=params_from_jax(_target().params), draft_params=heads)


def _same(got, want, keys=KEYS):
    for g, w in zip(got, want, strict=True):
        for key in keys:
            assert g[key] == w[key], (key, g[key], w[key])


@pytest.mark.parametrize("mode", MODES)
def test_fake_model_equals_jax_and_baseline(mode):
    """The fake model: ids equal the greedy baseline's; ids, proposed,
    accepted, bonus and steps equal JAX's Engine and the port's host loop;
    no draft model, no draft cache; medusa accepts (its head is exact)."""
    prompt = "draft mode test prompt"
    got = Engine(EngineConfig(draft_mode=mode, **FAKE), device="cpu").generate(prompt)
    host = Engine(EngineConfig(draft_mode=mode, **FAKE), device="cpu",
                  flags=EnvFlags(sync_steps=True)).generate(prompt)
    want = JaxEngine(JaxEngineConfig(draft_mode=mode, **FAKE)).generate(prompt)
    base = Engine(EngineConfig(**dict(FAKE, draft_model=None)), device="cpu").generate(prompt)
    _same([got, got], [want, host])
    assert got["generated_ids"] == base["generated_ids"]
    assert got["draft_mode"] == mode
    if mode == "medusa":
        assert got["accepted"] > 0


@pytest.fixture(scope="module")
def tiny_engines():
    out = {}
    for mode in MODES:
        jeng = _jax(draft_mode=mode)
        out[mode] = (jeng, _port(jeng, draft_mode=mode),
                     _port(jeng, EnvFlags(sync_steps=True), draft_mode=mode))
    return out


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_llama_tiny_equals_jax(tiny_engines, mode, batch):
    """llama-tiny f32 at B=1 and B=3: ids, proposed, accepted, bonus and
    steps equal JAX's and the host loop's (the host loop's logprobs
    exactly, JAX's within 1e-4: two f32 forwards); ids equal the greedy
    baseline's; acceptance above 0."""
    jeng, eng, host = tiny_engines[mode]
    prompts = PROMPTS[:batch]
    got, want, again = (e.generate_batch(prompts) for e in (eng, jeng, host))
    _same(got, want)
    _same(got, again, KEYS + ("token_logprobs",))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"], rtol=0, atol=1e-4)
    assert sum(r["accepted"] for r in got) > 0
    assert eng.draft is None and all(s.draft_cache is None
                                     for s, _ in eng._decode_states.values())
    base = _port(draft_mode="vanilla").generate_batch(prompts)
    assert [r["generated_ids"] for r in got] == [r["generated_ids"] for r in base]


@pytest.mark.parametrize("init", ["tie", "copy", "random"])
def test_medusa_head_init_variants(init):
    """tie and copy give identity heads, random identity plus small noise
    (the port's own generator); with JAX's random heads carried over, the
    port's run equals JAX's."""
    medusa = {"num_heads": 2, "head_init": init, "temperature": 0.7, "top_p": 0.9}
    eng = _port(draft_mode="medusa", medusa=medusa)
    proj = eng._draft_params["medusa_proj"]
    eye = torch.eye(proj.shape[1])
    assert proj.shape == (3, 64, 64)  # one head a draft position (max_draft 3)
    if init in ("tie", "copy"):
        assert all(torch.equal(p, eye) for p in proj)
    else:
        assert 0 < float((proj - eye).abs().max()) < 0.2
    jeng = _jax(draft_mode="medusa", medusa=medusa)
    _same(_port(jeng, draft_mode="medusa", medusa=medusa).generate_batch(PROMPTS[:1]),
          jeng.generate_batch(PROMPTS[:1]))


def test_medusa_heads_cover_adaptive_max_k():
    """A controller that may raise K past max_draft gets a head for every K
    up to its max_k (JAX's guard); the run at K = max_k gives the
    baseline's ids."""
    eng = Engine(EngineConfig(draft_mode="medusa", controller="adaptive",
                              controller_params={"max_k": 5, "target_acceptance": 0.0},
                              **FAKE), device="cpu")
    assert eng._draft_params["medusa_proj"].shape[0] == 5
    eng.controller.k = 5
    r = eng.generate("adaptive medusa guard")
    base = Engine(EngineConfig(**FAKE), device="cpu").generate("adaptive medusa guard")
    assert r["generated_ids"] == base["generated_ids"] and r["generated_tokens"] > 0


def test_eagle_alpha_config():
    """EAGLE's alpha reaches the extrapolation: alpha 0.3 gives JAX's
    proposals and acceptance at 0.3."""
    kw = dict(FAKE, draft_mode="eagle", eagle={"alpha": 0.3, "max_draft": 2})
    got = Engine(EngineConfig(**kw), device="cpu").generate("alpha cfg")
    _same([got], [JaxEngine(JaxEngineConfig(**kw)).generate("alpha cfg")])


def test_hidden_carry_updates():
    """The fake model's prefill seeds the carry with the hidden row of
    position plen - 2; an eagle step moves last_hidden, and prev_hidden
    takes the old last_hidden."""
    t = make_fake_model()
    state = init_state(t, None, 1, 128, "cpu")
    state = make_prefill(t, None, hidden=True)(state, torch.ones((1, 8), dtype=torch.int32),
                                               torch.full((1,), 5, dtype=torch.int32))
    h0 = state.last_hidden.clone()
    assert h0[0, :2].tolist() == [1.0, 3.0]  # token 1 at position 5 - 2
    state = make_spec_step(t, None, k=2, draft_mode="eagle")(state)
    assert not torch.equal(state.last_hidden, h0)
    assert torch.equal(state.prev_hidden, h0)


@pytest.mark.parametrize("mode", MODES)
def test_chunked_prefill_carry_equals_single_shot(mode):
    """A prompt prefilled in chunks of 32 seeds the same carry as one forward
    over it (within 1e-5: the rows come from forwards over other spans), and
    generate gives the same ids (JAX's test_chunked_prefill_medusa_hidden_carry),
    B=3 with prompts ending in the first and a later chunk."""
    prompts = ["a longer prompt that spans two chunks of the prefill " * 2, "short", "x" * 40]
    runs = {}
    for chunk in (None, 32):
        eng = _port(draft_mode=mode, prefill_chunk=chunk)
        block, plens, max_len = eng._prompt_block(prompts)
        with torch.inference_mode():
            st = eng._prefill(eng._init_state(3, max_len), torch.from_numpy(block),
                              torch.from_numpy(plens))
        runs[chunk] = (st.last_hidden, st.prev_hidden, eng.generate_batch(prompts))
    (h1, p1, r1), (h2, p2, r2) = runs[None], runs[32]
    assert torch.equal(h2, p2) and h1.abs().max() > 0
    torch.testing.assert_close(h2, h1, rtol=0, atol=1e-5)
    assert [r["generated_ids"] for r in r1] == [r["generated_ids"] for r in r2]


@pytest.mark.parametrize("mode", MODES)
def test_in_place_step_equals_functional_step(mode):
    """The in-place step (the decode loop's) against the functional one, two
    prompts until both lanes finish and two steps beyond: every field, the
    carry included, and the caches equal bit for bit; the state's own
    tensors stay; a step after every lane finished changes nothing."""
    eng = _port(draft_mode=mode, max_new_tokens=10)
    block, plens, max_len = eng._prompt_block(PROMPTS[:2])
    prompt = torch.from_numpy(block), torch.from_numpy(plens)
    with torch.inference_mode():
        functional = eng._prefill(eng._init_state(2, max_len), *prompt)
        in_place = eng._init_state(2, max_len)
        assign(in_place, eng._prefill(in_place, *prompt))
        own = state_tensors(in_place)
        finished = 0
        for _ in range(eng.config.max_new_tokens + 2):
            before = {n: getattr(in_place, n).clone() for n in FIELDS}
            functional = eng._step(functional)
            assert eng._step_in_place(in_place) is in_place
            assert all(a is b for a, b in zip(own, state_tensors(in_place)))
            for a, b in zip(state_tensors(functional), state_tensors(in_place)):
                assert (a is None and b is None) or torch.equal(a, b)
            if not before["active"].any():
                finished += 1
                assert all(torch.equal(before[n], getattr(in_place, n)) for n in FIELDS)
    assert finished >= 2


def _capture(store):
    """A policy that keeps the drafts and draft logits it is given and
    accepts nothing."""
    def policy(key, draft_tokens, draft_logits, target_logits, **_):
        store["d"], store["logits"] = draft_tokens, draft_logits
        return draft_tokens[:, 0] * 0

    policy.needs_draft_logits = True
    return policy


@pytest.mark.parametrize("mode", MODES)
def test_batched_head_call_equals_head_per_position(mode):
    """The step's one head call over [B * K, D] rows proposes exactly what
    JAX's one head call a draft position gives (argmax of the target's head
    over h @ proj[i], or over the extrapolated carry), logits bit for bit,
    on a seeded carry (B=3, K=3, random heads)."""
    eng = _port(draft_mode=mode, medusa={"head_init": "random"})
    rng = np.random.default_rng(7)
    state = init_state(eng.target, None, 3, 64, "cpu")
    state.tokens.copy_(torch.from_numpy(rng.integers(1, 200, (3, 64)).astype(np.int32)))
    state.lengths.fill_(20)
    state.active.fill_(True)
    for name in ("last_hidden", "prev_hidden"):
        getattr(state, name).copy_(torch.from_numpy(rng.normal(0, 1, (3, 64)).astype(np.float32)))
    store = {}
    with torch.inference_mode():
        make_spec_step(eng.target, None, k=3, policy_fn=_capture(store), draft_mode=mode,
                       draft_params=eng._draft_params, eagle_cfg=eng.config.eagle)(state)
        rows = []
        h, h_prev = state.last_hidden, state.prev_hidden
        for i in range(3):
            if mode == "medusa":
                x = state.last_hidden @ eng._draft_params["medusa_proj"][i]
            else:
                h_prev, h = h, h + 0.7 * (h - h_prev)
                x = h
            rows.append(eng.target.head(x))
    want = torch.stack(rows, 1)
    assert torch.equal(store["logits"], want)
    assert torch.equal(store["d"], want.argmax(-1).to(torch.int32))


SERVE_REQUESTS = [("abcabcabc xyz abcabc", 20), ("hello world", 9), ("ab" * 10, 16),
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
@pytest.mark.parametrize("mode", MODES)
def test_batcher_equals_jax_and_generate(mode, layout):
    """The batcher (2 slots, 4 requests, one step a poll; admission seeds
    each slot's carry): ids, proposed and accepted equal JAX's batcher; ids
    equal the start of the port's own generate for each prompt."""
    kw = dict(draft_mode=mode, kv_layout=layout, kv_page_size=16)
    jeng = _jax(**kw)
    want = _serve(JaxBatcher(jeng, n_slots=2))
    eng = _port(jeng, **kw)
    got = _serve(ContinuousBatcher(eng, n_slots=2))
    _same(got, want, ("generated_ids", "proposed", "accepted", "finish_reason"))
    for r, (prompt, budget) in zip(got, SERVE_REQUESTS):
        assert r["generated_ids"] == eng.generate(prompt)["generated_ids"][:budget]

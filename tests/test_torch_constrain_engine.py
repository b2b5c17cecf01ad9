"""Grammar-constrained decoding and forced tool calls through the port's
Engine and ContinuousBatcher, against the JAX package on the CPU (port of
tests/test_constrain_engine.py and the engine and batcher cases of
tests/test_tools.py).

The fake model and the ByteTokenizer give exact tables. Under every
grammar key (json, json_object, json_schema, regex, the tool keys),
``generate`` gives JAX's ids, proposed, accepted and steps, spec and
baseline, in the draft modes vanilla, ngram, Medusa and EAGLE, on the decode
loop and the host loop, and every completed output passes an independent
check (json.loads, re.fullmatch, the schema's fields and types, the tool's
name and arguments). On llama-tiny (f32, JAX's weights through
convert.params_from_jax) the same holds for a schema, a regex and the
tools. Greedy spec ids equal the baseline's under the same grammar; a
sampled run (per-request seed) stays valid; tree mode raises JAX's message;
an unconstrained call on a table-carrying engine runs the unconstrained
step and gives an engine without tables' ids. The batcher isolates
constrained and free requests (JAX's ids for each), resets a reused slot's
FSM, and resumes a preempted constrained request with its FSM walked over
what it generated, where JAX restarts the grammar (pinned below).
"""

import functools
import json
import re

import jax
import jax.numpy as jnp
import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.constrain import runtime as rt
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from test_torch_decode_loop import SYNC, one_thread  # noqa: F401
from test_torch_lazy_pages import LAZY, drive, jax_batcher, port_engine, reference_ids

FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=3,
            max_new_tokens=32)
SCHEMA = {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"enum": ["x", "y"]}}}
REGEX = "(yes|no)"
# Bounded arguments (enums, booleans): every call completes inside the budget.
TOOLS = [
    {"type": "function", "function": {"name": "get_time", "parameters": {
        "type": "object", "properties": {"tz": {"enum": ["utc", "local"]}}}}},
    {"type": "function", "function": {"name": "toggle", "parameters": {
        "type": "object", "properties": {"on": {"type": "boolean"}}}}},
]
# grammar -> (engine settings, the grammar keys generate is called with;
# None: the deployment's default).
GRAMMARS = {
    "json": (dict(constrain="json"), [None, "json", "json_object"]),
    "json_schema": (dict(constrain="json_schema", constrain_schema=SCHEMA), [None]),
    "regex": (dict(constrain="regex", constrain_regex=REGEX), ["regex"]),
    "tools": (dict(tools=TOOLS, max_new_tokens=64),
              ["tool_call", "tool_call:get_time", "tool_call:toggle"]),
}
CASES = [(g, key) for g, (_, keys) in GRAMMARS.items() for key in keys]
KEYS = ("generated_ids", "proposed", "accepted", "steps")


def valid(text, grammar, key):
    """The independent check of a completed output: the text parses, the
    schema's fields have their types and order, the regex matches whole,
    the tool call names a tool (the forced one) with arguments of its
    shape."""
    if grammar == "regex":
        return re.fullmatch(REGEX, text) is not None
    obj = json.loads(text)
    if key == "json_object":
        assert isinstance(obj, dict)
    if grammar == "json_schema":
        assert list(obj) == ["a", "b"] and isinstance(obj["a"], int) and obj["b"] in ("x", "y")
    if grammar == "tools":
        assert set(obj) == {"name", "arguments"}
        args = obj["arguments"]
        if ":" in key:
            assert obj["name"] == key.split(":", 1)[1]
        assert (list(args) == ["tz"] and args["tz"] in ("utc", "local")
                if obj["name"] == "get_time" else list(args) == ["on"]
                and isinstance(args["on"], bool))
    return True


@functools.lru_cache(maxsize=None)
def _jax_fake(grammar, **kw):
    return JaxEngine(JaxEngineConfig(**{**FAKE, **GRAMMARS[grammar][0], **kw}))


def _port_fake(grammar, flags=None, **kw):
    cfg = {**FAKE, "max_seq_len": 512, **GRAMMARS[grammar][0], **kw}
    return Engine(EngineConfig(**cfg), device="cpu", flags=flags)


def _same(got, want, keys=KEYS):
    for key in keys:
        assert got[key] == want[key], (key, got[key], want[key])


@pytest.mark.parametrize("spec", ["spec", "baseline"])
@pytest.mark.parametrize("grammar, key", CASES)
def test_fake_generate_equals_jax(grammar, key, spec):
    """Each grammar key, spec (a fake draft, K=3) and baseline: JAX's ids,
    proposed, accepted and steps, on the decode loop and the host loop;
    the output passes the independent check; a finite grammar (all but
    generic json, which may run to the budget) ends in EOS inside it."""
    kw = {} if spec == "spec" else dict(draft_model=None)
    want = _jax_fake(grammar, **kw).generate("emit it", response_format=key)
    got = _port_fake(grammar, **kw).generate("emit it", response_format=key)
    host = _port_fake(grammar, SYNC, **kw).generate("emit it", response_format=key)
    _same(got, want)
    _same(host, want)
    assert valid(got["text"], grammar, key or GRAMMARS[grammar][0].get("constrain"))
    if grammar != "json":
        budget = {**FAKE, **GRAMMARS[grammar][0]}["max_new_tokens"]
        assert got["generated_ids"][-1] == 0 and got["generated_tokens"] < budget


@pytest.mark.parametrize("mode", ["ngram", "medusa", "eagle", "adaptive-device", "adaptive"])
@pytest.mark.parametrize("grammar, key", [("json", "json_object"), ("tools", "tool_call")])
def test_fake_draft_modes_equal_jax_and_baseline(grammar, key, mode):
    """ngram, Medusa and EAGLE drafting (no draft model), the device-side
    adaptive K and the host adaptive controller (its steps at each K, the
    constrained step's) under a grammar: JAX's ids and counts (JAX's host
    loop counts one step more: test_torch_fake_engine.py), the constrained
    baseline's ids, a valid output."""
    kw = (dict(controller=mode, controller_params={"max_k": 4}) if mode.startswith("adaptive")
          else dict(draft_model=None, draft_mode=mode))
    want = JaxEngine(JaxEngineConfig(**{**FAKE, **GRAMMARS[grammar][0], **kw}))
    got = _port_fake(grammar, **kw).generate("modes", response_format=key)
    _same(got, want.generate("modes", response_format=key),
          KEYS[:-1] if mode == "adaptive" else KEYS)
    base = _port_fake(grammar, draft_model=None).generate("modes", response_format=key)
    assert got["generated_ids"] == base["generated_ids"]
    assert valid(got["text"], grammar, key)


def test_refusals_name_themselves():
    """JAX's checks and messages: tree mode, an unknown constrain value,
    json_schema / regex without their schema / pattern, tools with
    constrain; a key the grammar cannot serve, and any key on an engine
    without tables (nothing decodes unconstrained in its place)."""
    for kw, words in [(dict(constrain="json", draft_model=None, draft_mode="tree"), "tree mode"),
                      (dict(constrain="yaml"), "constrain must be"),
                      (dict(constrain="json_schema"), "requires constrain_schema"),
                      (dict(constrain="regex"), "requires constrain_regex"),
                      (dict(constrain="json", tools=TOOLS), "mutually exclusive")]:
        with pytest.raises(ValueError, match=words):
            Engine(EngineConfig(**dict(FAKE, **kw)), device="cpu")
        with pytest.raises(ValueError, match=words):
            JaxEngine(JaxEngineConfig(**dict(FAKE, **kw)))
    tools = _port_fake("tools")
    for key in ("json", "tool_call:nope"):
        with pytest.raises(ValueError, match="cannot serve"):
            tools.generate("x", response_format=key)
    with pytest.raises(ValueError, match="requires the engine to be built"):
        Engine(EngineConfig(**FAKE), device="cpu").generate("x", response_format="json")


def test_unconstrained_call_on_a_table_engine():
    """A tools engine decodes unconstrained by default and a json engine on
    response_format None follows its grammar (JAX's defaults); an
    unconstrained call replays the unconstrained loop, the one an engine
    without tables replays, and gives its ids."""
    plain = Engine(EngineConfig(**dict(FAKE, max_new_tokens=64, max_seq_len=512)), device="cpu")
    tools = _port_fake("tools")
    got, want = tools.generate("free text"), plain.generate("free text")
    _same(got, want)
    assert got["generated_ids"] == _jax_fake("tools").generate("free text")["generated_ids"]
    assert tools._fsm_loops == {} and len(tools._decode_states) == 1
    tools.generate("free text", response_format="tool_call")
    assert len(tools._fsm_loops) == 1
    again = tools.generate("free text")
    _same(again, want)


def test_constrained_chunks_are_capped():
    """A constrained call replays its loop in chunks of at most FSM_CHUNK
    steps (a finite grammar ends in EOS long before the budget): a 3-token
    answer under a 64-token budget runs one chunk of FSM_CHUNK steps, not
    the budget's 64; the ids and steps are the host loop's, and an
    unconstrained call keeps the budget's chunk."""
    from llm_inference_lab_tpu_torch.core.engine import FSM_CHUNK

    eng = _port_fake("regex", draft_model=None, max_new_tokens=64)
    calls = []
    eng.generate("warm", response_format="regex")
    for loop in list(eng._fsm_loops.values()) + [s[1] for s in eng._decode_states.values()]:
        inner = loop.step
        loop.step = lambda state, inner=inner: calls.append(1) or inner(state)
    got = eng.generate("answer", response_format="regex")
    assert len(calls) == FSM_CHUNK and eng.polls == 1 and got["steps"] < FSM_CHUNK
    _same(got, _port_fake("regex", SYNC, draft_model=None, max_new_tokens=64).generate(
        "answer", response_format="regex"))
    tools = _port_fake("tools", draft_model=None)
    tools.generate("free")
    (state, loop), = tools._decode_states.values()
    inner, calls = loop.step, []
    loop.step = lambda s: calls.append(1) or inner(s)
    tools.generate("free")
    assert calls[:1] and len(calls) >= 64


def test_sampled_runs_stay_valid():
    """Sampling (temperature 0.9, per-call seeds) under the schema and the
    regex: every output passes the check and the same seed repeats (JAX's
    draws are not the port's, so no id comparison)."""
    for grammar in ("json_schema", "regex"):
        eng = _port_fake(grammar, greedy=False, temperature=0.9)
        key = GRAMMARS[grammar][1][0]
        outs = [eng.generate("sample", seed=s, response_format=key) for s in (1, 2, 3, 1)]
        for r in outs:
            assert valid(r["text"], grammar, key)
        assert outs[0]["generated_ids"] == outs[3]["generated_ids"]


# ------------------------------------------------------------------ llama-tiny
@functools.lru_cache(maxsize=None)
def _tiny_target():
    m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(2), dtype=jnp.float32)
    m.params = jax.tree_util.tree_map(lambda a: a * 10 if a.ndim >= 2 else a, m.params)
    return m


TINY = dict(base_model="llama-tiny", draft_model=None, max_draft=3, max_new_tokens=40,
            max_seq_len=256, dtype="float32")
TINY_GRAMMARS = {"json_schema": "json_schema", "regex": "regex", "tools": "tool_call:get_time"}


@functools.lru_cache(maxsize=None)
def _tiny_jax(grammar, mode):
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", draft_mode=mode,
                                     **{**TINY, **GRAMMARS[grammar][0]}),
                     target_model=_tiny_target())
    return jeng


def _tiny_port(grammar, mode, jeng, flags=None):
    heads = params_from_jax(jeng._draft_params) if jeng._draft_params else None
    return Engine(EngineConfig(draft_mode=mode, **{**TINY, **GRAMMARS[grammar][0]}),
                  device="cpu", flags=flags, target_params=params_from_jax(_tiny_target().params),
                  draft_params=heads)


@pytest.mark.parametrize("mode", ["vanilla", "ngram", "medusa", "eagle"])
@pytest.mark.parametrize("grammar", list(TINY_GRAMMARS))
def test_llama_tiny_equals_jax(grammar, mode):
    """llama-tiny f32 under a schema, a regex and a forced tool: JAX's ids
    and counts in each draft mode (vanilla: the target as its own draft),
    the host loop's, the constrained baseline's; a valid output."""
    key = TINY_GRAMMARS[grammar]
    prompt = "abc " * 6
    if mode == "vanilla":
        jeng = JaxEngine(JaxEngineConfig(implementation="hf", **{
            **TINY, "draft_model": "llama-tiny", **GRAMMARS[grammar][0]}),
            target_model=_tiny_target(), draft_model=_tiny_target())
        p = params_from_jax(_tiny_target().params)
        eng = Engine(EngineConfig(**{**TINY, "draft_model": "llama-tiny", **GRAMMARS[grammar][0]}),
                     device="cpu", target_params=p, draft_params=p)
    else:
        jeng = _tiny_jax(grammar, mode)
        eng = _tiny_port(grammar, mode, jeng)
    want = jeng.generate(prompt, response_format=key)
    got = eng.generate(prompt, response_format=key)
    _same(got, want)
    base = _tiny_port(grammar, "vanilla", _tiny_jax(grammar, "vanilla"), SYNC).generate(
        prompt, response_format=key)
    assert got["generated_ids"] == base["generated_ids"]
    assert valid(got["text"], grammar, key)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", ["baseline", "vanilla", "ngram", "medusa", "eagle", "tree"])
def test_feature_matrix_constrain_cells(mode, layout):
    """JAX's feature matrix (llm_inference_lab_tpu/features.py) for
    constrain: the port refuses the cells JAX refuses, with its message,
    and in every other cell a schema-constrained generate on llama-tiny
    (the port's own weights from the seed) commits ids the automaton
    accepts, equal to the constrained baseline's on the same layout."""
    from llm_inference_lab_tpu.features import expected_error

    cfg = {**TINY, **GRAMMARS["json_schema"][0], "kv_layout": layout, "kv_page_size": 16,
           "draft_model": "llama-tiny" if mode == "vanilla" else None,
           "draft_mode": "vanilla" if mode == "baseline" else mode}
    refused = expected_error(mode, layout, "constrain")
    if refused:
        with pytest.raises(ValueError, match=refused):
            Engine(EngineConfig(**cfg), device="cpu")
        return
    eng = Engine(EngineConfig(**cfg), device="cpu")
    got = eng.generate("abc " * 6)
    base = Engine(EngineConfig(**{**cfg, "draft_model": None, "draft_mode": "vanilla"}),
                  device="cpu", target_params=eng.target.params).generate("abc " * 6)
    assert got["generated_ids"] == base["generated_ids"]
    lex, _, _ = rt.walk_tokens(eng.constrain_tables, eng._resolve_fsm_initial(None),
                               got["generated_ids"])
    assert lex >= 0


# -------------------------------------------------------------------- batcher
def test_batcher_isolation_equals_jax():
    """response_format constrains only its slot: three requests in one
    batch give JAX's ids; the free neighbour's ids equal those of an engine
    without tables; the constrained outputs pass the check; the batch ran
    the constrained step while a constrained request decoded."""
    reqs = [("json please", "json"), ("free neighbour", None), ("obj", "json_object")]

    def serve(b):
        rids = [b.submit(p, response_format=rf) for p, rf in reqs]
        out = {r["req_id"]: r for r in b.run()}
        return [out[r] for r in rids]

    want = serve(JaxBatcher(_jax_fake("json"), n_slots=3))
    for flags in (None, SYNC):
        b = ContinuousBatcher(_port_fake("json", flags), n_slots=3)
        got = serve(b)
        for g, w in zip(got, want):
            assert g["generated_ids"] == w["generated_ids"]
        assert b.stats.constrained_steps > 0
    assert valid(got[0]["text"], "json", "json") and valid(got[2]["text"], "json", "json_object")
    plain = ContinuousBatcher(Engine(EngineConfig(**dict(FAKE, max_seq_len=512)), device="cpu"),
                              n_slots=3)
    rid = plain.submit("free neighbour")
    assert plain.run()[0]["generated_ids"] == got[1]["generated_ids"]


def test_batcher_slot_reuse_resets_the_fsm():
    """One slot serves a constrained, a free and a json_object request in
    turn: each starts from its own grammar state (JAX's ids); a free-only
    batch runs the unconstrained step."""
    reqs = [("a", "json"), ("b", None), ("c", "json_object"), ("d", "tool_call:toggle")]
    outs = []
    for grammar in ("json", "tools"):
        for B, eng in ((JaxBatcher, _jax_fake(grammar, max_new_tokens=12)),
                       (ContinuousBatcher, _port_fake(grammar, max_new_tokens=12))):
            b = B(eng, n_slots=1)
            served = [(p, rf) for p, rf in reqs if rf is None
                      or (rf.startswith("tool") == (grammar == "tools"))]
            rids = [b.submit(p, response_format=rf) for p, rf in served]
            out = {r["req_id"]: r for r in b.run()}
            outs.append([out[r]["generated_ids"] for r in rids])
        assert outs[-1] == outs[-2]
    free = ContinuousBatcher(_port_fake("json"), n_slots=2)
    free.submit("b")
    free.run()
    assert free.stats.constrained_steps == 0 and free.stats.steps > 0


def test_batcher_refuses_what_it_cannot_serve():
    """A key on an engine without tables, and a key the grammar lacks,
    raise at submit (JAX raises at admission); nothing is queued."""
    b = ContinuousBatcher(Engine(EngineConfig(**dict(FAKE, max_seq_len=512)), device="cpu"), 2)
    with pytest.raises(ValueError, match="requires the engine"):
        b.submit("x", response_format="json")
    t = ContinuousBatcher(_port_fake("tools"), 2)
    with pytest.raises(ValueError, match="cannot serve"):
        t.submit("x", response_format="tool_call:nope")
    assert not b.scheduler.pending() and not t.scheduler.pending()
    rid = t.submit("tool please", response_format="tool_call:get_time")
    out = {r["req_id"]: r for r in t.run()}[rid]
    assert valid(out["text"], "tools", "tool_call:get_time")


# ------------------------------------------------ preemption of a constrained request
# Exactly 44 letters, then EOS: a request cannot finish before its 44th
# token, and a restart of the grammar after a preemption runs it past 44.
PREEMPT_REGEX = "[a-z]{44}"
PREEMPT = dict(LAZY, kv_pages=8, constrain="regex", constrain_regex=PREEMPT_REGEX,
               eos_token_id=None)
PREEMPT_REQS = [("preempt victim check", 48), ("preempt survivor check", 48)]


def _constrained(b):
    submit = b.submit
    b.submit = lambda p, max_new_tokens=None: submit(p, max_new_tokens=max_new_tokens,
                                                     response_format="regex")
    return b


def test_jax_resume_restarts_the_grammar():
    """Pinned reference fault: JAX's batcher readmits a preempted request
    with its prompt + generated tokens but the grammar's initial state
    (core/batching.py _admission_meta), so after its partial match it must
    spell a fresh one: it runs to its budget and does not match, where its
    unpreempted run matches. (The port walks the FSM instead: below.)"""
    jb = _constrained(jax_batcher(PREEMPT, 2))
    got, _ = drive(jb, PREEMPT_REQS)
    resumed = [rid for rid in got if jb._done[rid].resume_ids is not None]
    assert jb.stats.preemptions >= 1 and resumed
    ref = reference_ids(PREEMPT, PREEMPT_REQS)
    for rid in resumed:
        r = got[rid]
        assert r["finish_reason"] == "length" and re.fullmatch(PREEMPT_REGEX, r["text"]) is None
        assert r["generated_ids"] != ref[rid]
    for rid in set(got) - set(resumed):
        assert got[rid]["generated_ids"] == ref[rid]


@pytest.mark.parametrize("flags", ["loop", "host step"])
def test_port_resume_walks_the_fsm(flags):
    """The port's fix: the preempted request resumes with its FSM walked
    over the tokens it generated before (the same state the slot held), so
    its output matches the regex and equals its unpreempted run's ids, as
    the other request's do; the stats equal JAX's (the same preemption)."""
    b = _constrained(ContinuousBatcher(port_engine(PREEMPT, None if flags == "loop" else SYNC), 2))
    walked = []
    inner = b._fsm_of

    def fsm_of(req):
        out = inner(req)
        if req.resume_ids is not None:
            walked.append((req, out))
        return out

    b._fsm_of = fsm_of
    got, _ = drive(b, PREEMPT_REQS)
    assert b.stats.preemptions >= 1 and walked
    ref = reference_ids(PREEMPT, PREEMPT_REQS)
    for rid, r in got.items():
        assert r["generated_ids"] == ref[rid]
        assert re.fullmatch(PREEMPT_REGEX, r["text"]) and r["finish_reason"] == "stop"
    for req, (lex, stack, sp) in walked:
        n = len(req.resume_ids) - len(req.ids)
        assert n > 0 and lex == rt.walk_tokens(b.engine.constrain_tables, req.fsm_init,
                                                req.resume_ids[len(req.ids):])[0] != req.fsm_init


def test_engine_generate_batch_and_tool_default():
    """generate_batch under one key (the whole batch) gives JAX's ids for
    each row; EnvFlags as the loop's."""
    prompts = ["one", "a longer second prompt"]
    want = _jax_fake("regex").generate_batch(prompts, response_format="regex")
    got = _port_fake("regex").generate_batch(prompts, response_format="regex")
    host = _port_fake("regex", EnvFlags(sync_steps=True)).generate_batch(
        prompts, response_format="regex")
    for g, h, w in zip(got, host, want, strict=True):
        _same(g, w)
        _same(h, w)
        assert valid(g["text"], "regex", "regex")

"""The port's grammar runtime (llm_inference_lab_tpu_torch/constrain/runtime.py,
torch) against JAX's constrain/runtime.py on the CPU: exact equality.

States are reachable ones: random walks of valid tokens from each grammar's
initial state through JAX's own transition (so the stacks hold what decoding
puts there), with dead (-2) and unconstrained (-1) rows and full-stack rows
(sp = STACK_DEPTH) mixed in. On the same tables, ``token_mask``,
``transition`` (valid, invalid and EOS tokens, with and without ``active``),
``walk_window`` and ``window_mask`` give JAX's booleans and integers; and
the host walk ``walk_tokens`` gives ``transition``'s state token by token.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.constrain import jsonfsm as jax_jsonfsm
from llm_inference_lab_tpu.constrain import runtime as jax_rt
from llm_inference_lab_tpu.constrain.regex import build_regex_automaton as jax_regex
from llm_inference_lab_tpu.constrain.schema import build_schema_automaton as jax_schema
from llm_inference_lab_tpu.constrain.tools import build_tools_automaton as jax_tools
from llm_inference_lab_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from llm_inference_lab_tpu_torch.constrain import runtime as rt
from llm_inference_lab_tpu_torch.constrain.jsonfsm import SYM_OBJ, TokenTables
from test_torch_decode_loop import one_thread  # noqa: F401

V = 300
EOS = 0
TOOLS = [{"type": "function", "function": {"name": "get_time", "parameters": {
    "type": "object",
    "properties": {"tz": {"enum": ["utc", "local"]}, "n": {"type": "integer"}}}}}]
GRAMMARS = {
    "json": lambda: jax_jsonfsm.json_char_automaton(),
    "schema": lambda: jax_schema({"type": "object", "properties": {
        "a": {"type": "array", "items": {"type": "integer"}}, "b": {"type": "string"}}}),
    "regex": lambda: jax_regex(r"(ab|cd)+[0-9]{2}"),
    "tools": lambda: jax_tools(TOOLS)[0],
}


@functools.lru_cache(maxsize=None)
def _tables(grammar):
    """JAX's TokenTables of a grammar on the ByteTokenizer at V, and both
    packages' device tables of them."""
    tb, tl = jax_jsonfsm.token_bytes_of(JaxByteTokenizer(), V)
    tt = jax_jsonfsm.compile_token_tables(GRAMMARS[grammar](), tb, tl, eos_id=EOS)
    port_tt = TokenTables(**{k: getattr(tt, k) for k in TokenTables.__dataclass_fields__})
    return tt, jax_rt.device_tables(tt), rt.device_tables(port_tt, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_walkers(grammar):
    """JAX's token_mask and transition over one grammar's tables, jitted:
    the single-row walks below call them token by token."""
    _, jtbl, _ = _tables(grammar)
    return (jax.jit(lambda l, s, p: jax_rt.token_mask(jtbl, l, s, p)),
            jax.jit(lambda l, s, p, t: jax_rt.transition(jtbl, l, s, p, t)))


@functools.lru_cache(maxsize=None)
def _states(grammar, n=48, seed=0):
    """n reachable FSM rows (lex, stack, sp): random walks of valid tokens
    from the initial state (json: json_object's too) through JAX's
    transition, each row a prefix of a walk, plus dead, unconstrained and
    full-stack rows."""
    tt, _, _ = _tables(grammar)
    mask_fn, step_fn = _jax_walkers(grammar)
    rng = np.random.default_rng(seed)
    inits = [tt.initial, tt.initial_objonly] if grammar == "json" else [tt.initial]
    rows = []
    while len(rows) < n:
        lex, stack, sp = (jnp.array([rng.choice(inits)], jnp.int32),
                          jnp.zeros((1, jax_rt.STACK_DEPTH), jnp.int32),
                          jnp.zeros((1,), jnp.int32))
        for _ in range(rng.integers(0, 24)):
            mask = np.array(mask_fn(lex, stack, sp))[0]
            mask[EOS] = False
            if not mask.any():
                break
            tok = int(rng.choice(np.flatnonzero(mask)))
            lex, stack, sp = step_fn(lex, stack, sp, jnp.array([tok], jnp.int32))
        rows.append((int(lex[0]), np.asarray(stack[0]), int(sp[0])))
    full = np.full((jax_rt.STACK_DEPTH,), SYM_OBJ, np.int32)
    rows += [(rt.DEAD_STATE, np.zeros_like(full), 0), (rt.UNCONSTRAINED, np.zeros_like(full), 0),
             (tt.initial, full, jax_rt.STACK_DEPTH)]
    if grammar == "json":
        rows.append((jax_jsonfsm.OBJ_KEY, full, jax_rt.STACK_DEPTH))
    lex = np.array([r[0] for r in rows], np.int32)
    stack = np.stack([r[1] for r in rows]).astype(np.int32)
    sp = np.array([r[2] for r in rows], np.int32)
    return lex, stack, sp


def _tokens(grammar, lex, stack, sp, rng):
    """A token a row: a valid one (its mask), EOS, or any id."""
    _, jtbl, _ = _tables(grammar)
    mask = np.asarray(jax_rt.token_mask(jtbl, jnp.asarray(lex), jnp.asarray(stack),
                                        jnp.asarray(sp)))
    out = []
    for b in range(len(lex)):
        pick = rng.integers(0, 4)
        valid = np.flatnonzero(mask[b])
        out.append(EOS if pick == 0 else int(rng.integers(0, V)) if pick == 1 or not len(valid)
                   else int(rng.choice(valid)))
    return np.array(out, np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("grammar", list(GRAMMARS))
def test_token_mask_equals_jax(grammar):
    """token_mask (and effective_lex) on reachable, dead, unconstrained and
    full-stack rows: JAX's booleans; apply_mask: JAX's f32 logits."""
    _, jtbl, tbl = _tables(grammar)
    lex, stack, sp = _states(grammar)
    got = rt.token_mask(tbl, _t(lex), _t(stack), _t(sp))
    want = np.asarray(jax_rt.token_mask(jtbl, jnp.asarray(lex), jnp.asarray(stack),
                                        jnp.asarray(sp)))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert np.array_equal(rt.effective_lex(tbl, _t(lex), _t(stack), _t(sp)).numpy(),
                          np.asarray(jax_rt.effective_lex(jtbl, jnp.asarray(lex),
                                                          jnp.asarray(stack), jnp.asarray(sp))))
    logits = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    assert np.array_equal(rt.apply_mask(_t(logits).bfloat16(), got).numpy(),
                          np.asarray(jax_rt.apply_mask(jnp.asarray(logits, jnp.bfloat16),
                                                       jnp.asarray(want))))


@pytest.mark.parametrize("grammar", list(GRAMMARS))
def test_transition_equals_jax(grammar):
    """transition on valid, invalid and EOS tokens, with and without an
    active mask: JAX's lex, stack and sp."""
    _, jtbl, tbl = _tables(grammar)
    lex, stack, sp = _states(grammar)
    rng = np.random.default_rng(2)
    for with_active in (False, True):
        tok = _tokens(grammar, lex, stack, sp, rng)
        active = rng.random(len(lex)) < 0.7 if with_active else None
        got = rt.transition(tbl, _t(lex), _t(stack), _t(sp), _t(tok),
                            active=None if active is None else _t(active))
        want = jax_rt.transition(jtbl, jnp.asarray(lex), jnp.asarray(stack), jnp.asarray(sp),
                                 jnp.asarray(tok),
                                 active=None if active is None else jnp.asarray(active))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("grammar", list(GRAMMARS))
def test_host_walk_equals_jax(grammar):
    """walk_tokens (the batcher's resume walk, on the host tables) over
    valid walks (what a request generated before its preemption) and over
    walks that end in an invalid token or EOS (dead, or EOS kept in an
    accepting state): the state JAX's transition reaches token by token."""
    tt, _, tbl = _tables(grammar)
    mask_fn, step_fn = _jax_walkers(grammar)
    rng = np.random.default_rng(3)

    def jax_walk(toks):
        state = (jnp.array([tt.initial], jnp.int32),
                 jnp.zeros((1, jax_rt.STACK_DEPTH), jnp.int32), jnp.zeros((1,), jnp.int32))
        for t in toks:
            state = step_fn(*state, jnp.array([t], jnp.int32))
        return int(state[0][0]), np.asarray(state[1][0]), int(state[2][0])

    for _ in range(4):
        state, toks = (jnp.array([tt.initial], jnp.int32),
                       jnp.zeros((1, jax_rt.STACK_DEPTH), jnp.int32),
                       jnp.zeros((1,), jnp.int32)), []
        for _ in range(30):
            mask = np.array(mask_fn(*state))[0]
            mask[EOS] = False
            if not mask.any():
                break
            toks.append(int(rng.choice(np.flatnonzero(mask))))
            state = step_fn(*state, jnp.array([toks[-1]], jnp.int32))
        for walk in (toks, toks + [EOS], toks + [int(rng.integers(1, V))], toks + [EOS, 5, 6]):
            lex, stack, sp = rt.walk_tokens(tbl, tt.initial, walk)
            want = jax_walk(walk)
            assert (lex, sp) == (want[0], want[2]) and np.array_equal(stack, want[1])
        assert rt.walk_tokens(tbl, tt.initial, toks)[0] >= 0


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("grammar", list(GRAMMARS))
def test_walk_window_and_window_mask_equal_jax(grammar, K):
    """walk_window over K drafts a row (mostly valid, some not) and
    window_mask over the walked states: JAX's [B, K+1] states and
    [B, K+1, V] masks."""
    _, jtbl, tbl = _tables(grammar)
    lex, stack, sp = _states(grammar)
    rng = np.random.default_rng(4 + K)
    cols, (l, s, p) = [], (lex, stack, sp)
    for _ in range(K):  # drafts along each row's own walk
        tok = _tokens(grammar, l, s, p, rng)
        cols.append(tok)
        l, s, p = (np.asarray(x) for x in jax_rt.transition(
            jtbl, jnp.asarray(l), jnp.asarray(s), jnp.asarray(p), jnp.asarray(tok)))
    toks = np.stack(cols, 1)
    got = rt.walk_window(tbl, _t(lex), _t(stack), _t(sp), _t(toks))
    want = jax_rt.walk_window(jtbl, jnp.asarray(lex), jnp.asarray(stack), jnp.asarray(sp),
                              jnp.asarray(toks))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    got_m = rt.window_mask(tbl, *got)
    want_m = np.asarray(jax_rt.window_mask(jtbl, *want))
    assert got_m.shape == (len(lex), K + 1, V) and np.array_equal(got_m.numpy(), want_m)


def test_device_tables_and_init():
    """device_tables keeps JAX's dtypes (int16 states, int8 effects, bool
    accepting) and values; init_fsm is JAX's unconstrained start."""
    tt, jtbl, tbl = _tables("json")
    for name in ("state_out", "n_pop", "pop_syms", "n_push", "push_syms", "accepting"):
        assert str(tbl[name].dtype).split(".")[-1] == str(jtbl[name].dtype), name
        assert np.array_equal(tbl[name].numpy(), np.asarray(jtbl[name])), name
    for name in ("eos_id", "initial", "initial_objonly"):
        assert tbl[name] == jtbl[name]
    assert rt.table_bytes(tbl) == sum(np.asarray(jtbl[k]).nbytes for k in (
        "state_out", "n_pop", "pop_syms", "n_push", "push_syms", "accepting")) + 2 * 8 * len(
        tt.variant_obj)
    for a, b in zip(rt.init_fsm(3), jax_rt.init_fsm(3)):
        assert a.dtype == b.dtype and np.array_equal(a, b)

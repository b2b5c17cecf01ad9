"""The port's grammar compilers (llm_inference_lab_tpu_torch/constrain/:
jsonfsm, schema, regex, tools) against the JAX package's on the CPU.

For generic JSON, JSON object, two schemas, two regexes and a tools list,
``compile_token_tables`` gives arrays equal to JAX's, field for field
(np.array_equal, dtypes included), with the same initial states; on the
ByteTokenizer at a small vocabulary and once at Llama-3's 128,256.
``token_bytes_of`` gives JAX's bytes for stub tokenizers of its GPT-2
(byte-level BPE), sentencepiece and decode-only branches.
"""

import numpy as np
import pytest

from llm_inference_lab_tpu.constrain import jsonfsm as jax_jsonfsm
from llm_inference_lab_tpu.constrain.regex import build_regex_automaton as jax_regex
from llm_inference_lab_tpu.constrain.schema import build_schema_automaton as jax_schema
from llm_inference_lab_tpu.constrain.tools import build_tools_automaton as jax_tools
from llm_inference_lab_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from llm_inference_lab_tpu_torch.constrain import jsonfsm
from llm_inference_lab_tpu_torch.constrain.regex import build_regex_automaton
from llm_inference_lab_tpu_torch.constrain.schema import build_schema_automaton
from llm_inference_lab_tpu_torch.constrain.tools import build_tools_automaton
from llm_inference_lab_tpu_torch.utils.tokenizer import ByteTokenizer
from test_torch_decode_loop import one_thread  # noqa: F401

SCHEMAS = [
    {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"enum": ["x", "y"]}}},
    {"type": "object", "properties": {
        "name": {"type": "string"}, "ok": {"type": "boolean"},
        "score": {"type": ["number", "null"]},
        "tags": {"type": "array", "items": {"type": "string"}, "minItems": 1, "maxItems": 3}}},
]
REGEXES = ["(yes|no)", r"[A-Z][a-z]{2,5}-\d+(\.\d\d)?"]
TOOLS = [
    {"type": "function", "function": {"name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"},
                                         "days": {"type": "integer"}}}}},
    {"type": "function", "function": {"name": "get_time", "parameters": {
        "type": "object", "properties": {"tz": {"enum": ["utc", "local"]}}}}},
    {"name": "ping"},
]

# grammar name -> (port automaton builder, JAX automaton builder): the
# builders return (automaton, initials or None).
GRAMMARS = {
    "json": (lambda: (jsonfsm.json_char_automaton(), None),
             lambda: (jax_jsonfsm.json_char_automaton(), None)),
    "schema 0": (lambda: (build_schema_automaton(SCHEMAS[0]), None),
                 lambda: (jax_schema(SCHEMAS[0]), None)),
    "schema 1": (lambda: (build_schema_automaton(SCHEMAS[1]), None),
                 lambda: (jax_schema(SCHEMAS[1]), None)),
    "regex 0": (lambda: (build_regex_automaton(REGEXES[0]), None),
                lambda: (jax_regex(REGEXES[0]), None)),
    "regex 1": (lambda: (build_regex_automaton(REGEXES[1]), None),
                lambda: (jax_regex(REGEXES[1]), None)),
    "tools": (lambda: build_tools_automaton(TOOLS), lambda: jax_tools(TOOLS)),
}
FIELDS = ("state_out", "n_pop", "pop_syms", "n_push", "push_syms", "accepting",
          "variant_obj", "variant_arr")


def _same_tables(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("eos_id", "initial", "initial_objonly"):
        assert getattr(got, name) == getattr(want, name), name


def _compile(mod, tok, auto, V, eos):
    tb, tl = mod.token_bytes_of(tok, V)
    return mod.compile_token_tables(auto, tb, tl, eos_id=eos)


@pytest.mark.parametrize("V", [300, 515])
@pytest.mark.parametrize("grammar", list(GRAMMARS))
def test_tables_equal_jax(grammar, V):
    """Every field of the effect tables (and, for tools, the initial map)
    equals JAX's on the ByteTokenizer; the JSON grammar also serves
    json_object (its initial_objonly) from the same tables."""
    port_build, jax_build = GRAMMARS[grammar]
    auto, initials = port_build()
    jauto, jinitials = jax_build()
    assert np.array_equal(auto.table, jauto.table) and np.array_equal(auto.accepting,
                                                                       jauto.accepting)
    assert initials == jinitials
    got = _compile(jsonfsm, ByteTokenizer(), auto, V, 0)
    want = _compile(jax_jsonfsm, JaxByteTokenizer(), jauto, V, 0)
    _same_tables(got, want)
    if grammar == "json":
        assert got.initial_objonly == jsonfsm.VALUE_OBJONLY != got.initial


def test_tables_at_llama3_vocab():
    """The schema grammar at V = 128,256 (Llama-3's vocabulary; the
    ByteTokenizer maps id i to byte (i - 1) % 256): JAX's arrays."""
    V = 128256
    got = _compile(jsonfsm, ByteTokenizer(), build_schema_automaton(SCHEMAS[0]), V, 0)
    want = _compile(jax_jsonfsm, JaxByteTokenizer(), jax_schema(SCHEMAS[0]), V, 0)
    assert got.state_out.shape[1] == V
    _same_tables(got, want)


class _Gpt2Stub:
    """A byte-level BPE vocabulary ('Ġ' = space, 'Ċ' = newline) with a
    special token and an added token outside the byte map."""

    all_special_ids = [5]

    def __init__(self):
        self.toks = ["{", "Ġ\"", "ab", "Ċ}", "Ġ123", "<|eot|>", "é", "ĠtrueĊ", "x", None]

    def convert_ids_to_tokens(self, ids):
        return [self.toks[i] if i < len(self.toks) else "z" for i in ids]


class _SpStub:
    """A sentencepiece vocabulary ('▁' = space, '<0xNN>' raw bytes)."""

    all_special_ids = [0, 1]

    def __init__(self):
        self.toks = ["<s>", "</s>", "▁{", "<0x0A>", "\"a\"", "▁:", "▁1", "}", "▁é",
                     "<0x22>"]

    def convert_ids_to_tokens(self, ids):
        return [self.toks[i] for i in ids]


class _DecodeStub:
    """No convert_ids_to_tokens: decode([id]) is the fallback."""

    all_special_ids = [2]

    def decode(self, ids):
        (i,) = ids
        if i == 7:
            raise ValueError("undecodable")
        return "{\"a\": [1, 2]}"[i % 12]


class _Wrapped:
    """A tokenizer wrapper holding the real one in `_tok`."""

    def __init__(self, inner):
        self._tok = inner


@pytest.mark.parametrize("stub", [_Gpt2Stub, _SpStub, _DecodeStub, lambda: _Wrapped(_SpStub())])
def test_token_bytes_of_branches(stub):
    """token_bytes_of's GPT-2, sentencepiece and decode-only branches (and
    a wrapper's `_tok`) give JAX's bytes and lengths; the JSON tables over
    them equal JAX's."""
    V = 10
    tb, tl = jsonfsm.token_bytes_of(stub(), V)
    jtb, jtl = jax_jsonfsm.token_bytes_of(stub(), V)
    assert np.array_equal(tb, jtb) and np.array_equal(tl, jtl)
    got = jsonfsm.compile_token_tables(jsonfsm.json_char_automaton(), tb, tl, eos_id=1)
    want = jax_jsonfsm.compile_token_tables(jax_jsonfsm.json_char_automaton(), jtb, jtl, eos_id=1)
    _same_tables(got, want)

"""Grammars and forced tool calls through the port's OpenAI server
(server/serving.py), against the JAX package's server on the CPU (port of
tests/test_constrain_engine.py's server cases and tests/test_tools.py's
tool_server cases, on the fake model over HTTP on port 0).

response_format json_object / json_schema, guided_regex, tool_choice
"required" and a named function are served; a streamed forced call comes
as tool_calls chunks (the id and name first, then argument deltas whose
concatenation parses). The same request bodies sent to JAX's server give
the same choices and usage, and a request the deployment's grammar cannot
serve gets the 400 JAX's server gives, with JAX's message.
"""

import json
import re
import urllib.error
import urllib.request

import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.server import InferenceServer as JaxServer
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.server import InferenceServer
from test_torch_decode_loop import one_thread  # noqa: F401

FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=3,
            max_new_tokens=32)
SCHEMA = {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"enum": ["x", "y"]}}}
REGEX = "(yes|no)"
GEN_TOOLS = [
    {"type": "function", "function": {"name": "get_time", "parameters": {
        "type": "object", "properties": {"tz": {"enum": ["utc", "local"]}}}}},
    {"type": "function", "function": {"name": "toggle", "parameters": {
        "type": "object", "properties": {"on": {"type": "boolean"}}}}},
]
GEN_NAMES = ("get_time", "toggle")
DEPLOYMENTS = {
    "json": dict(constrain="json"),
    "schema": dict(constrain="json_schema", constrain_schema=SCHEMA),
    "regex": dict(constrain="regex", constrain_regex=REGEX),
    "tools": dict(tools=GEN_TOOLS, max_new_tokens=64),
    "none": {},
}


def _pair(name):
    """The port's server and JAX's on the same deployment, started."""
    cfg = {**FAKE, **DEPLOYMENTS[name]}
    port = InferenceServer(Engine(EngineConfig(**cfg, max_seq_len=512), device="cpu"),
                           n_slots=2, port=0)
    jax = JaxServer(JaxEngine(JaxEngineConfig(**cfg)), n_slots=2, port=0)
    port.start()
    jax.start()
    return port, jax


@pytest.fixture(scope="module")
def servers():
    started = {name: _pair(name) for name in DEPLOYMENTS}
    yield started
    for pair in started.values():
        for srv in pair:
            srv.stop()


def _call(srv, path, body):
    """(HTTP code, body) of a POST."""
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _both(servers, name, path, body):
    """The port's and JAX's answers to one body: the same code, the same
    choices (ids and tool call ids aside) and usage, or the same error."""
    port, jax = servers[name]
    (code, got), (jcode, want) = _call(port, path, body), _call(jax, path, body)
    assert code == jcode, (code, got, jcode, want)
    if code != 200:
        assert got["error"] == want["error"]
        return code, got

    def strip(choices):
        out = json.loads(json.dumps(choices))
        for ch in out:
            for tc in (ch.get("message") or {}).get("tool_calls") or []:
                tc.pop("id")
        return out

    assert strip(got["choices"]) == strip(want["choices"]) and got["usage"] == want["usage"]
    return code, got


def _chat(content, **kw):
    return {"messages": [{"role": "user", "content": content}], **kw}


def test_response_format_json_object(servers):
    """json_object on a json deployment: an object that parses; text
    passes through unconstrained; an unknown type and json_schema (another
    grammar) are JAX's 400s."""
    code, out = _both(servers, "json", "/v1/completions", {
        "prompt": "j", "max_tokens": 24, "response_format": {"type": "json_object"}})
    text = out["choices"][0]["text"]
    assert code == 200 and text.strip().startswith("{") and isinstance(json.loads(text), dict)
    assert _both(servers, "json", "/v1/completions", {
        "prompt": "j", "max_tokens": 4, "response_format": {"type": "text"}})[0] == 200
    for rf in ({"type": "xml"}, {"type": "json_schema"}):
        code, out = _both(servers, "json", "/v1/completions",
                          {"prompt": "j", "max_tokens": 4, "response_format": rf})
        assert code == 400


def test_response_format_json_schema(servers):
    """The compiled schema (named in the body or not): its fields in order,
    typed; another schema and json_object are 400s."""
    for rf in ({"type": "json_schema"},
               {"type": "json_schema", "json_schema": {"schema": SCHEMA}}):
        code, out = _both(servers, "schema", "/v1/completions",
                          {"prompt": "s", "max_tokens": 32, "response_format": rf})
        obj = json.loads(out["choices"][0]["text"])
        assert code == 200 and list(obj) == ["a", "b"] and isinstance(obj["a"], int)
        assert out["choices"][0]["finish_reason"] == "stop"
    for rf in ({"type": "json_schema", "json_schema": {"schema": {"type": "string"}}},
               {"type": "json_object"}):
        code, out = _both(servers, "schema", "/v1/completions",
                          {"prompt": "s", "max_tokens": 8, "response_format": rf})
        assert code == 400, out


def test_guided_regex(servers):
    """guided_regex (vLLM's key) and response_format regex on a regex
    deployment: a full match; another pattern, or a regex on a deployment
    of another grammar, is a 400."""
    for body in ({"guided_regex": REGEX}, {"response_format": {"type": "regex"}}):
        code, out = _both(servers, "regex", "/v1/completions",
                          dict(body, prompt="r", max_tokens=8))
        assert code == 200 and re.fullmatch(REGEX, out["choices"][0]["text"])
    assert _both(servers, "regex", "/v1/completions",
                 {"prompt": "r", "guided_regex": "[0-9]+"})[0] == 400
    code, out = _both(servers, "json", "/v1/completions", {"prompt": "r", "guided_regex": REGEX})
    assert code == 400 and "cannot serve regex" in out["error"]


def test_no_tables_refuses_every_grammar(servers):
    """A server without a grammar answers 400 to each grammar request
    (never unconstrained text), JAX's messages."""
    for body in ({"response_format": {"type": "json_object"}},
                 {"response_format": {"type": "json_schema"}}, {"guided_regex": REGEX}):
        code, out = _both(servers, "none", "/v1/completions", dict(body, prompt="x"))
        assert code == 400 and "cannot serve" in out["error"]
    for choice in ("required", {"type": "function", "function": {"name": "get_time"}}):
        code, out = _both(servers, "none", "/v1/chat/completions",
                          _chat("x", tools=GEN_TOOLS, tool_choice=choice))
        assert code == 400
    code, out = _both(servers, "none", "/v1/chat/completions",
                      _chat("x", tools=GEN_TOOLS, max_tokens=8))
    assert code == 200 and out["choices"][0]["message"]["content"] is not None


def test_tool_choice_required_and_named(servers):
    """required: a call of one of the tools; a named function: that tool,
    its arguments of its shape; finish_reason tool_calls, content null."""
    code, out = _both(servers, "tools", "/v1/chat/completions", _chat(
        "weather in SF?", tools=GEN_TOOLS, tool_choice="required", max_tokens=64))
    ch = out["choices"][0]
    assert code == 200 and ch["finish_reason"] == "tool_calls"
    assert ch["message"]["content"] is None
    (tc,) = ch["message"]["tool_calls"]
    assert tc["type"] == "function" and tc["function"]["name"] in GEN_NAMES
    assert tc["id"].startswith("call_")
    json.loads(tc["function"]["arguments"])
    code, out = _both(servers, "tools", "/v1/chat/completions", _chat(
        "time?", tools=GEN_TOOLS, max_tokens=64,
        tool_choice={"type": "function", "function": {"name": "get_time"}}))
    (tc,) = out["choices"][0]["message"]["tool_calls"]
    assert tc["function"]["name"] == "get_time"
    assert json.loads(tc["function"]["arguments"])["tz"] in ("utc", "local")


def test_tool_choice_none_auto_and_unknown(servers):
    """none and auto answer content (the fake model calls no tool); an
    unknown tool, a list the compiled tools are not all in, and an
    unsupported choice are 400s; a tool conversation's earlier turns
    render."""
    for choice in ("none", "auto"):
        code, out = _both(servers, "tools", "/v1/chat/completions",
                          _chat("hi", tools=GEN_TOOLS, tool_choice=choice, max_tokens=8))
        ch = out["choices"][0]
        assert code == 200 and ch["message"]["content"] is not None
        assert ch["finish_reason"] in ("stop", "length")
    for body in (_chat("x", tools=GEN_TOOLS, tool_choice={
            "type": "function", "function": {"name": "nope"}}),
            _chat("x", tools=GEN_TOOLS[:1], tool_choice="required"),
            _chat("x", tools=GEN_TOOLS, tool_choice="sometimes")):
        assert _both(servers, "tools", "/v1/chat/completions", body)[0] == 400
    code, out = _both(servers, "tools", "/v1/chat/completions", {
        "messages": [
            {"role": "user", "content": "weather in SF?"},
            {"role": "assistant", "tool_calls": [{
                "id": "call_1", "type": "function",
                "function": {"name": "get_weather", "arguments": "{\"city\":\"SF\"}"}}]},
            {"role": "tool", "tool_call_id": "call_1", "content": "{\"temp\": 18}"}],
        "tools": GEN_TOOLS, "max_tokens": 8})
    assert code == 200 and out["choices"][0]["message"]["content"] is not None


def _stream_chunks(srv, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/chat/completions",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            chunks.append(json.loads(line[6:]))
    return chunks


@pytest.mark.parametrize("budget", [64, 36])
def test_streamed_tool_call(servers, budget):
    """stream with a forced tool: tool_calls chunks, the first with the id,
    type and name, then argument deltas that concatenate to the tool's
    arguments, finish_reason tool_calls; the deltas and finishes equal
    JAX's server's. A budget that cuts the call mid-arguments finishes
    with "length" and no wrapper brace."""
    body = _chat("time?", tools=GEN_TOOLS, max_tokens=budget,
                 tool_choice={"type": "function", "function": {"name": "get_time"}})
    port, jax = servers["tools"]
    chunks, jchunks = _stream_chunks(port, body), _stream_chunks(jax, body)

    def shape(cs):
        out = []
        for c in cs:
            ch = c["choices"][0]
            d = json.loads(json.dumps(ch["delta"]))
            for tc in d.get("tool_calls", []):
                tc.pop("id", None)
            out.append((d, ch["finish_reason"]))
        return out

    assert shape(chunks) == shape(jchunks)
    tool = [c["choices"][0]["delta"]["tool_calls"][0] for c in chunks
            if "tool_calls" in c["choices"][0]["delta"]]
    assert tool[0]["id"].startswith("call_") and tool[0]["type"] == "function"
    assert tool[0]["function"]["name"] == "get_time"
    args = "".join(t["function"]["arguments"] for t in tool)
    if budget == 64:
        assert json.loads(args)["tz"] in ("utc", "local")
        assert chunks[-1]["choices"][0]["finish_reason"] == "tool_calls"
    else:
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"

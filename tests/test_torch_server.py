"""The port's OpenAI-compatible server (server/serving.py InferenceServer)
on the fake model over HTTP on port 0 (port of tests/test_server.py, with
the server cases of tests/test_penalties.py and tests/test_seed.py).

Every endpoint and request feature: /health, /stats, /metrics, /v1/models,
completions and chat, max_tokens, stop, stream (with include_usage), echo,
n, best_of, logprobs and top_logprobs, the per-request sampling fields,
logit_bias and seed, request_timeout and a client that disconnects. The
same greedy request bodies go to the JAX package's InferenceServer on its
fake engine and give the same choices (text, finish reason) and usage.
Every feature the port does not have is refused with an error that names
it.
"""

import concurrent.futures
import json
import socket
import time
import urllib.error
import urllib.request

import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.server import InferenceServer as JaxServer
from llm_inference_lab_tpu.server.serving import _parse_tool_call as jax_parse_tool_call
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.server import InferenceServer
from llm_inference_lab_tpu_torch.server.serving import _parse_tool_call
from test_torch_decode_loop import one_thread  # noqa: F401

FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=2,
            max_new_tokens=8, max_seq_len=256)


def _start(cfg=None, n_slots=2, **kw):
    srv = InferenceServer(Engine(EngineConfig(**dict(FAKE, **(cfg or {}))), device="cpu"),
                          n_slots=n_slots, port=0, **kw)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def server():
    srv = _start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def sampling_server():
    srv = _start(dict(per_request_sampling=True, logprobs_topk=5), n_slots=4)
    yield srv
    srv.stop()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _post(srv, path, body, raw=None):
    req = urllib.request.Request(_url(srv, path), data=raw or json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _error(srv, path, body, raw=None):
    """(HTTP code, error message) of a refused request."""
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv, path, body, raw)
    return err.value.code, json.loads(err.value.read())["error"]


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=10) as resp:
        return resp.read().decode()


def _stream(srv, path, body):
    """POST with stream: (deltas, finish_reason, saw [DONE], every chunk)."""
    req = urllib.request.Request(_url(srv, path), data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    deltas, finish, done, chunks = [], None, False, []
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                done = True
                break
            obj = json.loads(line[len("data: "):])
            chunks.append(obj)
            if not obj["choices"]:
                continue
            ch = obj["choices"][0]
            deltas.append(ch["delta"].get("content", "") if "delta" in ch else ch["text"])
            finish = ch["finish_reason"] or finish
    return deltas, finish, done, chunks


def test_health_models_metrics_stats(server):
    health = json.loads(_get(server, "/health"))
    assert health["status"] == "ok" and health["model"] == "fake"
    assert json.loads(_get(server, "/v1/models"))["data"][0]["id"] == "fake"
    _post(server, "/v1/completions", {"prompt": "count me", "max_tokens": 3})
    metrics = _get(server, "/metrics")
    assert "specdx_requests_served_total" in metrics and "specdx_slots_total 2" in metrics
    stats = json.loads(_get(server, "/stats"))
    assert stats["served"] >= 1 and stats["batcher"]["retired"] >= 1
    assert set(stats["loop_ms"]) == {"submit", "decode_poll", "admit", "cancel_scan", "streams",
                                     "finalize"}
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server, "/nowhere")
    assert err.value.code == 404


def test_completion_and_chat(server):
    out = _post(server, "/v1/completions", {"prompt": "hello server", "max_tokens": 6})
    assert out["object"] == "text_completion" and out["usage"]["completion_tokens"] == 6
    assert isinstance(out["choices"][0]["text"], str) and "acceptance_rate" in out["specdx"]
    out = _post(server, "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                                 "max_tokens": 6})
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"


@pytest.fixture(scope="module")
def jax_server():
    srv = JaxServer(JaxEngine(JaxEngineConfig(**FAKE)), n_slots=2, port=0)
    srv.start()
    yield srv
    srv.stop()


PARITY_BODIES = [
    ("/v1/completions", {"prompt": "hello server", "max_tokens": 6}),
    ("/v1/completions", {"prompt": "run to budget", "max_tokens": 5}),
    ("/v1/completions", {"prompt": "echo this", "max_tokens": 4, "echo": True}),
    ("/v1/completions", {"prompt": "n test", "max_tokens": 6, "n": 3}),
    ("/v1/completions", {"prompt": "all of us", "max_tokens": 4, "echo": True, "n": 2}),
    ("/v1/completions", {"prompt": ["a list prompt"], "max_tokens": 7}),
    ("/v1/completions", {"prompt": "halt here", "max_tokens": 8, "stop": ["zz", "\x10"]}),
    ("/v1/completions", {"prompt": "no budget given"}),
    ("/v1/chat/completions", {"messages": [{"role": "system", "content": "be brief"},
                                           {"role": "user", "content": "hi"}], "max_tokens": 6}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "two"}],
                              "max_completion_tokens": 5, "n": 2}),
]


@pytest.mark.parametrize("i", range(len(PARITY_BODIES)))
def test_greedy_choices_and_usage_equal_jax_server(server, jax_server, i):
    """The same greedy body to both servers: the same choices (text or
    message, finish reason, index) and usage."""
    path, body = PARITY_BODIES[i]
    got, want = _post(server, path, body), _post(jax_server, path, body)
    assert got["usage"] == want["usage"]
    strip = lambda c: {k: v for k, v in c.items() if k != "logprobs"}  # noqa: E731
    assert [strip(c) for c in got["choices"]] == [strip(c) for c in want["choices"]]


def test_stop_string_equals_jax_and_frees_the_slot_early(server, jax_server):
    """A stop string carved from the greedy text: the text is cut before it
    (as JAX's server cuts it), finish_reason "stop", and the request retires
    long before its budget of 120 tokens."""
    base = _post(server, "/v1/completions", {"prompt": "halt here", "max_tokens": 120})
    text = base["choices"][0]["text"]
    stop = text[6:8]
    body = {"prompt": "halt here", "max_tokens": 120, "stop": stop}
    out = _post(server, "/v1/completions", body)
    assert out["choices"][0]["text"] == text[:text.find(stop)]
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["usage"]["completion_tokens"] < 60
    assert out["choices"][0]["text"] == _post(jax_server, "/v1/completions",
                                              body)["choices"][0]["text"]


def test_concurrent_requests(server):
    """24 client threads (more than the cores), a short switch interval: each
    answer is its own prompt's greedy text at its own budget (a request
    routed to another waiter, or lost, breaks it)."""
    import sys

    eng = Engine(EngineConfig(**FAKE), device="cpu")
    want = {i: eng.generate(f"concurrent {i}")["generated_ids"][:3 + i % 5] for i in range(24)}

    def one(i):
        return i, _post(server, "/v1/completions", {"prompt": f"concurrent {i}",
                                                   "max_tokens": 3 + i % 5})

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=24) as ex:
            outs = list(ex.map(one, range(24), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    for i, out in outs:
        text = eng.tokenizer.decode([t for t in want[i] if t != eng.eos_token_id])
        assert out["choices"][0]["text"] == text, i


def test_streaming_equals_non_stream(server):
    body = {"prompt": "stream me", "max_tokens": 8}
    full = _post(server, "/v1/completions", body)
    deltas, finish, done, chunks = _stream(server, "/v1/completions", body)
    assert done and finish == full["choices"][0]["finish_reason"]
    assert "".join(deltas) == full["choices"][0]["text"]
    assert all("usage" not in c for c in chunks)
    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}
    deltas, finish, done, chunks = _stream(server, "/v1/chat/completions", chat)
    assert done and chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert "".join(deltas) == _post(server, "/v1/chat/completions",
                                    chat)["choices"][0]["message"]["content"]


def test_stream_options_include_usage(server):
    """One last chunk with no choices and the usage, before [DONE]."""
    _, _, done, chunks = _stream(server, "/v1/completions", {
        "prompt": "usage stream", "max_tokens": 6, "stream_options": {"include_usage": True}})
    assert done and chunks[-1]["choices"] == []
    u = chunks[-1]["usage"]
    assert u["prompt_tokens"] > 0 and u["completion_tokens"] == 6
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]


def test_logprobs_field(server):
    out = _post(server, "/v1/completions", {"prompt": "logprob me", "max_tokens": 5,
                                            "logprobs": 1})
    lp = out["choices"][0]["logprobs"]
    assert len(lp["token_logprobs"]) == out["usage"]["completion_tokens"]
    assert all(x <= 0.0 for x in lp["token_logprobs"]) and lp["top_logprobs"] is None
    assert _post(server, "/v1/completions", {"prompt": "logprob me",
                                             "max_tokens": 5})["choices"][0]["logprobs"] is None
    echo = _post(server, "/v1/completions", {"prompt": "logprob me", "max_tokens": 5,
                                             "logprobs": 0, "echo": True})["choices"][0]
    assert echo["logprobs"]["token_logprobs"][0] is None
    assert len(echo["logprobs"]["tokens"]) == len("logprob me") + 5


def test_n_and_best_of(server, sampling_server):
    """n choices are indexed and their usage summed; best_of generates its
    candidates and returns n, usage counting all; n or best_of with stream
    is refused."""
    out = _post(server, "/v1/completions", {"prompt": "n test", "max_tokens": 6, "n": 3})
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert len({c["text"] for c in out["choices"]}) == 1 and out["usage"]["completion_tokens"] == 18
    out = _post(sampling_server, "/v1/completions", {
        "prompt": "pick best", "max_tokens": 6, "best_of": 4, "temperature": 2.5, "logprobs": 0})
    # A hot candidate may draw EOS (id 0) early: usage counts more than one.
    assert len(out["choices"]) == 1 and 6 < out["usage"]["completion_tokens"] <= 24
    for body in ({"n": 2}, {"best_of": 3}):
        code, msg = _error(server, "/v1/completions", dict(body, prompt="x", stream=True))
        assert code == 400 and "stream" in msg


def test_per_request_temperature_and_seed(sampling_server):
    """temperature 0 gives the greedy engine's text; a seed repeats its text
    and another seed differs; n candidates under one seed differ (the seed
    is perturbed after the first) and repeat as a set."""
    want = Engine(EngineConfig(**FAKE), device="cpu").generate("sampled server")["text"]
    out = _post(sampling_server, "/v1/completions",
                {"prompt": "sampled server", "max_tokens": 8, "temperature": 0})
    assert out["choices"][0]["text"] == want
    body = {"prompt": "seeded http", "max_tokens": 12, "temperature": 3.0, "seed": 99}
    first = _post(sampling_server, "/v1/completions", body)["choices"][0]["text"]
    assert first == _post(sampling_server, "/v1/completions", body)["choices"][0]["text"]
    assert first != _post(sampling_server, "/v1/completions",
                          dict(body, seed=100))["choices"][0]["text"]
    spread = dict(body, seed=7, n=3)
    texts = [c["text"] for c in _post(sampling_server, "/v1/completions", spread)["choices"]]
    assert len(set(texts)) > 1
    assert texts == [c["text"] for c in _post(sampling_server, "/v1/completions",
                                              spread)["choices"]]


def test_logit_bias_and_penalties(sampling_server):
    """+100 on token 7 forces it at every position; a penalized request's
    text is the batcher's for the same controls, and not the plain one."""
    eng = sampling_server.engine
    out = _post(sampling_server, "/v1/completions",
                {"prompt": "srv bias", "max_tokens": 6, "logit_bias": {"7": 100.0}})
    assert out["choices"][0]["text"] == eng.tokenizer.decode([7] * 6)
    body = {"prompt": "ab", "max_tokens": 48, "frequency_penalty": 1e4, "presence_penalty": 2.0}
    text = _post(sampling_server, "/v1/completions", body)["choices"][0]["text"]
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher

    b = ContinuousBatcher(Engine(EngineConfig(**dict(FAKE, per_request_sampling=True)),
                                 device="cpu"), n_slots=1)
    b.submit("ab", max_new_tokens=48, frequency_penalty=1e4, presence_penalty=2.0)
    (r,) = b.run()
    assert text == r["text"] and len(set(r["generated_ids"])) == len(r["generated_ids"]) > 8
    plain = {k: v for k, v in body.items() if not k.endswith("penalty")}
    assert text != _post(sampling_server, "/v1/completions", plain)["choices"][0]["text"]


def test_top_logprobs_trim_the_captured_n(sampling_server):
    """The chat top_logprobs count and the completions int trim the
    engine's captured top 5; the greedy token is the first alternative."""
    out = _post(sampling_server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "logprobs": True,
        "top_logprobs": 2})
    content = out["choices"][0]["logprobs"]["content"]
    assert len(content) == 4
    for pos in content:
        assert len(pos["top_logprobs"]) == 2 and pos["top_logprobs"][0]["token"] == pos["token"]
        assert pos["top_logprobs"][0]["logprob"] >= pos["top_logprobs"][1]["logprob"]
    out = _post(sampling_server, "/v1/completions", {"prompt": "hi", "max_tokens": 4,
                                                     "logprobs": 3})
    tops = out["choices"][0]["logprobs"]["top_logprobs"]
    assert len(tops) == 4 and all(1 <= len(pos) <= 3 for pos in tops)


def test_request_timeout_cancels():
    """request_timeout cancels a long request and frees its slot: the client
    gets finish_reason "cancelled" with what was generated."""
    srv = _start(dict(max_new_tokens=4096, max_seq_len=8192, eos_token_id=-1), n_slots=1,
                 poll_every=2, request_timeout=0.5)
    try:
        t0 = time.time()
        out = _post(srv, "/v1/completions", {"prompt": "slow", "max_tokens": 4096})
        assert time.time() - t0 < 30
        assert out["choices"][0]["finish_reason"] == "cancelled"
        assert out["usage"]["completion_tokens"] < 4096
    finally:
        srv.stop()


def test_client_disconnect_cancels():
    """A streaming client that goes away: the engine thread cancels its
    request, which retires long before its budget, and the server serves
    the next request."""
    srv = _start(dict(max_new_tokens=4096, max_seq_len=8192, eos_token_id=-1), n_slots=1,
                 poll_every=2)
    try:
        body = json.dumps({"prompt": "walk away", "max_tokens": 4000, "stream": True}).encode()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                     b"application/json\r\nContent-Length: " + str(len(body)).encode()
                     + b"\r\n\r\n" + body)
        got = b""
        while b"data: " not in got:
            got += sock.recv(4096)
        sock.close()
        deadline = time.time() + 30
        while srv._served < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert srv._served == 1
        assert srv.batcher.stats.committed_tokens < 4000
        out = _post(srv, "/v1/completions", {"prompt": "next", "max_tokens": 3})
        assert out["usage"]["completion_tokens"] == 3
    finally:
        srv.stop()


def test_bad_json_and_unknown_path(server):
    assert _error(server, "/v1/completions", None, raw=b"{not json")[0] == 400
    assert _error(server, "/v1/other", {})[0] == 404


REFUSED = [
    # A server without a grammar (EngineConfig.constrain / tools): JAX's 400s.
    ("/v1/completions", {"response_format": {"type": "json_object"}}, 400,
     "grammar cannot serve response_format 'json_object'"),
    ("/v1/completions", {"response_format": {"type": "json_schema"}}, 400,
     "grammar cannot serve response_format 'json_schema'"),
    ("/v1/completions", {"guided_regex": "[a-z]+"}, 400, "grammar cannot serve regex"),
    ("/v1/chat/completions", {"tools": [{"type": "function", "function": {"name": "f"}}],
                              "tool_choice": "required"}, 400,
     "needs the server started with EngineConfig(tools=...)"),
    ("/v1/chat/completions", {"tools": [{"type": "function", "function": {"name": "f"}}],
                              "tool_choice": {"type": "function", "function": {"name": "f"}}},
     400, "tool 'f' is not compiled into this server's tool grammar"),
    # A model name that is neither the base nor a loaded LoRA adapter (JAX's
    # 404), and embeddings whose input is not text (JAX's 400).
    ("/v1/completions", {"model": "my-lora-adapter"}, 404,
     "model 'my-lora-adapter' not found (base or a loaded LoRA adapter)"),
    ("/v1/embeddings", {"input": 7}, 400, "input must be a string or list of strings"),
    # A greedy engine without per_request_sampling cannot honour these.
    ("/v1/completions", {"temperature": 0.9}, 400, "per_request_sampling"),
    ("/v1/completions", {"seed": 3}, 400, "per_request_sampling"),
    ("/v1/completions", {"logit_bias": {"5": 1.0}}, 400, "per_request_sampling"),
    ("/v1/completions", {"frequency_penalty": 0.5}, 400, "per_request_sampling"),
]


@pytest.mark.parametrize("i", range(len(REFUSED)))
def test_refused_features_name_themselves(server, i):
    """Each feature the port does not have, a grammar the deployment has
    not compiled, and sampling fields a static engine would not honour,
    return an error naming it; none is answered plainly."""
    path, body, code, words = REFUSED[i]
    body = dict({"prompt": "x", "messages": [{"role": "user", "content": "x"}]}, **body)
    got_code, msg = _error(server, path, body)
    assert (got_code, words in msg) == (code, True), msg


def test_static_server_takes_its_own_values(server):
    """A static greedy server takes fields that equal what it does anyway
    (temperature 0, top_p 1): the greedy text."""
    plain = _post(server, "/v1/completions", {"prompt": "same", "max_tokens": 5})
    out = _post(server, "/v1/completions", {"prompt": "same", "max_tokens": 5,
                                            "temperature": 0, "top_p": 1.0})
    assert out["choices"] == plain["choices"]


def test_refusals_of_the_sampling_engine(sampling_server):
    """More logit_bias pairs than a slot holds or an id outside the
    vocabulary; penalties in tree mode; per-request sampling with the
    rejection policy (its distributions are the engine's)."""
    code, msg = _error(sampling_server, "/v1/completions",
                       {"prompt": "x", "logit_bias": {str(i): 1.0 for i in range(33)}})
    assert code == 400 and "at most 32" in msg
    code, msg = _error(sampling_server, "/v1/completions",
                       {"prompt": "x", "logit_bias": {"999": 1.0}})
    assert code == 400 and "vocabulary" in msg
    tree = _start(dict(draft_model=None, draft_mode="tree", per_request_sampling=True))
    try:
        code, msg = _error(tree, "/v1/completions", {"prompt": "x", "presence_penalty": 1.0})
        assert code == 400 and "tree" in msg
        assert _post(tree, "/v1/completions", {"prompt": "x", "max_tokens": 4,
                                               "temperature": 0})["usage"]["completion_tokens"]
    finally:
        tree.stop()
    with pytest.raises(NotImplementedError, match="rejection"):
        Engine(EngineConfig(**dict(FAKE, per_request_sampling=True, policy="rejection")),
               device="cpu")


def test_tools_auto_and_the_strict_parse(server):
    """tool_choice "auto" renders the tools into the transcript and answers
    (the fake model calls no tool); the strict parse is JAX's."""
    out = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "weather?"}], "max_tokens": 5,
        "tools": [{"type": "function", "function": {"name": "get_weather"}}]})
    assert out["choices"][0]["finish_reason"] in ("length", "stop")
    for text in ('{"name": "f", "arguments": {"a": 1}}', '{"name": "f"}', "not json",
                 ' {"name": "g", "arguments": [1]} ', '{"name": "f", "arguments": 1, "x": 2}'):
        assert _parse_tool_call(text) == jax_parse_tool_call(text)
        assert _parse_tool_call(text, allowed=["f"]) == jax_parse_tool_call(text, allowed=["f"])

"""OpenAI-compatible inference server over the continuous batcher.

Port of llm_inference_lab_tpu/server/serving.py (``InferenceServer``).

Endpoints:
  GET  /health                 -> {"status": "ok", ...}
  GET  /stats                  -> served count, loop_ms, the batcher's stats
  GET  /metrics                -> Prometheus text
  GET  /v1/models              -> the base model and every LoRA adapter
  POST /v1/completions         -> {choices: [{text, ...}], usage: {...}}
  POST /v1/chat/completions    -> {choices: [{message: {...}}], usage: {...}}
  POST /v1/embeddings          -> {data: [{embedding, index}], usage: {...}}

Request features: max_tokens (or max_completion_tokens), stop (a string or
a list: matched on the host, the text cut before it and the slot cancelled
so it frees early; finish_reason "stop"), stream (server-sent events, the
OpenAI chunk schema, ``data: [DONE]``; stream_options.include_usage adds a
usage chunk), echo (completions), n (up to 16 independent choices, each in
its own slot) and best_of (completions: the n of best_of candidates with the
highest mean token logprob; usage counts all), response_format
(json_object, json_schema, and json) and guided_regex under the engine's
grammar (EngineConfig.constrain; a request's schema or pattern must be the
one the deployment compiled), logprobs and top_logprobs
(trimmed from the engine's captured top N, EngineConfig.logprobs_topk), and
under EngineConfig(per_request_sampling=True) temperature, top_k, top_p,
min_p, repetition_penalty, presence_penalty, frequency_penalty, logit_bias
and seed (an explicit seed is perturbed for the n / best_of candidates after
the first, so they differ). The server's request_timeout and a client that
disconnects mid-stream cancel the request. Chat renders the messages as a
role transcript ("role: content" lines, then "assistant:"; the port has no
chat template), tools listed ahead of it; tool_choice "auto" parses a tool
call from the generated text (JAX's strict parse), "required" and a named
function constrain decoding to the engine's tool grammar
(EngineConfig.tools) and answer tool_calls, streamed as OpenAI's
tool_calls chunks (the name once, then argument deltas). The ``model``
field routes a request to a LoRA adapter of the engine's pack by name (the
base model's name, or none, is the base; any other name a 404 with JAX's
text). /v1/embeddings (JAX serving.py:822-879): ``input`` a string or a list
of at most 64 strings, ``encoding_format`` "float" or "base64" (little-endian
f32), ``pooling`` "mean" or "last"; Engine.embed runs on the engine thread
between decode chunks.

A grammar the deployment cannot serve is a 400 with JAX's message (the
engine without tables, another grammar, another schema or pattern, a tool
not compiled in); nothing decodes unconstrained in its place. What the port
does not have is refused with an error that names it, never answered
plainly: on an engine without per_request_sampling any sampling field,
logit_bias or seed whose value is not the engine's own (400).
ContinuousBatcher.check_request makes these checks in the handler thread.

Architecture: HTTP handler threads queue requests and wait on per-request
events; ONE engine thread owns the device. It submits what is queued to the
ContinuousBatcher and runs JAX's pipelined cycle (server/serving.py:170-201):
snapshot the flags (``poll_flags_async``), a chunk of decode steps
(``step_chunk()``: exact-retirement length, the decode loop's graph
replays), overlapped admission (``_admit_overlapped``, under
EnvFlags.overlap_admit), early retirement (``_prefetch_retire``), the
lagged poll (``_retire_finished``), admission (``_admit_post_poll``); then it
runs the queued embedding calls, cancels, observes the streams and wakes the
waiters.
Handler threads never touch a tensor. The batcher, and so its decode
graphs, is built when the server is, before any of its threads starts.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

from llm_inference_lab_tpu_torch.core.batching import CONTROLS, POLL_EVERY, ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine

MAX_N = 16  # the most choices (n, best_of) a request may ask for
MAX_EMBED_INPUTS = 64  # the most inputs an embeddings request may carry (JAX's)
WAIT_S = 600.0  # how long a handler waits for its generation


def _parse_tool_call(text: str, allowed=None):
    """Strict parse of a generated tool call (copy of JAX's): the text must
    be exactly {"name": <str>, "arguments": <json>}; `allowed` restricts
    the names. Returns (name, arguments) or None."""
    try:
        d = json.loads(text.strip())
    except Exception:
        return None
    if not isinstance(d, dict) or set(d) != {"name", "arguments"}:
        return None
    if allowed is not None and d["name"] not in allowed:
        return None
    return d["name"], d["arguments"]


class _HTTPServer(ThreadingHTTPServer):
    """The listening socket with a backlog for many clients at once: the
    default of 5 resets the connections of a burst the accept loop has not
    reached yet."""

    request_queue_size = 128


class _ToolStream:
    """A constrained tool call streamed as OpenAI tool_calls chunks (JAX
    serving.py:912-979): the grammar makes the text
    `{"name":<json string>,"arguments":` + arguments + `}`, so the name goes
    out once, with the call's id, as soon as it is complete, then the
    arguments' characters as deltas. One character is held back: the last
    `}` closes the wrapper, not the arguments, and only the finish (call
    complete, or cut by the budget) tells which. Called with each text delta
    and None at the end."""

    MARKER = ',"arguments":'

    def __init__(self, emit, pend: "_Pending"):
        self.emit, self.pend = emit, pend
        self.text = ""
        self.args_at = -1  # where the arguments value starts
        self.sent = 0  # argument characters already emitted
        self.call_id = f"call_{uuid.uuid4().hex[:24]}"

    def __call__(self, chunk: Optional[str]) -> None:
        if chunk is not None:
            self.text += chunk
        if self.args_at < 0:
            try:
                name, after = json.JSONDecoder().raw_decode(self.text, 8)
            except (ValueError, IndexError):
                name = None
            if name is not None and self.text.startswith(self.MARKER, after):
                self.args_at = after + len(self.MARKER)
                self.emit({"tool_calls": [{"index": 0, "id": self.call_id, "type": "function",
                                           "function": {"name": name, "arguments": ""}}]}, None)
            elif chunk is None:  # the budget ended inside the name
                self.emit({}, self.pend.finish_reason or "length")
                return
            else:
                return
        if chunk is None:  # finish: flush all but the wrapper's }
            args = self.text[self.args_at:]
            done = _parse_tool_call(self.text) is not None
            if done and args.endswith("}"):
                args = args[:-1]
            delta = args[self.sent:]
            self.sent = len(args)
            self.emit({"tool_calls": [{"index": 0, "function": {"arguments": delta}}]}
                      if delta else {}, "tool_calls" if done
                      else self.pend.finish_reason or "length")
            return
        avail = len(self.text) - self.args_at - 1  # hold one back
        if avail > self.sent:
            delta = self.text[self.args_at + self.sent:self.args_at + avail]
            self.sent = avail
            self.emit({"tool_calls": [{"index": 0, "function": {"arguments": delta}}]}, None)


class _RequestError(Exception):
    """A request the server refuses: the HTTP code and the message."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class _EmbedJob:
    """One /v1/embeddings call for the engine thread: its texts and pooling,
    and the result ((f32 [B, D], prompt tokens)) or the error."""

    def __init__(self, texts: List[str], pooling: str):
        self.texts, self.pooling = texts, pooling
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


class _Pending:
    """One generation in flight: what the handler asked for and what the
    engine thread reports back."""

    def __init__(self, prompt: str, max_tokens: int, stream: bool = False,
                 stop: Optional[List[str]] = None, sampling: Optional[dict] = None,
                 tool_stream: bool = False):
        self.prompt = prompt
        self.max_tokens = max_tokens
        # submit's keywords: the controls, logit_bias, seed and the grammar
        # key (response_format) (empty: the engine's values, unconstrained).
        self.sampling = sampling or {}
        # A streamed forced tool call: deltas go out as tool_calls chunks.
        self.tool_stream = tool_stream
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.stream = stream
        self.stop = stop or []  # stop strings (matched on the host)
        self.chunks: "queue.Queue[Optional[str]]" = queue.Queue()  # stream deltas
        self.sent_text = ""  # decoded text already emitted or observed
        self.final_text: Optional[str] = None  # the text cut at a stop string
        self.finish_reason: Optional[str] = None
        self.created = time.time()
        self.cancel_sent = False


def _request_sampling(body: dict, engine: Engine) -> dict:
    """submit's keywords from a request body: the controls, logit_bias and
    seed it sets. On an engine without per_request_sampling a control equal
    to the engine's own value is dropped (the step uses it anyway); any
    other stays, and check_request refuses it."""
    casts = {"top_k": int}
    out = {}
    try:
        for name in CONTROLS:
            if body.get(name) is not None:
                out[name] = casts.get(name, float)(body[name])
        if body.get("logit_bias"):
            out["logit_bias"] = {int(k): float(v) for k, v in body["logit_bias"].items()}
        if body.get("seed") is not None:
            out["seed"] = int(body["seed"])
    except (TypeError, ValueError, AttributeError) as err:
        raise _RequestError(400, f"malformed sampling field: {err}") from err
    if not engine.config.per_request_sampling:
        own = engine.sampling_defaults()
        out = {k: v for k, v in out.items() if k not in CONTROLS or v != own[CONTROLS[k]]}
    return out


def _candidate_sampling(sampling: dict, i: int) -> dict:
    """The sampling of candidate i of n / best_of (JAX's _cand_sampling):
    an explicit seed perturbed for i > 0, else identical candidates."""
    if i == 0 or sampling.get("seed") is None:
        return sampling
    return dict(sampling, seed=(sampling["seed"] ^ (0x9E3779B1 * i)) & 0x7FFFFFFF)


class InferenceServer:
    def __init__(self, engine: Engine, n_slots: int = 8, host: str = "127.0.0.1",
                 port: int = 8000, poll_every: int = POLL_EVERY,
                 request_timeout: Optional[float] = None):
        """poll_every: the batcher's longest chunk (decode steps between two
        polls). request_timeout: seconds after which a request is cancelled
        and its slot freed (finish_reason "cancelled"); None = unbounded."""
        self.engine = engine
        self.batcher = ContinuousBatcher(engine, n_slots=n_slots, poll_every=poll_every)
        self.host, self.port = host, port
        self.request_timeout = request_timeout
        self._incoming: "queue.Queue[_Pending]" = queue.Queue()
        self._embed_jobs: "queue.Queue[_EmbedJob]" = queue.Queue()
        # Cancels cross from handler threads to the engine thread here: only
        # the engine thread writes the device's active flags.
        self._cancels: "queue.Queue[_Pending]" = queue.Queue()
        self._wake = threading.Event()
        # Orders a handler's enqueue against the engine thread's failure, so
        # no request is queued after _fail_all drained the queue.
        self._lock = threading.Lock()
        self._inflight: Dict[int, _Pending] = {}
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._httpd: Optional[_HTTPServer] = None
        self._started_at = time.time()
        self._served = 0
        self.failure: Optional[str] = None  # what stopped the engine thread
        # Host ms of each section of the engine loop (JAX's loop_ms, /stats):
        # where a serving cycle's wall goes beside the batcher's counters.
        self.loop_ms: Dict[str, float] = {
            "submit": 0.0, "decode_poll": 0.0, "admit": 0.0, "cancel_scan": 0.0,
            "streams": 0.0, "finalize": 0.0,
        }

    # ------------------------------------------------------------- engine
    def _engine_loop(self) -> None:
        try:
            with torch.inference_mode():
                self._serve()
        except Exception as err:  # every waiter hears of it; nothing is dropped
            logging.getLogger(__name__).exception("the engine thread failed")
            self._fail_all(f"{type(err).__name__}: {err}")

    def _fail_all(self, failure: str) -> None:
        pending = list(self._inflight.values())
        with self._lock:
            self.failure = failure
            for q in (self._incoming, self._embed_jobs):
                while True:
                    try:
                        pending.append(q.get_nowait())
                    except queue.Empty:
                        break
        for p in pending:
            if isinstance(p, _EmbedJob):
                p.error = f"the engine failed: {self.failure}"
                p.event.set()
                continue
            p.error = f"the engine failed: {self.failure}"
            p.chunks.put(None)
            p.event.set()

    def _submit_incoming(self) -> bool:
        """Submit every queued request to the batcher; True if any came."""
        b, drained = self.batcher, False
        while True:
            try:
                p = self._incoming.get_nowait()
            except queue.Empty:
                return drained
            drained = True
            try:
                rid = b.submit(p.prompt, max_new_tokens=p.max_tokens, **p.sampling)
            except (ValueError, NotImplementedError, TypeError) as err:
                p.error = str(err)
                p.chunks.put(None)
                p.event.set()
                continue
            self._inflight[rid] = p

    def _run_embeddings(self) -> None:
        """Every queued embedding call, each one Engine.embed forward on
        this thread (the one that owns the card), between decode chunks."""
        while True:
            try:
                job = self._embed_jobs.get_nowait()
            except queue.Empty:
                return
            try:
                job.result = self.engine.embed(job.texts, pooling=job.pooling)
            except (ValueError, NotImplementedError) as err:
                job.error = str(err)
            job.event.set()

    def _serve(self) -> None:
        b, lm = self.batcher, self.loop_ms
        while not self._stop.is_set():
            self._run_embeddings()  # JAX's loop does not time them either
            t0 = time.perf_counter()
            drained = self._submit_incoming()
            lm["submit"] += (time.perf_counter() - t0) * 1e3
            if (drained or b.scheduler.pending()) and not any(s is not None for s in b._slots):
                b._admit_pending()  # nothing decoding: admit now
            if not any(s is not None for s in b._slots):
                self._finalize_done()  # requests cancelled in the queue
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            t1 = time.perf_counter()
            flags = b.poll_flags_async()
            b.step_chunk()
            b._admit_overlapped()
            fresh = b._prefetch_retire(flags)
            b._retire_finished(fresh if fresh is not None else flags)
            t2 = time.perf_counter()
            lm["decode_poll"] += (t2 - t1) * 1e3
            b._admit_post_poll()
            t3 = time.perf_counter()
            lm["admit"] += (t3 - t2) * 1e3
            self._scan_cancels()
            t4 = time.perf_counter()
            lm["cancel_scan"] += (t4 - t3) * 1e3
            self._observe_streams()
            t5 = time.perf_counter()
            lm["streams"] += (t5 - t4) * 1e3
            self._finalize_done()
            lm["finalize"] += (time.perf_counter() - t5) * 1e3

    def _scan_cancels(self) -> None:
        """Client disconnects (queued by handler threads) and requests past
        request_timeout: cancel them in the batcher."""
        gone = []
        while True:
            try:
                gone.append(self._cancels.get_nowait())
            except queue.Empty:
                break
        now = time.time()
        for rid, p in list(self._inflight.items()):
            late = (self.request_timeout is not None and p.result is None
                    and now - p.created > self.request_timeout)
            if (late or any(p is g for g in gone)) and not p.cancel_sent:
                p.cancel_sent = True
                self.batcher.cancel(rid)

    def _finalize_done(self) -> None:
        b = self.batcher
        for rid in list(b._done):
            pend = self._inflight.pop(rid, None)
            if pend is not None:
                pend.result = b._done[rid].result
                self._finalize(pend)
                self._served += 1
            del b._done[rid]

    def _decode(self, ids) -> str:
        eos = self.engine.eos_token_id
        return self.engine.tokenizer.decode([t for t in ids if t != eos])

    @staticmethod
    def _match_stop(pend: _Pending, text: str) -> int:
        """Index of the earliest stop string in `text`, or -1."""
        hits = [text.find(s) for s in pend.stop if s and s in text]
        return min(hits) if hits else -1

    def _observe_streams(self) -> None:
        """After each poll, for the streaming and stop-string requests in
        flight: one read of every slot's tokens (none when there is no such
        request), the text decoded whole and diffed (a multi-byte character
        waits for its last byte), stop strings matched and their slots
        cancelled at once."""
        watch = {rid: p for rid, p in self._inflight.items()
                 if (p.stream or p.stop) and p.final_text is None}
        if not watch:
            return
        gen = self.batcher.poll_generated()
        for rid, pend in watch.items():
            if rid not in gen:
                continue  # queued, or retired: _finalize has the tail
            text = self._decode(gen[rid])
            cut = self._match_stop(pend, text)
            if cut >= 0:
                pend.final_text = text = text[:cut]
                pend.finish_reason = "stop"
                self.batcher.cancel(rid)  # the slot frees at the next poll
            if pend.stream and len(text) > len(pend.sent_text):
                pend.chunks.put(text[len(pend.sent_text):])
            if len(text) > len(pend.sent_text) or cut >= 0:
                pend.sent_text = text

    def _finalize(self, pend: _Pending) -> None:
        """The final text and finish_reason from the batcher's result (cut at
        a stop string), the stream's last delta, and the waiter woken."""
        r = pend.result
        if pend.final_text is None:
            text = r["text"]
            cut = self._match_stop(pend, text)
            if cut >= 0:
                text = text[:cut]
                pend.finish_reason = "stop"
            pend.final_text = text
        if pend.finish_reason is None:
            pend.finish_reason = r.get("finish_reason", "stop")
        if pend.stream:
            if len(pend.final_text) > len(pend.sent_text):
                pend.chunks.put(pend.final_text[len(pend.sent_text):])
            pend.chunks.put(None)  # the stream is complete
        pend.event.set()

    def _enqueue(self, pend: _Pending) -> None:
        with self._lock:
            if self.failure is not None:
                raise _RequestError(500, f"the engine failed: {self.failure}")
            self._incoming.put(pend)
        self._wake.set()

    # --------------------------------------------------------------- http
    def _parse(self, path: str, body: dict) -> dict:
        """A POST body as what the engine thread needs: the prompt, the
        options and the sampling. Raises _RequestError for what is refused."""
        eng = self.engine
        cfg = eng.config
        chat = path == "/v1/chat/completions"
        tools = None
        if not chat:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            if not isinstance(prompt, str):
                raise _RequestError(400, "prompt must be a string")
        else:
            tools = body.get("tools") or None
            lines = []
            if tools:
                lines.append("available tools: " + json.dumps(tools))
            for m in body.get("messages", []):
                role, content = m.get("role", "user"), m.get("content", "")
                if role == "assistant" and m.get("tool_calls"):
                    content = json.dumps(m["tool_calls"])
                lines.append(f"{role}: {content}")
            prompt = "\n".join(lines) + "\nassistant:"
        # OpenAI `model` routing (multi-LoRA): an adapter's name selects it;
        # the base model's name, or none, the base.
        model = body.get("model")
        lora = None
        if model and model != cfg.base_model:
            if not isinstance(model, str) or model not in eng.lora_names:
                raise _RequestError(404, f"model {model!r} not found (base or a loaded LoRA "
                                         "adapter)")
            lora = model
        rf_type = self._response_format(body)
        tool_names, tool_parse = None, None
        if tools:
            try:
                tool_names = [(t.get("function", t) or {}).get("name") for t in tools]
            except AttributeError:
                raise _RequestError(400, "malformed tools list") from None
            rf_type, tool_parse = self._tool_choice(body.get("tool_choice", "auto"),
                                                    tool_names, rf_type)
        sampling = _request_sampling(body, eng)
        if rf_type is not None:
            sampling["response_format"] = rf_type
        if lora is not None:
            sampling["lora"] = lora
        try:
            self.batcher.check_request(**sampling)
        except (ValueError, NotImplementedError, TypeError) as err:
            raise _RequestError(400, str(err)) from None
        try:
            max_tokens = int(body.get("max_tokens") or body.get("max_completion_tokens")
                             or cfg.max_new_tokens)
            n = max(1, min(int(body.get("n") or 1), MAX_N))
            best_of = n if chat else max(n, min(int(body.get("best_of") or n), MAX_N))
        except (TypeError, ValueError) as err:
            raise _RequestError(400, f"malformed field: {err}") from None
        stream = bool(body.get("stream", False))
        if n > 1 and stream:
            raise _RequestError(400, "n > 1 with stream is not supported")
        if stream and best_of != n:
            raise _RequestError(400, "best_of != n is not supported with stream")
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        opts = body.get("stream_options")
        return dict(chat=chat, prompt=prompt, max_tokens=max_tokens, n=n, best_of=best_of,
                    stream=stream, stop=stop, sampling=sampling, tool_names=tool_names,
                    tool_parse=tool_parse,
                    stream_usage=bool(opts.get("include_usage")) if isinstance(opts, dict)
                    else False)

    def _embeddings(self, body: dict) -> dict:
        """An /v1/embeddings request (JAX serving.py:822-879, its 400s): the
        texts go to the engine thread, which runs Engine.embed; the vectors
        come back as float lists or base64 of little-endian f32."""
        inp = body.get("input", "")
        texts = ([inp] if isinstance(inp, str)
                 else list(inp) if isinstance(inp, (list, tuple)) else None)
        if not texts or not all(isinstance(t, str) for t in texts):
            raise _RequestError(400, "input must be a string or list of strings")
        if len(texts) > MAX_EMBED_INPUTS:
            raise _RequestError(400, f"at most {MAX_EMBED_INPUTS} inputs")
        fmt = body.get("encoding_format", "float")
        if fmt not in ("float", "base64"):
            raise _RequestError(400, f"unsupported encoding_format {fmt!r}")
        pooling = body.get("pooling", "mean")
        if pooling not in ("mean", "last"):
            raise _RequestError(400, f"unsupported pooling {pooling!r}")
        job = _EmbedJob(texts, pooling)
        with self._lock:
            if self.failure is not None:
                raise _RequestError(500, f"the engine failed: {self.failure}")
            self._embed_jobs.put(job)
        self._wake.set()
        if not job.event.wait(timeout=WAIT_S):
            raise _RequestError(504, "embedding timed out")
        if job.error is not None:
            raise _RequestError(500 if self.failure else 400, job.error)
        emb, n_tok = job.result

        def enc(row):
            if fmt == "base64":
                return base64.b64encode(row.astype("<f4").tobytes()).decode()
            return [float(x) for x in row]

        return {"object": "list", "model": self.engine.config.base_model,
                "data": [{"object": "embedding", "index": i, "embedding": enc(emb[i])}
                         for i in range(emb.shape[0])],
                "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok}}

    def _response_format(self, body: dict) -> Optional[str]:
        """The grammar key of response_format (or vLLM's guided_regex), None
        for text; 400 with JAX's message (serving.py:482-540) for one the
        deployment's grammar cannot serve: no tables, another grammar, a
        schema or pattern other than the compiled one."""
        eng = self.engine
        cfg = eng.config
        rf = body.get("response_format") or {}
        if body.get("guided_regex") and not rf:
            rf = {"type": "regex", "pattern": body["guided_regex"]}
        rf_type = rf.get("type") if isinstance(rf, dict) else rf
        served = eng._fsm_initial_map
        if rf_type in (None, "text"):
            return None
        if rf_type == "regex":
            if "regex" not in served:
                raise _RequestError(400, "this server's grammar cannot serve regex (start with "
                                         "EngineConfig(constrain='regex', constrain_regex=...))")
            pat = rf.get("pattern") if isinstance(rf, dict) else None
            if pat is not None and pat != cfg.constrain_regex:
                raise _RequestError(400, "request pattern does not match the pattern this "
                                         "server was compiled with")
        elif rf_type in ("json", "json_object", "json_schema"):
            if eng._constrain_tbl is None or rf_type not in served:
                raise _RequestError(400, f"this server's grammar cannot serve response_format "
                                         f"{rf_type!r} (started with EngineConfig.constrain="
                                         f"{cfg.constrain!r})")
            schema = ((rf.get("json_schema") or {}).get("schema")
                      if rf_type == "json_schema" and isinstance(rf, dict) else None)
            if schema is not None and schema != cfg.constrain_schema:
                raise _RequestError(400, "request schema does not match the schema this server "
                                         "was compiled with")
        else:
            raise _RequestError(400, f"unsupported response_format {rf_type!r}")
        return rf_type

    def _tool_choice(self, choice, tool_names: List[str], rf_type: Optional[str]) -> tuple:
        """(grammar key, tool parse) of a chat request with tools (JAX
        serving.py:542-590): "none" neither; "auto" parses a call from
        unconstrained text; "required" (any tool) and a named function
        constrain decoding to the engine's tool grammar ("force"), 400 when
        it was not compiled with them."""
        avail = self.engine._fsm_initial_map if self.engine.config.tools else {}
        if choice in (None, "none"):
            return rf_type, None
        if choice == "auto":
            return rf_type, "auto"
        if choice == "required":
            compiled = {k.split(":", 1)[1] for k in avail if ":" in k}
            if not compiled or not compiled <= set(tool_names):
                raise _RequestError(400, "tool_choice 'required' needs the server started with "
                                         "EngineConfig(tools=...) whose tools the request's "
                                         f"list covers (compiled: {sorted(compiled)})")
            return "tool_call", "force"
        if isinstance(choice, dict) and choice.get("type") == "function":
            name = (choice.get("function") or {}).get("name")
            if f"tool_call:{name}" not in avail:
                raise _RequestError(400, f"tool {name!r} is not compiled into this server's "
                                         "tool grammar")
            return f"tool_call:{name}", "force"
        raise _RequestError(400, f"unsupported tool_choice {choice!r}")

    def _logprobs(self, body: dict, chat: bool, prompt: str, res: dict) -> Optional[dict]:
        """The choice's logprobs in OpenAI's shape (JAX's lp_of): null unless
        asked; completions' int and chat's top_logprobs trim the captured
        top N; echo covers the prompt too."""
        lpq = body.get("logprobs")
        if lpq is None or lpq is False or not res.get("token_logprobs"):
            return None
        dec = self.engine.tokenizer.decode
        toks = [dec([t]) for t in res["generated_ids"]]
        tops = res.get("top_logprobs")
        want_n = body.get("top_logprobs")
        if want_n is None and not chat and isinstance(lpq, int) and not isinstance(lpq, bool):
            want_n = lpq
        if tops and want_n is not None:
            want_n = max(0, int(want_n))
            tops = [pos[:want_n] for pos in tops] if want_n else None

        def by_text(pos):
            # The legacy format keys by decoded text; two ids may decode
            # alike: the more likely one stays.
            d: Dict[str, float] = {}
            for alt in pos:
                key = dec([alt["id"]])
                if key not in d or alt["logprob"] > d[key]:
                    d[key] = alt["logprob"]
            return d

        top_fmt = [by_text(pos) for pos in tops] if tops else None
        if not chat and body.get("echo"):
            p_ids = self.engine.tokenizer.encode(prompt)
            p_lps = res.get("prompt_logprobs") or [None] * len(p_ids)
            return {"tokens": [dec([t]) for t in p_ids] + toks,
                    "token_logprobs": list(p_lps[:len(p_ids)]) + list(res["token_logprobs"]),
                    "top_logprobs": [None] * len(p_ids) + top_fmt if top_fmt else None,
                    "text_offset": []}
        if chat:
            return {"content": [
                {"token": t, "logprob": lp,
                 **({"top_logprobs": [{"token": dec([alt["id"]]), "logprob": alt["logprob"]}
                                      for alt in tops[i]]} if tops else {})}
                for i, (t, lp) in enumerate(zip(toks, res["token_logprobs"]))]}
        return {"tokens": toks, "token_logprobs": res["token_logprobs"], "top_logprobs": top_fmt,
                "text_offset": []}

    def _respond(self, body: dict, req: dict, cands: List[_Pending]) -> dict:
        """The completion or chat.completion body of finished candidates."""
        chat, prompt, n = req["chat"], req["prompt"], req["n"]
        usage = {"prompt_tokens": len(self.engine.tokenizer.encode(prompt)),
                 "completion_tokens": sum(p.result["generated_tokens"] for p in cands)}
        usage["total_tokens"] = usage["prompt_tokens"] + usage["completion_tokens"]
        if len(cands) > n:  # best_of: the highest mean token logprob
            def mean_lp(p):
                lps = p.result.get("token_logprobs") or []
                return sum(lps) / max(len(lps), 1)

            cands = sorted(cands, key=mean_lp, reverse=True)[:n]

        def text_of(p):
            t = p.final_text if p.final_text is not None else p.result["text"]
            return prompt + t if body.get("echo") and not chat else t

        model = self.engine.config.base_model
        if not chat:
            r = cands[0].result
            return {"id": f"cmpl-{uuid.uuid4().hex[:12]}", "object": "text_completion",
                    "model": model,
                    "choices": [{"index": i, "text": text_of(p), "finish_reason": p.finish_reason,
                                 "logprobs": self._logprobs(body, chat, prompt, p.result)}
                                for i, p in enumerate(cands)],
                    "usage": usage,
                    "specdx": {"acceptance_rate": r["acceptance_rate"],
                               "latency_ms": r["latency_ms"]}}
        choices = []
        for i, p in enumerate(cands):
            text, finish = text_of(p), p.finish_reason
            message: Dict[str, Any] = {"role": "assistant", "content": text}
            if req["tool_parse"]:
                # Forced: the grammar guarantees the shape unless the budget
                # cut the call (then the raw text and "length" pass).
                tc = _parse_tool_call(text, allowed=req["tool_names"])
                if tc is not None:
                    message = {"role": "assistant", "content": None, "tool_calls": [{
                        "id": f"call_{uuid.uuid4().hex[:24]}", "type": "function",
                        "function": {"name": tc[0], "arguments": json.dumps(tc[1])}}]}
                    finish = "tool_calls"
            choices.append({"index": i, "message": message, "finish_reason": finish,
                            "logprobs": self._logprobs(body, chat, prompt, p.result)})
        return {"id": f"chatcmpl-{uuid.uuid4().hex[:12]}", "object": "chat.completion",
                "model": model, "choices": choices, "usage": usage}

    def _metrics(self) -> str:
        b = self.batcher
        occupied = sum(1 for s in b._slots if s is not None)
        lines = [
            "# TYPE specdx_requests_served_total counter",
            f"specdx_requests_served_total {self._served}",
            "# TYPE specdx_uptime_seconds gauge",
            f"specdx_uptime_seconds {time.time() - self._started_at:.1f}",
            "# TYPE specdx_slots_occupied gauge",
            f"specdx_slots_occupied {occupied}",
            "# TYPE specdx_slots_total gauge",
            f"specdx_slots_total {b.n_slots}",
            "# TYPE specdx_queue_pending gauge",
            f"specdx_queue_pending {b.scheduler.pending()}",
            "# TYPE specdx_draft_k gauge",
            f"specdx_draft_k {self.engine.config.max_draft}",
        ]
        if b.paged:
            lines += ["# TYPE specdx_kv_pages_free gauge",
                      f"specdx_kv_pages_free {b.allocator.free_pages}"]
        if b.prefix_caching:
            lines += [
                "# TYPE specdx_prefix_cache_page_hits_total counter",
                f"specdx_prefix_cache_page_hits_total {b.allocator.hits}",
                "# TYPE specdx_prefix_cache_page_misses_total counter",
                f"specdx_prefix_cache_page_misses_total {b.allocator.misses}",
                "# TYPE specdx_prefix_cache_resident_pages gauge",
                f"specdx_prefix_cache_resident_pages {b.allocator.reclaimable_pages}",
            ]
        return "\n".join(lines) + "\n"

    def _make_handler(server: "InferenceServer"):
        outer = server

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, data: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code: int, body: dict) -> None:
                self._send(code, json.dumps(body).encode(), "application/json")

            def do_GET(self):
                cfg = outer.engine.config
                if self.path == "/health":
                    self._json(200, {"status": "ok" if outer.failure is None else "failed",
                                     "uptime_s": round(time.time() - outer._started_at, 1),
                                     "served": outer._served, "model": cfg.base_model})
                elif self.path == "/stats":
                    self._json(200, {"served": outer._served,
                                     "loop_ms": {k: round(v, 1)
                                                 for k, v in outer.loop_ms.items()},
                                     "batcher": outer.batcher.stats.report(
                                         outer.batcher.n_slots)})
                elif self.path == "/v1/models":
                    # The base model and every LoRA adapter (each addressable
                    # through the `model` field).
                    self._json(200, {"object": "list", "data": [
                        {"id": cfg.base_model, "object": "model"}] + [
                        {"id": name, "object": "model", "parent": cfg.base_model}
                        for name in sorted(outer.engine.lora_names)]})
                elif self.path == "/metrics":
                    self._send(200, outer._metrics().encode(), "text/plain; version=0.0.4")
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("not an object")
                except Exception:
                    self._json(400, {"error": "invalid JSON"})
                    return
                if self.path == "/v1/embeddings":
                    try:
                        self._json(200, outer._embeddings(body))
                    except _RequestError as err:
                        self._json(err.code, {"error": str(err)})
                    return
                if self.path not in ("/v1/completions", "/v1/chat/completions"):
                    self._json(404, {"error": "not found"})
                    return
                try:
                    req = outer._parse(self.path, body)
                    pend = _Pending(req["prompt"], req["max_tokens"], stream=req["stream"],
                                    stop=req["stop"], sampling=req["sampling"],
                                    tool_stream=req["stream"] and req["tool_parse"] == "force")
                    extra = [_Pending(req["prompt"], req["max_tokens"], stop=req["stop"],
                                      sampling=_candidate_sampling(req["sampling"], i + 1))
                             for i in range(req["best_of"] - 1)]
                    for p in [pend] + extra:
                        outer._enqueue(p)
                except _RequestError as err:
                    self._json(err.code, {"error": str(err)})
                    return
                if req["stream"]:
                    self._stream(pend, req)
                    return
                cands = [pend] + extra
                for p in cands:
                    if not p.event.wait(timeout=WAIT_S):
                        self._json(504, {"error": "generation timed out"})
                        return
                failed = [p.error for p in cands if p.error is not None]
                if failed:
                    self._json(500 if outer.failure else 400, {"error": failed[0]})
                    return
                self._json(200, outer._respond(body, req, cands))

            def _stream(self, pend: _Pending, req: dict) -> None:
                """Server-sent events: a chunk per observed delta, then a
                finish_reason chunk (and a usage chunk when asked), then
                ``data: [DONE]``."""
                chat = req["chat"]
                rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:12]}"
                model = outer.engine.config.base_model
                obj = "chat.completion.chunk" if chat else "text_completion"
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()

                def send(payload) -> None:
                    text = payload if isinstance(payload, str) else json.dumps(payload)
                    self.wfile.write(f"data: {text}\n\n".encode())
                    self.wfile.flush()

                def emit(delta: Optional[str], finish: Optional[str]) -> None:
                    if chat:
                        choice = {"index": 0, "delta": {} if delta is None else {"content": delta},
                                  "finish_reason": finish}
                    else:
                        choice = {"index": 0, "text": delta or "", "finish_reason": finish}
                    send({"id": rid, "object": obj, "model": model, "choices": [choice]})

                def emit_tool(delta: dict, finish: Optional[str]) -> None:
                    send({"id": rid, "object": obj, "model": model,
                          "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]})

                tool_feed = _ToolStream(emit_tool, pend) if pend.tool_stream else None

                deadline = time.time() + WAIT_S
                try:
                    if chat:  # the role preamble (OpenAI's convention)
                        send({"id": rid, "object": obj, "model": model,
                              "choices": [{"index": 0, "delta": {"role": "assistant"},
                                           "finish_reason": None}]})
                    while True:
                        try:
                            chunk = pend.chunks.get(timeout=1.0)
                        except queue.Empty:
                            if time.time() > deadline:
                                break
                            continue
                        if chunk is not None:
                            if tool_feed is not None:
                                tool_feed(chunk)
                            else:
                                emit(chunk, None)
                            continue
                        if pend.error is not None:
                            send({"error": pend.error})
                        else:
                            if tool_feed is not None:
                                tool_feed(None)
                            else:
                                emit(None, pend.finish_reason or "stop")
                            if req["stream_usage"]:
                                n_p = len(outer.engine.tokenizer.encode(req["prompt"]))
                                n_c = (pend.result or {}).get("generated_tokens", 0)
                                send({"id": rid, "object": obj, "model": model, "choices": [],
                                      "usage": {"prompt_tokens": n_p, "completion_tokens": n_c,
                                                "total_tokens": n_p + n_c}})
                        send("[DONE]")
                        break
                except (BrokenPipeError, ConnectionResetError):
                    # The client went away: the engine thread cancels.
                    outer._cancels.put(pend)

        return Handler

    # ---------------------------------------------------------- lifecycle
    def start(self, block: bool = False) -> None:
        self._worker = threading.Thread(target=self._engine_loop, name="engine", daemon=True)
        self._worker.start()
        self._httpd = _HTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]  # port 0: the one given
        self._http_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._http_thread.start()
        if block:
            try:
                while not self._stop.is_set():
                    time.sleep(1)
            except KeyboardInterrupt:
                self.stop()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._worker is not None:
            self._worker.join(timeout=30)


def main(argv: Optional[List[str]] = None) -> int:  # pragma: no cover - thin CLI
    """``specdx-torch serve`` (cli.py): one parser of the config's flags."""
    from llm_inference_lab_tpu_torch.cli import main as cli_main

    return cli_main(["serve", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

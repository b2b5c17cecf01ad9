"""Tool-call grammar (OpenAI `tools` / function calling).

Host numpy, a copy of llm_inference_lab_tpu/constrain/tools.py (the port
imports nothing of the JAX package); the tables it gives equal JAX's array
for array (tests/test_torch_constrain_tables.py).

Compiles a tool list into ONE char-DFA whose language is exactly
    {"name":<one of the tool names>,"arguments":<value conforming to
     that tool's `parameters` JSON schema>}
with multiple initial states:

  - "tool_call"           — any of the tools (OpenAI tool_choice
                            "required"): a character trie over the tool
                            names routes to that tool's arguments schema
                            the moment the name is complete, so the
                            model can never pair tool A's name with tool
                            B's argument shape.
  - "tool_call:<name>"    — exactly that tool (OpenAI tool_choice
                            {"type":"function","function":{"name":...}});
                            the per-tool entry spells the fixed
                            `{"name":"<name>"` prefix and then reuses the
                            SAME shared arguments chain as the trie path,
                            so forced entries cost ~len(name) extra
                            states, not a second schema copy.

The automaton feeds the same token-table compiler and device runtime as
the generic JSON PDA (jsonfsm.compile_token_tables / constrain.runtime):
masks and transitions happen inside the compiled step. EOS only unlocks
at the closing `}` of a complete call. The wrapper object is emitted
compact (no whitespace) regardless of the `whitespace` flag — it is
machine-read, and compact output is token-minimal; `whitespace` only
loosens the arguments value (schema.py semantics).

Reference has no tool calling (the lab serves raw completions); this is
serving-parity with vLLM/OpenAI-style guided function calling, built on
the structured-outputs machinery (schema.py).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from llm_inference_lab_tpu_torch.constrain.jsonfsm import CharAutomaton
from llm_inference_lab_tpu_torch.constrain.schema import _Builder, _value


def normalize_tools(tools: List[dict]) -> List[Tuple[str, dict]]:
    """Accept OpenAI nested form ({"type":"function","function":{...}})
    or flat ({"name":..., "parameters":...}); return [(name, schema)].
    A tool without parameters takes arguments {} (empty object)."""
    out: List[Tuple[str, dict]] = []
    for t in tools:
        fn = t.get("function", t) if isinstance(t, dict) else None
        if not isinstance(fn, dict) or not fn.get("name"):
            raise ValueError(f"malformed tool entry: {t!r}")
        params = fn.get("parameters") or {
            "type": "object", "properties": {},
        }
        out.append((str(fn["name"]), params))
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tool names: {names}")
    return out


def _trie_routed(b: _Builder, routes: List[Tuple[str, int]], entry: int):
    """Deterministic char trie over distinct texts, each routing to its
    OWN exit state on completion. Unlike schema._trie there is no shared
    exit; strict-prefix texts are impossible here (every text ends with
    an unescaped '"' that cannot appear mid-way in another name's JSON
    encoding), so completion nodes are unambiguous."""
    groups: Dict[str, List[Tuple[str, int]]] = {}
    for text, exit_ in routes:
        assert text, "empty route text"
        groups.setdefault(text[0], []).append((text[1:], exit_))
    for ch, suffixes in groups.items():
        done = [e for s, e in suffixes if s == ""]
        rest = [(s, e) for s, e in suffixes if s != ""]
        if done and rest:
            raise ValueError("tool name encodings collide (prefix)")
        if done:
            (exit_,) = done
            b.edge(entry, ch, exit_)
        else:
            nxt = b.new()
            b.edge(entry, ch, nxt)
            _trie_routed(b, rest, nxt)


def build_tools_automaton(
    tools: List[dict], whitespace: bool = False,
) -> Tuple[CharAutomaton, Dict[str, int]]:
    """Compile `tools` into a CharAutomaton plus an initial-state map
    {"tool_call": <any-tool entry>, "tool_call:<name>": <forced entry>}.
    The map's values are base char-state ids, which survive
    compile_token_tables unchanged (base rows keep their index)."""
    norm = normalize_tools(tools)
    b = _Builder(whitespace=whitespace)
    any_entry = b.new()
    done = b.new()

    # Shared per-tool arguments chain: from "expects ','" (right after
    # the name's closing quote) through `,"arguments":<value>}` to done.
    initials: Dict[str, int] = {"tool_call": any_entry}
    routes: List[Tuple[str, int]] = []
    for name, params in norm:
        arg_entry = b.new()  # expects ','
        cur = arg_entry
        for ch in ',"arguments":':
            nxt = b.new()
            b.edge(cur, ch, nxt)
            cur = nxt
        after_val = b.new()
        _value(b, params, cur, after_val)
        b.edge(after_val, "}", done)

        # Forced entry: `{"name":"<name>"` spelled exactly, with the
        # final (closing-quote) edge landing on the shared arguments
        # chain. json.dumps gives the exact JSON encoding (escapes
        # included) — the same bytes the trie route matches.
        text = '{"name":' + json.dumps(name)
        forced = b.new()
        fcur = forced
        for ch in text[:-1]:
            nxt = b.new()
            b.edge(fcur, ch, nxt)
            fcur = nxt
        b.edge(fcur, text[-1], arg_entry)
        initials[f"tool_call:{name}"] = forced
        routes.append(('{"name":' + json.dumps(name), arg_entry))

    # Any-tool entry: shared `{"name":` prefix then the name trie; each
    # completed name lands on its shared arguments chain.
    _trie_routed(b, routes, any_entry)

    return b.finish(initial=any_entry, accept=done), initials

"""JSON-Schema -> char-level DFA (OpenAI structured outputs).

Host numpy, a copy of llm_inference_lab_tpu/constrain/schema.py (the port
imports nothing of the JAX package); the tables it gives equal JAX's array
for array (tests/test_torch_constrain_tables.py).

A schema without recursive $refs describes a REGULAR language over
characters: nesting is finite and known, so objects/arrays inline into
plain states — no pushdown needed. The resulting CharAutomaton feeds the
SAME token-table compiler and device runtime as the generic JSON PDA
(jsonfsm.compile_token_tables / constrain.runtime); its entries never set
push/pop/branch flags.

Supported subset (v1, documented):
  {"type": "object", "properties": {...}, "required": [...]}
      — properties are emitted in DECLARATION ORDER; all properties are
        required (the Outlines/vLLM fixed-key-order convention: optional
        or reordered keys would need subset construction over key sets).
  {"type": "string"}            — full JSON string incl. escapes/\\uXXXX
  {"type": "number"}            — JSON number
  {"type": "integer"}           — number without fraction/exponent
  {"type": "boolean"}, {"type": "null"}
  {"type": "array", "items": S, "minItems"?: n, "maxItems"?: m}
      — m - n bounded unrolling; unbounded tail loops
  {"enum": [...]} / {"const": x} — trie over the exact JSON encodings
  {"anyOf": [S1, S2]} / {"oneOf": ...} / {"type": ["string", "null"]}
      — union of alternatives with DISJOINT first characters (distinct
        JSON types always qualify — the nullable-field case); an
        ambiguous union raises at compile time

By default the automaton is COMPACT: no optional whitespace anywhere
(token-minimal output, and a constrained model can't burn its budget
looping on whitespace); pass whitespace=True for the standard
ws-tolerant grammar. Either way generation cannot emit a non-conforming
document, and EOS is only reachable at completion.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from llm_inference_lab_tpu_torch.constrain.jsonfsm import (
    DEAD,
    _DIGITS,
    _HEX,
    _WS,
    CharAutomaton,
)

_D19 = [ord(c) for c in "123456789"]


class _Builder:
    """Grow a [S, 256] table dynamically; states allocated on demand."""

    def __init__(self, whitespace: bool = False):
        # whitespace=False (default) emits COMPACT JSON: no optional
        # whitespace states, so constrained models can't burn budget
        # looping on ws (and outputs are token-minimal — the
        # Outlines/vLLM structured-output convention).
        self.whitespace = whitespace
        self.rows: List[np.ndarray] = []
        # (num_complete_state, continuation_state): overlay cont's row
        # onto the number state AFTER everything is built (numbers end at
        # whatever delimiter the context allows — a deferred row copy).
        self._overlays: List[tuple] = []

    def new(self) -> int:
        self.rows.append(np.full((256,), DEAD, np.int32))
        return len(self.rows) - 1

    def edge(self, s: int, chars, t: int):
        for c in chars if isinstance(chars, (list, tuple)) else [chars]:
            self.rows[s][c if isinstance(c, int) else ord(c)] = t

    def ws_loop(self, s: int):
        if self.whitespace:
            self.edge(s, _WS, s)

    def overlay_later(self, num_state: int, cont: int):
        self._overlays.append((num_state, cont))

    def finish(self, initial: int, accept: int) -> CharAutomaton:
        accepting = np.zeros((len(self.rows),), bool)
        accepting[accept] = True
        # Overlays inherit BOTH the continuation's row (its delimiters)
        # and its accepting flag — a top-level number/integer schema's
        # complete-number states ARE end states (otherwise EOS would
        # never unlock and generation would run to budget), and a prefix
        # enum option ("ab" of {"ab","abc"}) must be finishable. Iterate
        # to a fixpoint: an overlay source may itself be overlaid (e.g.
        # an enum exit that is a number-complete state).
        for _ in range(len(self._overlays) + 1):
            changed = False
            for st, cont in self._overlays:
                row, crow = self.rows[st], self.rows[cont]
                keep = row != DEAD  # own continuations win over delimiters
                merged = np.where(keep, row, crow)
                if not np.array_equal(merged, row):
                    self.rows[st] = merged
                    changed = True
                if accepting[cont] and not accepting[st]:
                    accepting[st] = True
                    changed = True
            if not changed:
                break
        table = np.stack(self.rows)
        return CharAutomaton(
            table=table, accepting=accepting,
            initial=initial, initial_objonly=initial,
        )


def _literal(b: _Builder, text: str, entry: int, exit_: int):
    """Chain states spelling `text` exactly from entry to exit_."""
    _trie(b, [text], entry, exit_)


def _trie(b: _Builder, texts: List[str], entry: int, exit_: int):
    """Deterministic union of exact strings from entry to exit_. A string
    that is a strict prefix of another gets exit_'s row overlaid onto the
    shared node (longer-option chars continue; anything else behaves as
    the continuation — the standard DFA determinization of the union)."""
    groups: Dict[str, List[str]] = {}
    for t in texts:
        if t == "":
            b.overlay_later(entry, exit_)
        else:
            groups.setdefault(t[0], []).append(t[1:])
    for ch, suffixes in groups.items():
        if suffixes == [""]:
            b.edge(entry, ch, exit_)
        else:
            nxt = b.new()
            b.edge(entry, ch, nxt)
            _trie(b, suffixes, nxt, exit_)


def _string_body(b: _Builder, entry: int, exit_: int):
    """JSON string: entry expects the opening quote; exit_ after the
    closing quote. Fresh states per site (different successors)."""
    body = b.new()
    esc = b.new()
    b.edge(entry, '"', body)
    for c in range(0x20, 256):
        b.rows[body][c] = body
    b.edge(body, '"', exit_)
    b.edge(body, "\\", esc)
    b.edge(esc, ['"', "\\", "/", "b", "f", "n", "r", "t"], body)
    u = [b.new() for _ in range(4)]
    b.edge(esc, "u", u[0])
    for i in range(4):
        b.edge(u[i], _HEX, body if i == 3 else u[i + 1])


def _number_body(b: _Builder, entry: int, exit_: int, integer: bool):
    """JSON number from entry; `exit_`'s row is overlaid onto every
    number-complete state so the number ends exactly where the context's
    delimiters begin."""
    minus = b.new()
    zero = b.new()
    integ = b.new()
    b.edge(entry, "-", minus)
    b.edge(entry, "0", zero)
    b.edge(entry, _D19, integ)
    b.edge(minus, "0", zero)
    b.edge(minus, _D19, integ)
    b.edge(integ, _DIGITS, integ)
    complete = [zero, integ]
    if not integer:
        dot = b.new()
        frac = b.new()
        e = b.new()
        esign = b.new()
        exp = b.new()
        for st in (zero, integ):
            b.edge(st, ".", dot)
            b.edge(st, ["e", "E"], e)
        b.edge(dot, _DIGITS, frac)
        b.edge(frac, _DIGITS, frac)
        b.edge(frac, ["e", "E"], e)
        b.edge(e, ["+", "-"], esign)
        b.edge(e, _DIGITS, exp)
        b.edge(esign, _DIGITS, exp)
        b.edge(exp, _DIGITS, exp)
        complete += [frac, exp]
    for st in complete:
        b.overlay_later(st, exit_)


def _value(b: _Builder, schema: Dict, entry: int, exit_: int):
    """Build the automaton of `schema` between entry (expects the value's
    first char; ws allowed) and exit_ (the context's continuation)."""
    b.ws_loop(entry)
    if "enum" in schema or "const" in schema:
        options = schema.get("enum", [schema.get("const")])
        _trie(b, [json.dumps(o) for o in options], entry, exit_)
        return
    t = schema.get("type")
    # anyOf / oneOf / union types (["string", "null"]): alternatives
    # build from the SAME entry into the same exit. Deterministic only
    # when the alternatives' first characters are disjoint — true for
    # distinct JSON types (the overwhelmingly common nullable-field
    # case), checked below; a first-char collision (e.g. two object
    # alternatives) raises rather than silently mis-compiling.
    alts = schema.get("anyOf") or schema.get("oneOf")
    if alts is None and isinstance(t, list):
        alts = [{**schema, "type": x} for x in t]
    if alts is not None:
        claimed = b.rows[entry] != DEAD
        for alt in alts:
            before = b.rows[entry].copy()
            _value(b, alt, entry, exit_)
            changed = b.rows[entry] != before
            if (claimed & changed).any():
                chars = [chr(c) for c in np.nonzero(claimed & changed)[0]]
                raise ValueError(
                    f"ambiguous anyOf: alternatives share first "
                    f"character(s) {chars!r}"
                )
            claimed |= b.rows[entry] != DEAD
        return
    if t == "string":
        _string_body(b, entry, exit_)
    elif t in ("number", "integer"):
        _number_body(b, entry, exit_, integer=(t == "integer"))
    elif t == "boolean":
        _literal(b, "true", entry, exit_)
        _literal(b, "false", entry, exit_)
    elif t == "null":
        _literal(b, "null", entry, exit_)
    elif t == "object":
        props = list((schema.get("properties") or {}).items())
        if not props:
            # {} with optional ws inside
            inner = b.new()
            b.edge(entry, "{", inner)
            b.ws_loop(inner)
            b.edge(inner, "}", exit_)
            return
        cur = b.new()  # after '{'
        b.edge(entry, "{", cur)
        for i, (key, sub) in enumerate(props):
            b.ws_loop(cur)
            colon = b.new()
            _literal(b, json.dumps(key), cur, colon)
            b.ws_loop(colon)
            val_entry = b.new()
            b.edge(colon, ":", val_entry)
            after = b.new()  # after this property's value
            _value(b, sub, val_entry, after)
            b.ws_loop(after)
            if i < len(props) - 1:
                nxt = b.new()
                b.edge(after, ",", nxt)
                cur = nxt
            else:
                b.edge(after, "}", exit_)
    elif t == "array":
        items = schema.get("items", {"type": "number"})
        min_items = int(schema.get("minItems", 0))
        max_items = schema.get("maxItems")
        open_ = b.new()
        b.edge(entry, "[", open_)
        b.ws_loop(open_)
        if max_items is not None and int(max_items) == 0:
            b.edge(open_, "]", exit_)
            return
        if min_items == 0:
            b.edge(open_, "]", exit_)
        # First item then (","+item)* — bounded unroll when maxItems set,
        # else a loop back to a single repeated-item state pair.
        if max_items is not None:
            cur = open_
            for i in range(int(max_items)):
                after = b.new()
                _value(b, items, cur, after)
                b.ws_loop(after)
                if i + 1 >= min_items:
                    b.edge(after, "]", exit_)
                if i < int(max_items) - 1:
                    nxt = b.new()
                    b.edge(after, ",", nxt)
                    b.ws_loop(nxt)
                    cur = nxt
        else:
            # Unrolled prefix up to minItems, then a self-looping tail.
            cur = open_
            for _ in range(max(min_items - 1, 0)):
                after = b.new()
                _value(b, items, cur, after)
                b.ws_loop(after)
                nxt = b.new()
                b.edge(after, ",", nxt)
                b.ws_loop(nxt)
                cur = nxt
            after = b.new()
            _value(b, items, cur, after)
            b.ws_loop(after)
            b.edge(after, "]", exit_)
            again = b.new()
            b.edge(after, ",", again)
            b.ws_loop(again)
            _value(b, items, again, after)
    else:
        raise ValueError(f"unsupported schema: {schema!r}")


def build_schema_automaton(schema: Dict,
                           whitespace: bool = False) -> CharAutomaton:
    """Compile a schema (see module docstring for the subset) into a
    CharAutomaton whose single accepting state is the completed value.
    whitespace=False (default) forces compact JSON — token-minimal and
    immune to ws-looping; =True accepts standard inter-token ws."""
    b = _Builder(whitespace=whitespace)
    entry = b.new()
    done = b.new()
    _value(b, schema, entry, done)
    b.ws_loop(done)
    return b.finish(initial=entry, accept=done)

"""Regex -> char-DFA (guided-regex decoding, vLLM `guided_regex` parity).

Host numpy, a copy of llm_inference_lab_tpu/constrain/regex.py (the port
imports nothing of the JAX package); the tables it gives equal JAX's array
for array (tests/test_torch_constrain_tables.py).

A full-match regex compiles through the classic pipeline — parse ->
Thompson NFA -> subset-construction DFA — into the same CharAutomaton the
JSON/schema/tool grammars produce, so masks and transitions run INSIDE
the compiled step via the existing token tables (jsonfsm.
compile_token_tables / constrain.runtime). EOS unlocks exactly at
accepting states; generation cannot emit a non-matching string.

Supported syntax (anchored full-match; ^ $ are implicit and rejected):
  literals (any unicode char — non-ASCII encodes as its UTF-8 byte
  chain), `.` (any byte except \\n), classes `[a-z0-9_]` / negated
  `[^...]` (ASCII ranges), escapes \\d \\D \\w \\W \\s \\S and escaped
  metachars, alternation `|`, groups `(...)` (non-capturing `(?:...)`
  too — capture semantics are meaningless for generation), quantifiers
  `* + ?` and bounded `{m}` `{m,}` `{m,n}`.

Reference has no constrained decoding at all; this rounds out the
guided-decoding family (json / json_object / json_schema / tools /
regex) on the device-side masking runtime.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from llm_inference_lab_tpu_torch.constrain.jsonfsm import DEAD, CharAutomaton

_META = set("\\.[](){}|*+?^$")
_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    list(range(ord("a"), ord("z") + 1))
    + list(range(ord("A"), ord("Z") + 1))
    + list(range(ord("0"), ord("9") + 1)) + [ord("_")]
)
_SPACE = frozenset(b" \t\n\r\x0b\x0c")
_ALL = frozenset(range(256))
_DOT = _ALL - {ord("\n")}


class _Nfa:
    """Thompson NFA under construction: states are ints; edges are
    (byte-set, target) plus epsilon lists."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def new(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


class _Parser:
    """Recursive-descent over the pattern; returns NFA (start, end)
    fragments."""

    def __init__(self, pattern: str, nfa: _Nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    # ---- grammar: alt -> concat ('|' concat)* ; concat -> repeat* ;
    #      repeat -> atom quantifier? ; atom -> literal | class | group
    def parse(self) -> Tuple[int, int]:
        frag = self.alt()
        if self.i != len(self.p):
            raise ValueError(
                f"unexpected {self.p[self.i]!r} at {self.i} in regex"
            )
        return frag

    def alt(self) -> Tuple[int, int]:
        frags = [self.concat()]
        while self.peek() == "|":
            self.take()
            frags.append(self.concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.new(), self.nfa.new()
        for fs, fe in frags:
            self.nfa.eps[s].append(fs)
            self.nfa.eps[fe].append(e)
        return s, e

    def concat(self) -> Tuple[int, int]:
        frags = []
        while self.peek() is not None and self.peek() not in "|)":
            frags.append(self.repeat())
        if not frags:
            s = self.nfa.new()
            return s, s  # empty match
        s, e = frags[0]
        for fs, fe in frags[1:]:
            self.nfa.eps[e].append(fs)
            e = fe
        return s, e

    def repeat(self) -> Tuple[int, int]:
        frag = self.atom()
        ch = self.peek()
        if ch == "*":
            self.take()
            return self._star(frag)
        if ch == "+":
            self.take()
            # X+: loop the fragment (e -eps-> s) behind fresh endpoints.
            s, e = frag
            ns, ne = self.nfa.new(), self.nfa.new()
            self.nfa.eps[ns].append(s)
            self.nfa.eps[e].append(ne)
            self.nfa.eps[e].append(s)
            return ns, ne
        if ch == "?":
            self.take()
            s, e = frag
            ns, ne = self.nfa.new(), self.nfa.new()
            self.nfa.eps[ns] += [s, ne]
            self.nfa.eps[e].append(ne)
            return ns, ne
        if ch == "{":
            save = self.i
            self.take()
            spec = ""
            while self.peek() is not None and self.peek() != "}":
                spec += self.take()
            if self.peek() != "}":
                self.i = save  # literal '{'
                return frag
            self.take()
            return self._bounded(save, spec)
        return frag

    def _star(self, frag):
        s, e = frag
        ns, ne = self.nfa.new(), self.nfa.new()
        self.nfa.eps[ns] += [s, ne]
        self.nfa.eps[e] += [s, ne]
        return ns, ne

    def _bounded(self, atom_start: int, spec: str):
        """{m} {m,} {m,n}: re-parse the atom n times (the pattern slice
        is re-run through a fresh sub-parse per copy — NFA fragments are
        cheap and fragment cloning would be more code)."""
        parts = spec.split(",")
        del atom_start
        try:
            m = int(parts[0]) if parts[0] else 0
            n = (int(parts[1]) if parts[1] else None) \
                if len(parts) > 1 else m
        except ValueError:
            raise ValueError(f"bad quantifier {{{spec}}}")
        if n is not None and n < m:
            raise ValueError(f"bad quantifier {{{spec}}}")
        # atom() recorded the atom's source span; copies re-parse it
        # (fragments are cheap; cloning NFA subgraphs would be more code).
        a0, a1 = self._last_atom_span
        src = self.p[a0:a1]

        def copy():
            sub = _Parser(src, self.nfa)
            f = sub.alt()
            if sub.i != len(src):
                raise ValueError(f"bad quantified atom {src!r}")
            return f

        s = self.nfa.new()
        e = s
        for _ in range(m):
            fs, fe = copy()
            self.nfa.eps[e].append(fs)
            e = fe
        if n is None:  # {m,} — tail star
            fs, fe = copy()
            ns = self.nfa.new()
            self.nfa.eps[e].append(ns)
            self.nfa.eps[ns].append(fs)
            self.nfa.eps[fe].append(ns)
            return s, ns
        for _ in range(n - m):  # optional copies
            fs, fe = copy()
            ne = self.nfa.new()
            self.nfa.eps[e] += [fs, ne]
            self.nfa.eps[fe].append(ne)
            e = ne
        return s, e

    def atom(self) -> Tuple[int, int]:
        a0 = self.i
        ch = self.take()
        if ch == "(":
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2
            frag = self.alt()
            if self.peek() != ")":
                raise ValueError("unbalanced group")
            self.take()
            self._last_atom_span = (a0, self.i)
            return frag
        if ch == "[":
            cls = self._char_class()
            self._last_atom_span = (a0, self.i)
            return self._edge(cls)
        if ch == "\\":
            cls = self._escape(self.take())
            self._last_atom_span = (a0, self.i)
            return self._edge(cls)
        if ch == ".":
            self._last_atom_span = (a0, self.i)
            return self._edge(_DOT)
        if ch in "^$":
            raise ValueError(
                "anchors are implicit (full match); remove ^ / $"
            )
        if ch in "*+?|)":
            raise ValueError(f"unexpected {ch!r} at {self.i - 1}")
        # literal — non-ASCII becomes its UTF-8 byte chain
        self._last_atom_span = (a0, self.i)
        bs = ch.encode("utf-8")
        frags = [self._edge(frozenset([b])) for b in bs]
        s, e = frags[0]
        for fs, fe in frags[1:]:
            self.nfa.eps[e].append(fs)
            e = fe
        return s, e

    def _edge(self, cls: FrozenSet[int]) -> Tuple[int, int]:
        s, e = self.nfa.new(), self.nfa.new()
        self.nfa.edges[s].append((cls, e))
        return s, e

    def _escape(self, ch: str) -> FrozenSet[int]:
        table = {
            "d": _DIGITS, "D": _ALL - _DIGITS,
            "w": _WORD, "W": _ALL - _WORD,
            "s": frozenset(_SPACE), "S": _ALL - frozenset(_SPACE),
            "n": frozenset([10]), "t": frozenset([9]),
            "r": frozenset([13]),
        }
        if ch in table:
            return table[ch]
        return frozenset(ch.encode("utf-8")) if len(
            ch.encode("utf-8")
        ) == 1 else frozenset()  # escaped metachar / literal byte

    def _char_class(self) -> FrozenSet[int]:
        neg = self.peek() == "^"
        if neg:
            self.take()
        chars: Set[int] = set()
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise ValueError("unterminated character class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            ch = self.take()
            if ch == "\\":
                chars |= self._escape(self.take())
                continue
            b = ch.encode("utf-8")
            if len(b) != 1:
                raise ValueError(
                    "non-ASCII in character classes is unsupported "
                    "(use a literal or alternation)"
                )
            lo = b[0]
            if self.peek() == "-" and self.p[self.i + 1:self.i + 2] not in (
                "", "]",
            ):
                self.take()
                hi = self.take().encode("utf-8")
                if len(hi) != 1 or hi[0] < lo:
                    raise ValueError("bad character range")
                chars |= set(range(lo, hi[0] + 1))
            else:
                chars.add(lo)
        return frozenset(_ALL - chars if neg else chars)


def build_regex_automaton(pattern: str,
                          max_states: int = 8192) -> CharAutomaton:
    """Compile an anchored full-match regex into a CharAutomaton via
    Thompson NFA + subset construction. `max_states` bounds the DFA (the
    token-table compiler's int16 row space caps near 32k)."""
    nfa = _Nfa()
    start, end = _Parser(pattern, nfa).parse()

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    init = closure(frozenset([start]))
    ids: Dict[FrozenSet[int], int] = {init: 0}
    rows: List[np.ndarray] = [np.full((256,), DEAD, np.int32)]
    accepting: List[bool] = [end in init]
    work = [init]
    while work:
        cur = work.pop()
        row = rows[ids[cur]]
        # Partition 256 bytes by their move-set.
        targets: Dict[int, Set[int]] = {}
        for s in cur:
            for cls, t in nfa.edges[s]:
                for b in cls:
                    targets.setdefault(b, set()).add(t)
        # group bytes with identical target sets to close each once
        by_key: Dict[FrozenSet[int], List[int]] = {}
        for b, ts in targets.items():
            by_key.setdefault(frozenset(ts), []).append(b)
        for ts, bs in by_key.items():
            nxt = closure(ts)
            if nxt not in ids:
                if len(ids) >= max_states:
                    raise ValueError(
                        f"regex DFA exceeds {max_states} states"
                    )
                ids[nxt] = len(rows)
                rows.append(np.full((256,), DEAD, np.int32))
                accepting.append(end in nxt)
                work.append(nxt)
            for b in bs:
                row[b] = ids[nxt]
    return CharAutomaton(
        table=np.stack(rows), accepting=np.array(accepting, bool),
        initial=0, initial_objonly=0,
    )

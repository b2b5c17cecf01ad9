"""JSON char-level pushdown automaton + vectorized token-effect compiler.

Host numpy, a copy of llm_inference_lab_tpu/constrain/jsonfsm.py (the port
imports nothing of the JAX package); the tables it gives equal JAX's array
for array (tests/test_torch_constrain_tables.py).

Two layers:

1. `json_char_automaton()` — a [S, 256] transition table for a streaming
   JSON validator. States cover values, strings (value/key contexts with
   escapes and \\uXXXX), numbers, literals, and structural positions; the
   nesting stack is NOT in the state — entries carry push/pop/branch
   flags and the walker owns the stack (so depth is bounded only by the
   runtime stack buffer, not by state-count explosion).

2. `compile_token_tables(automaton, token_bytes, lens)` — for every
   (lexer state s0, vocab token t): walk t's bytes through the automaton
   with a simulated stack that starts EMPTY at the token boundary.
   Pops that dip below the boundary record the REQUIRED slot-stack
   symbols (up to MAX_POP, in order); pushes that survive are the net
   push sequence (up to MAX_PUSH). The result is five dense tables the
   decode step gathers from:

     state_out [S_ext, V] int16  final lexer state; -1 = token invalid
     n_pop     [S_ext, V] int8   pops below the boundary
     pop_syms  [S_ext, V, MAX_POP] int8   required symbols, top-first
     n_push    [S_ext, V] int8   net pushes above the boundary
     push_syms [S_ext, V, MAX_PUSH] int8  pushed symbols, bottom-first

   ',' routing consults the slot stack's top symbol, which the walker
   cannot know at a token boundary — so every state compiles THREE rows
   (base / top-OBJ / top-ARR) and the runtime picks by the actual top. A ',' after a below-boundary POP inside the same
   token (e.g. the single token "},") consults a DEEPER unknown symbol
   and stays dead — the sound over-restriction; the model emits "}" and
   "," as separate tokens there. The constraint never ADMITS invalid
   JSON.

The compiler is vectorized over the whole vocabulary with numpy (walks
all V tokens in lockstep per start state): ~S x Lmax gather steps, a
couple of seconds for a 128k vocab.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# ---------------------------------------------------------------- states
VALUE = 0            # expecting a value (ws ok)
VALUE_ARRFIRST = 1   # ditto, but ']' closes the (just-opened) array
OBJ_KEY = 2          # after '{': key string or '}'
OBJ_COMMA_KEY = 3    # after ',' in object: key string only
OBJ_COLON = 4        # after a key: ':'
AFTER_VALUE = 5      # value done: ws / ',' / '}' / ']'
STR_VAL = 6
STR_KEY = 7
ESC_VAL = 8
ESC_KEY = 9
U_VAL = 10           # 10..13: \\uXXXX hex digits (value string)
U_KEY = 14           # 14..17: ditto (key string)
NUM_MINUS = 18
NUM_ZERO = 19
NUM_INT = 20
NUM_DOT = 21
NUM_FRAC = 22
NUM_E = 23
NUM_ESIGN = 24
NUM_EXP = 25
LIT_TR = 26          # 't' seen; 26:'r' 27:'u' 28:'e'
LIT_FA = 29          # 'f' seen; 29:'a' 30:'l' 31:'s' 32:'e'
LIT_NU = 33          # 'n' seen; 33:'u' 34:'l' 35:'l'
VALUE_OBJONLY = 36   # OpenAI json_object: top level must be an object

N_STATES = 37
# Lexer states where the text so far is a complete top-level value
# (acceptance additionally requires an empty stack).
ACCEPTING = (AFTER_VALUE, NUM_ZERO, NUM_INT, NUM_FRAC, NUM_EXP)

# Stack symbols
SYM_OBJ = 1
SYM_ARR = 2

# Entry encoding: low 24 bits = next state (schema DFAs can have
# thousands of states — 8 bits would alias them); flag bits above.
STATE_MASK = (1 << 24) - 1
F_PUSH_OBJ = 1 << 24
F_PUSH_ARR = 1 << 25
F_POP_OBJ = 1 << 26
F_POP_ARR = 1 << 27
F_BRANCH_COMMA = 1 << 28  # next state depends on the stack top
DEAD = -1

MAX_POP = 4    # below-boundary pops a single token may perform
MAX_PUSH = 8   # net pushes a single token may leave behind

# ',' routing consults the SLOT stack's top symbol, which a token-boundary
# walk cannot know — and a token can reach a ',' at boundary depth from
# ANY start state (e.g. '", "' starts inside a string). So automatons
# with stack branching compile THREE rows per state: base (top
# unknown/empty — boundary commas dead, the sound top-level behavior)
# plus top-OBJ / top-ARR variants where the walker knows the symbol at
# depth sp-1 until the first below-boundary pop consumes it. The device
# picks the row by its actual stack top (runtime.effective_lex). Without
# this, no token containing a structural ',' at boundary depth could
# ever be emitted and multi-member objects/arrays would be ungenerable.

_WS = [0x20, 0x09, 0x0A, 0x0D]
_HEX = [ord(c) for c in "0123456789abcdefABCDEF"]
_DIGITS = [ord(c) for c in "0123456789"]
_D19 = [ord(c) for c in "123456789"]


@dataclass
class CharAutomaton:
    table: np.ndarray  # [N_STATES, 256] int32, DEAD where invalid
    accepting: np.ndarray  # [N_STATES] bool
    initial: int = VALUE
    initial_objonly: int = VALUE_OBJONLY


def json_char_automaton() -> CharAutomaton:
    t = np.full((N_STATES, 256), DEAD, np.int32)

    def s(state, chars, entry):
        for c in chars if isinstance(chars, (list, tuple)) else [chars]:
            t[state, c if isinstance(c, int) else ord(c)] = entry

    def value_starts(state):
        s(state, _WS, state)  # ws self-loop
        s(state, "{", OBJ_KEY | F_PUSH_OBJ)
        s(state, "[", VALUE_ARRFIRST | F_PUSH_ARR)
        s(state, '"', STR_VAL)
        s(state, "-", NUM_MINUS)
        s(state, "0", NUM_ZERO)
        s(state, _D19, NUM_INT)
        s(state, "t", LIT_TR)
        s(state, "f", LIT_FA)
        s(state, "n", LIT_NU)

    value_starts(VALUE)
    value_starts(VALUE_ARRFIRST)
    s(VALUE_ARRFIRST, "]", AFTER_VALUE | F_POP_ARR)

    s(VALUE_OBJONLY, _WS, VALUE_OBJONLY)
    s(VALUE_OBJONLY, "{", OBJ_KEY | F_PUSH_OBJ)

    s(OBJ_KEY, _WS, OBJ_KEY)
    s(OBJ_KEY, '"', STR_KEY)
    s(OBJ_KEY, "}", AFTER_VALUE | F_POP_OBJ)

    s(OBJ_COMMA_KEY, _WS, OBJ_COMMA_KEY)
    s(OBJ_COMMA_KEY, '"', STR_KEY)

    s(OBJ_COLON, _WS, OBJ_COLON)
    s(OBJ_COLON, ":", VALUE)

    def after_value(state):
        s(state, _WS, AFTER_VALUE)
        s(state, ",", F_BRANCH_COMMA)  # obj -> OBJ_COMMA_KEY, arr -> VALUE
        s(state, "}", AFTER_VALUE | F_POP_OBJ)
        s(state, "]", AFTER_VALUE | F_POP_ARR)

    after_value(AFTER_VALUE)

    # Strings: any byte >= 0x20 except '"' and '\\' continues (multi-byte
    # UTF-8 continuation bytes included — sequence validity is left to the
    # tokenizer, which only emits well-formed text).
    for st, esc, close in ((STR_VAL, ESC_VAL, AFTER_VALUE),
                           (STR_KEY, ESC_KEY, OBJ_COLON)):
        for c in range(0x20, 256):
            t[st, c] = st
        s(st, '"', close)
        s(st, "\\", esc)
    for esc, st, u0 in ((ESC_VAL, STR_VAL, U_VAL), (ESC_KEY, STR_KEY, U_KEY)):
        s(esc, ['"', "\\", "/", "b", "f", "n", "r", "t"], st)
        s(esc, "u", u0)
        for i in range(4):
            nxt = st if i == 3 else u0 + i + 1
            for c in _HEX:
                t[u0 + i, c] = nxt

    # Numbers. Complete-number states also act as AFTER_VALUE for
    # delimiters (no separate "end number" char exists in JSON).
    s(NUM_MINUS, "0", NUM_ZERO)
    s(NUM_MINUS, _D19, NUM_INT)
    for st in (NUM_ZERO, NUM_INT, NUM_FRAC, NUM_EXP):
        after_value(st)
    s(NUM_ZERO, ".", NUM_DOT)
    s(NUM_ZERO, ["e", "E"], NUM_E)
    s(NUM_INT, _DIGITS, NUM_INT)
    s(NUM_INT, ".", NUM_DOT)
    s(NUM_INT, ["e", "E"], NUM_E)
    s(NUM_DOT, _DIGITS, NUM_FRAC)
    s(NUM_FRAC, _DIGITS, NUM_FRAC)
    s(NUM_FRAC, ["e", "E"], NUM_E)
    s(NUM_E, ["+", "-"], NUM_ESIGN)
    s(NUM_E, _DIGITS, NUM_EXP)
    s(NUM_ESIGN, _DIGITS, NUM_EXP)
    s(NUM_EXP, _DIGITS, NUM_EXP)

    # Literals
    for chain, chars in ((LIT_TR, "rue"), (LIT_FA, "alse"), (LIT_NU, "ull")):
        for i, c in enumerate(chars):
            nxt = AFTER_VALUE if i == len(chars) - 1 else chain + i + 1
            t[chain + i, ord(c)] = nxt

    acc = np.zeros((N_STATES,), bool)
    acc[list(ACCEPTING)] = True
    return CharAutomaton(table=t, accepting=acc)


@dataclass
class TokenTables:
    """Dense per-(state, token) effect tables (see module docstring)."""

    state_out: np.ndarray  # [S_ext, V] int16, -1 = invalid
    n_pop: np.ndarray      # [S_ext, V] int8
    pop_syms: np.ndarray   # [S_ext, V, MAX_POP] int8
    n_push: np.ndarray     # [S_ext, V] int8
    push_syms: np.ndarray  # [S_ext, V, MAX_PUSH] int8
    accepting: np.ndarray  # [S_ext] bool
    eos_id: int
    initial: int
    initial_objonly: int
    # Base-state -> top-conditioned row maps (identity for non-split
    # states): the runtime gathers from variant_obj[lex]/variant_arr[lex]
    # when the slot stack's top is OBJ/ARR (runtime.effective_lex).
    variant_obj: np.ndarray = None  # [S_base] int16
    variant_arr: np.ndarray = None  # [S_base] int16


def compile_token_tables(
    auto: CharAutomaton,
    token_bytes: np.ndarray,  # [V, L] uint8, zero-padded
    token_lens: np.ndarray,   # [V] int32; 0-length tokens are invalid
    eos_id: int,
) -> TokenTables:
    V, L = token_bytes.shape
    S = auto.table.shape[0]  # generic: schema DFAs have their own count
    # Simulated stack can't grow past one push per char; floor at MAX_PUSH
    # so the push_syms slice below is always well-shaped (1-byte vocabs).
    SIM = max(L + 1, MAX_PUSH)

    # Extended row space: base rows + top-symbol variants of the split
    # states (those whose ',' routing consults the slot stack; only
    # meaningful for automatons that actually branch — pure DFAs like the
    # schema compiler's have no F_BRANCH_COMMA entries but variants are
    # harmless and the arrays stay identity).
    has_branch = bool(
        ((auto.table >= 0) & ((auto.table & F_BRANCH_COMMA) != 0)).any()
    )
    S_ext = 3 * S if has_branch else S
    if S_ext >= 2**15:
        raise ValueError(f"automaton too large ({S_ext} rows) for int16")
    jobs = [(s0, s0, None) for s0 in range(S)]
    if has_branch:
        variant_obj = np.arange(S, 2 * S, dtype=np.int16)
        variant_arr = np.arange(2 * S, 3 * S, dtype=np.int16)
        for s0 in range(S):
            jobs.append((S + s0, s0, SYM_OBJ))
            jobs.append((2 * S + s0, s0, SYM_ARR))
    else:  # pure DFA (schema grammars): no branching, identity maps
        variant_obj = np.arange(S, dtype=np.int16)
        variant_arr = np.arange(S, dtype=np.int16)

    state_out = np.full((S_ext, V), -1, np.int16)
    n_pop_t = np.zeros((S_ext, V), np.int8)
    pop_syms_t = np.zeros((S_ext, V, MAX_POP), np.int8)
    n_push_t = np.zeros((S_ext, V), np.int8)
    push_syms_t = np.zeros((S_ext, V, MAX_PUSH), np.int8)

    tbl = auto.table
    for row, s0, known_top in jobs:
        state = np.full((V,), s0, np.int32)
        dead = token_lens <= 0
        sp = np.zeros((V,), np.int32)  # sim-stack height above boundary
        sim = np.zeros((V, SIM), np.int8)
        npop = np.zeros((V,), np.int32)
        pops = np.zeros((V, MAX_POP), np.int8)
        # The slot's top symbol stays known until the first below-boundary
        # pop consumes it (per-token walk state).
        top_known = np.full((V,), known_top is not None)
        rows = np.arange(V)

        for i in range(L):
            act = (i < token_lens) & ~dead
            if not act.any():
                break
            e = tbl[state, token_bytes[:, i]]
            dead |= act & (e < 0)
            act &= ~dead
            nxt = e & STATE_MASK
            flags = e

            # Pushes
            for flag, sym in ((F_PUSH_OBJ, SYM_OBJ), (F_PUSH_ARR, SYM_ARR)):
                m = act & ((flags & flag) != 0)
                if m.any():
                    sim[rows[m], sp[m]] = sym
                    sp[m] += 1

            # Pops: internal (sim top) must match; below-boundary pops
            # record the required slot symbol.
            for flag, sym in ((F_POP_OBJ, SYM_OBJ), (F_POP_ARR, SYM_ARR)):
                m = act & ((flags & flag) != 0)
                if not m.any():
                    continue
                internal = m & (sp > 0)
                below = m & (sp == 0)  # BEFORE the internal decrement
                if internal.any():
                    top = sim[rows[internal], sp[internal] - 1]
                    bad = internal.copy()
                    bad[internal] = top != sym
                    dead |= bad
                    ok = internal & ~bad
                    sp[ok] -= 1
                below &= ~dead
                if below.any():
                    over = below & (npop >= MAX_POP)
                    dead |= over
                    rec = below & ~over
                    if rec.any():
                        pops[rows[rec], npop[rec]] = sym
                        npop[rec] += 1
                        top_known[rec] = False  # consumed the known top

            # ',' routing: internal top decides; at the boundary the
            # variant row's known top decides; truly unknown (base row,
            # or after a below-pop) is the documented soundness kill.
            m = act & ((flags & F_BRANCH_COMMA) != 0) & ~dead
            if m.any():
                below = m & (sp == 0)
                routed = below & top_known
                dead |= below & ~top_known
                if routed.any():
                    nxt[routed] = (
                        OBJ_COMMA_KEY if known_top == SYM_OBJ else VALUE
                    )
                inside = m & ~below
                if inside.any():
                    top = sim[rows[inside], sp[inside] - 1]
                    nxt[inside] = np.where(
                        top == SYM_OBJ, OBJ_COMMA_KEY, VALUE
                    )

            act &= ~dead
            state[act] = nxt[act]

        dead |= sp > MAX_PUSH
        live = ~dead
        state_out[row, live] = state[live].astype(np.int16)
        n_pop_t[row, live] = npop[live].astype(np.int8)
        pop_syms_t[row, live] = pops[live]
        n_push_t[row, live] = sp[live].astype(np.int8)
        push_syms_t[row, live] = sim[live, :MAX_PUSH]

    # EOS is handled by the runtime (valid iff accepting state + empty
    # stack); keep it invalid in the tables so a mid-value EOS can't leak.
    state_out[:, eos_id] = -1

    # Variant rows inherit the base state's accepting flag (they ARE the
    # base state, just compiled with a known stack top) — though with a
    # non-empty stack acceptance can't fire anyway.
    accepting = np.zeros((S_ext,), bool)
    accepting[:S] = auto.accepting
    if has_branch:
        accepting[S : 2 * S] = auto.accepting
        accepting[2 * S :] = auto.accepting

    return TokenTables(
        state_out=state_out, n_pop=n_pop_t, pop_syms=pop_syms_t,
        n_push=n_push_t, push_syms=push_syms_t,
        accepting=accepting, eos_id=eos_id,
        initial=auto.initial, initial_objonly=auto.initial_objonly,
        variant_obj=variant_obj, variant_arr=variant_arr,
    )


# ------------------------------------------------------- tokenizer bytes
def _gpt2_byte_decoder() -> dict:
    """Inverse of GPT-2's bytes_to_unicode bijection (every byte maps to a
    printable unicode char in byte-level-BPE vocab entries)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def token_bytes_of(tokenizer, vocab_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact byte string of every vocab id, as [V, L] uint8 + [V] lengths.

    Why not decode([id]): sentencepiece decoders strip the leading '▁'
    space of a lone token and special tokens render as literal text —
    both would corrupt the constraint tables on real models. Instead the
    raw vocab entries are mapped through the tokenizer's own byte
    convention: GPT-2 byte-level BPE ('Ġ' family, exact byte bijection),
    sentencepiece ('▁' = space, '<0xNN>' = raw byte), with decode([id])
    only as the last-resort fallback. Special tokens (BOS/EOS/chat
    markup) get length 0 = never valid inside constrained output."""
    out: List[bytes] = []
    if type(tokenizer).__name__ == "ByteTokenizer":
        for i in range(vocab_size):
            out.append(b"" if i == 0 else bytes([(i - 1) % 256]))
    else:
        inner = getattr(tokenizer, "_tok", tokenizer)
        special = set(getattr(inner, "all_special_ids", None) or ())
        toks = None
        if hasattr(inner, "convert_ids_to_tokens"):
            try:
                toks = inner.convert_ids_to_tokens(list(range(vocab_size)))
            except Exception:
                toks = None
        if toks is not None:
            sample = [t for t in toks if t][:2000]
            gpt2_style = any("Ġ" in t or "Ċ" in t for t in sample)
            sp_style = any("▁" in t for t in sample)
            byte_dec = _gpt2_byte_decoder() if gpt2_style else None
            for i, t in enumerate(toks):
                if t is None or i in special:
                    out.append(b"")
                elif byte_dec is not None:
                    try:
                        out.append(bytes(byte_dec[c] for c in t))
                    except KeyError:  # non-byte-level entry (added token)
                        out.append(b"")
                elif sp_style:
                    if t.startswith("<0x") and t.endswith(">"):
                        out.append(bytes([int(t[3:-1], 16)]))
                    else:
                        out.append(t.replace("▁", " ").encode("utf-8"))
                else:
                    out.append(t.encode("utf-8", errors="ignore"))
        else:
            dec = tokenizer.decode
            for i in range(vocab_size):
                try:
                    txt = dec([i]) if i not in special else ""
                except Exception:
                    txt = ""
                out.append(txt.encode("utf-8", errors="ignore"))
    L = max(1, max(len(b) for b in out))
    arr = np.zeros((vocab_size, L), np.uint8)
    lens = np.zeros((vocab_size,), np.int32)
    for i, b in enumerate(out):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return arr, lens

"""Constrained decoding: regex -> DFA -> dense per-token transition tables.

SGLang's serving backend offers regex-constrained generation; this is the
counterpart for the continuous batcher (the port's own copy of
``matryoshka_mm_tpu/serve/constrained.py``; numpy only).  A
character-level DFA is *pre-composed* with the tokenizer into two dense
arrays

    allow (n_states, vocab)  bool   — may token t be emitted from state s?
    trans (n_states, vocab)  int32  — resulting state (dead -> 0 row)

so the whole automaton rides the decode chunk as one gather per step:
``mask = allow[state]`` biases the logits, ``state = trans[state, tok]``
advances, both on the device with no per-step host round trip.

The regex dialect is the practical core: literals, ``.``, classes
``[a-z0-9_]`` (with ranges and ``^`` negation), escapes (``\\d \\w \\s``
and literal escapes), grouping ``()``, alternation ``|``, and the
quantifiers ``* + ? {m} {m,} {m,n}``.  Compilation is the textbook
Thompson NFA -> subset-construction DFA; tables are built by simulating
every (state, token-string) pair once (the batcher memoizes compiled
tables per pattern in a bounded LRU).

EOS policy: the eos token is allowed exactly in accepting states, so a
constrained generation can only terminate on a string matching the
pattern (``full-match`` semantics).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

_EPS = -1          # epsilon edge marker

# ---------------------------------------------------------------------------
# regex parsing -> NFA (Thompson construction)
# ---------------------------------------------------------------------------

_CLASS_SHORTHAND = {
    "d": "0123456789",
    "w": ("abcdefghijklmnopqrstuvwxyz"
          "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": " \t\n\r\f\v",
}
# printable ASCII universe for '.', negated classes, \D \W \S
_UNIVERSE = frozenset(chr(c) for c in range(32, 127)) | frozenset("\t\n\r")


class _Nfa:
    """Fragment list-of-states NFA: states are ints, edges are
    (state, charset-or-_EPS, next)."""

    def __init__(self):
        self.edges: List[Tuple[int, object, int]] = []
        self.n = 0

    def new_state(self) -> int:
        self.n += 1
        return self.n - 1

    def add(self, a: int, label, b: int):
        self.edges.append((a, label, b))


class _Parser:
    """Recursive-descent regex parser producing (start, end) NFA fragments."""

    def __init__(self, pattern: str, nfa: _Nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    # alternation := concat ('|' concat)*
    def parse_alt(self) -> Tuple[int, int]:
        frags = [self.parse_concat()]
        while self.peek() == "|":
            self.take()
            frags.append(self.parse_concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for fs, fe in frags:
            self.nfa.add(s, _EPS, fs)
            self.nfa.add(fe, _EPS, e)
        return s, e

    def parse_concat(self) -> Tuple[int, int]:
        frags = []
        while self.peek() not in (None, "|", ")"):
            frags.append(self.parse_repeat())
        if not frags:
            s = self.nfa.new_state()
            return s, s
        s, e = frags[0]
        for fs, fe in frags[1:]:
            self.nfa.add(e, _EPS, fs)
            e = fe
        return s, e

    def parse_repeat(self) -> Tuple[int, int]:
        frag = self.parse_atom()
        quantified = False
        while True:
            c = self.peek()
            if quantified and c in ("*", "+", "{"):
                # a second quantifier would clone only the ATOM's source
                # (self._last_atom_src), silently compiling e.g. a*{2} as
                # a*a and a{2}{3} as a{4} — reject like Python re does
                raise ValueError(
                    "multiple repeat: quantifier follows quantifier; "
                    "group the inner one, e.g. (a*){2}")
            if quantified and c == "?":
                # non-greedy marker: greediness is meaningless under
                # full-match DFA semantics, accept and ignore
                self.take()
                continue
            if c == "*":
                self.take()
                frag = self._star(frag)
                quantified = True
                continue
            elif c == "+":
                self.take()
                # '+' without cloning: loop-back edge e -eps-> s forces at
                # least one pass, the fresh exit keeps the frag reentrant
                fs, fe = frag
                s, e = self.nfa.new_state(), self.nfa.new_state()
                self.nfa.add(s, _EPS, fs)
                self.nfa.add(fe, _EPS, e)
                self.nfa.add(fe, _EPS, fs)
                frag = (s, e)
                quantified = True
            elif c == "?":
                self.take()
                s, e = self.nfa.new_state(), self.nfa.new_state()
                fs, fe = frag
                self.nfa.add(s, _EPS, fs)
                self.nfa.add(fe, _EPS, e)
                self.nfa.add(s, _EPS, e)
                frag = (s, e)
                quantified = True
            elif c == "{":
                frag = self._bounded(frag)
                quantified = True
            else:
                return frag

    def _star(self, frag) -> Tuple[int, int]:
        fs, fe = frag
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add(s, _EPS, fs)
        self.nfa.add(fe, _EPS, e)
        self.nfa.add(s, _EPS, e)
        self.nfa.add(fe, _EPS, fs)
        return s, e

    def _bounded(self, frag) -> Tuple[int, int]:
        """{m} {m,} {m,n}: re-parse the atom's source text to clone it."""
        atom_src = self._last_atom_src
        self.take()                               # '{'
        spec = ""
        while self.peek() not in (None, "}"):
            spec += self.take()
        if self.peek() != "}":
            raise ValueError("unterminated {..} quantifier")
        self.take()
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            lo = int(lo_s or 0)
            hi = int(hi_s) if hi_s else None
        else:
            lo = hi = int(spec)

        def clone() -> Tuple[int, int]:
            sub = _Parser(atom_src, self.nfa)
            f = sub.parse_alt()
            if sub.i != len(atom_src):
                raise ValueError(f"bad atom {atom_src!r}")
            return f

        frags = [frag] + [clone() for _ in range(max(lo - 1, 0))]
        if lo == 0:
            frags = []
        if hi is None:                            # {m,} = m copies + star
            frags.append(self._star(clone()))
        else:
            for _ in range(hi - lo):              # optional copies
                fs, fe = clone()
                s, e = self.nfa.new_state(), self.nfa.new_state()
                self.nfa.add(s, _EPS, fs)
                self.nfa.add(fe, _EPS, e)
                self.nfa.add(s, _EPS, e)
                frags.append((s, e))
        if not frags:
            s = self.nfa.new_state()
            return s, s
        s, e = frags[0]
        for fs, fe in frags[1:]:
            self.nfa.add(e, _EPS, fs)
            e = fe
        return s, e

    def parse_atom(self) -> Tuple[int, int]:
        start_i = self.i
        c = self.take()
        if c == "(":
            frag = self.parse_alt()
            if self.peek() != ")":
                raise ValueError("unbalanced parenthesis")
            self.take()
        elif c == "[":
            charset = self._parse_class()
            frag = self._edge(charset)
        elif c == ".":
            frag = self._edge(frozenset(_UNIVERSE))
        elif c == "\\":
            frag = self._edge(self._escape(self.take()))
        elif c in ")|*+?{":
            raise ValueError(f"unexpected {c!r} at {self.i - 1}")
        else:
            frag = self._edge(frozenset(c))
        self._last_atom_src = self.p[start_i:self.i]
        return frag

    def _edge(self, charset) -> Tuple[int, int]:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add(s, charset, e)
        return s, e

    def _escape(self, c: str) -> FrozenSet[str]:
        if c in _CLASS_SHORTHAND:
            return frozenset(_CLASS_SHORTHAND[c])
        if c.upper() == c and c.lower() in _CLASS_SHORTHAND:
            return frozenset(_UNIVERSE - set(_CLASS_SHORTHAND[c.lower()]))
        if c == "n":
            return frozenset("\n")
        if c == "t":
            return frozenset("\t")
        if c == "r":
            return frozenset("\r")
        if c == "f":
            return frozenset("\f")
        if c == "v":
            return frozenset("\v")
        return frozenset(c)                       # literal escape

    def _parse_class(self) -> FrozenSet[str]:
        neg = False
        if self.peek() == "^":
            self.take()
            neg = True
        chars: set = set()
        prev: Optional[str] = None
        while self.peek() not in (None, "]"):
            c = self.take()
            if c == "\\":
                esc = self._escape(self.take())
                chars |= set(esc)
                prev = None
                continue
            if c == "-" and prev is not None and self.peek() not in (None, "]"):
                hi = self.take()
                chars |= {chr(x) for x in range(ord(prev), ord(hi) + 1)}
                prev = None
                continue
            chars.add(c)
            prev = c
        if self.peek() != "]":
            raise ValueError("unterminated character class")
        self.take()
        return frozenset(_UNIVERSE - chars) if neg else frozenset(chars)


# ---------------------------------------------------------------------------
# NFA -> DFA (subset construction)
# ---------------------------------------------------------------------------

class CharDFA:
    """Dense character DFA: ``step[state][char] -> state`` dicts plus an
    accepting-state set.  State 0 is the dead state (self-loops)."""

    def __init__(self, step: List[Dict[str, int]], accept: FrozenSet[int],
                 start: int):
        self.step = step
        self.accept = accept
        self.start = start

    @property
    def n_states(self) -> int:
        return len(self.step)

    def advance(self, state: int, text: str) -> int:
        for ch in text:
            if state == 0:
                return 0
            state = self.step[state].get(ch, 0)
        return state

    def fullmatch(self, text: str) -> bool:
        return self.advance(self.start, text) in self.accept


def compile_regex(pattern: str) -> CharDFA:
    nfa = _Nfa()
    parser = _Parser(pattern, nfa)
    start, end = parser.parse_alt()
    if parser.i != len(pattern):
        raise ValueError(f"trailing junk in pattern at {parser.i}")

    # epsilon closures
    eps: List[List[int]] = [[] for _ in range(nfa.n)]
    by_src: List[List[Tuple[object, int]]] = [[] for _ in range(nfa.n)]
    for a, label, b in nfa.edges:
        if label is _EPS:
            eps[a].append(b)
        else:
            by_src[a].append((label, b))

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset([start]))
    ids: Dict[FrozenSet[int], int] = {frozenset(): 0, start_set: 1}
    step: List[Dict[str, int]] = [{}, {}]
    work = [start_set]
    while work:
        cur = work.pop()
        moves: Dict[str, set] = {}
        for s in cur:
            for label, t in by_src[s]:
                for ch in label:
                    moves.setdefault(ch, set()).add(t)
        row = step[ids[cur]]
        for ch, targets in moves.items():
            nxt = closure(frozenset(targets))
            if nxt not in ids:
                ids[nxt] = len(step)
                step.append({})
                work.append(nxt)
            row[ch] = ids[nxt]
    accept = frozenset(i for st, i in ids.items() if end in st)
    return CharDFA(step, accept, start=1)


# ---------------------------------------------------------------------------
# DFA x tokenizer -> dense decode tables
# ---------------------------------------------------------------------------

def build_token_tables(dfa: CharDFA, vocab: Sequence[str], eos_id: int,
                       special_ids: Sequence[int] = ()):
    """Pre-compose the DFA with the token vocabulary.

    Returns ``(allow, trans)`` numpy arrays of shape (n_states, V):
    ``allow[s, t]`` is True when emitting token t from state s keeps the
    automaton alive; ``trans[s, t]`` is the resulting state.  The eos
    token is allowed exactly in accepting states (full-match semantics);
    other special ids are never allowed.  State 0 is dead and allows only
    eos (dead rows are never reached by a live generation — the mask at
    the previous step forbids entering them — but a sampled pad on a
    retired row must not NaN the softmax)."""
    n, V = dfa.n_states, len(vocab)
    allow = np.zeros((n, V), bool)
    trans = np.zeros((n, V), np.int32)
    special = set(int(i) for i in special_ids) | {int(eos_id)}
    for s in range(1, n):
        for t in range(V):
            if t in special or not vocab[t]:
                # empty pieces (unmapped/special vocab slots) advance the
                # DFA zero characters — allowing them would create a
                # self-loop the mask can never escape (greedy decode
                # could emit that id forever without matching progress)
                continue
            nxt = dfa.advance(s, vocab[t])
            if nxt != 0:
                allow[s, t] = True
                trans[s, t] = nxt

    # Token-level productivity pruning: a char-DFA state can be live yet
    # a dead end for THIS vocabulary (e.g. after emitting " " toward
    # " really" when no token ever spells "really") — generation would
    # strand there with every token masked.  Keep a transition only when
    # its target can still reach an accepting state via whole tokens.
    productive = np.zeros(n, bool)
    for s in dfa.accept:
        productive[s] = True
    changed = True
    while changed:
        reaches = (allow & productive[trans]).any(axis=1)
        new = productive | reaches
        changed = bool((new != productive).any())
        productive = new
    allow &= productive[trans]
    for s in range(1, n):
        if s in dfa.accept:
            allow[s, eos_id] = True
    allow[0, eos_id] = True
    if not (productive[dfa.start] or dfa.start in dfa.accept):
        raise ValueError(
            "constraint is unsatisfiable with this vocabulary: no token "
            "sequence from the start state reaches an accepting state")
    return allow, trans


def _piece_to_text(t) -> str:
    """Tokenizer piece -> the text emitting it appends: sentencepiece
    '▁' and BPE 'Ġ/Ċ/ĉ' markers become space/newline/tab, byte-fallback
    pieces '<0xNN>' become their character."""
    if not isinstance(t, str):
        return ""
    if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
        try:
            return chr(int(t[3:5], 16))
        except ValueError:
            return t
    return (t.replace("▁", " ").replace("Ġ", " ")
            .replace("Ċ", "\n").replace("ĉ", "\t"))


def vocab_from_tokenizer(tokenizer) -> List[str]:
    """Decoded piece per id — what emitting that id appends to the text.

    Special tokens (<s>, <unk>, ...) map to "" (= never allowed by
    build_token_tables): their literal piece text would otherwise be
    consumed by the DFA as ordinary characters while
    skip_special_tokens drops them from the client text, so the
    delivered output would no longer full-match the constraint."""
    size = int(getattr(tokenizer, "vocab_size", None)
               or len(tokenizer.get_vocab()))
    toks = tokenizer.convert_ids_to_tokens(list(range(size)))
    special = set(int(i) for i in
                  getattr(tokenizer, "all_special_ids", []) or [])
    return ["" if i in special else _piece_to_text(t)
            for i, t in enumerate(toks)]


# ---------------------------------------------------------------------------
# JSON mode: schema -> regex
# ---------------------------------------------------------------------------

# JSON forbids raw control characters inside strings.  Unbounded `*` is
# just as regular as a counted bound but compiles to a ~4-state DFA where
# {0,256} built a 260-state counting chain — which blew past the
# batcher's per-request FSM quota (max_fsm_states=64) for EVERY schema
# containing a string field; output length is bounded by max_new_tokens.
_JSON_STRING = r'"[^"\\\t\n\r]*"'
# JSON forbids leading zeros: -?(0|[1-9][0-9]*), bounded for regularity
_JSON_INT = r"-?(0|[1-9]\d{0,14})"
_JSON_NUMBER = _JSON_INT + r"(\.\d{1,10})?"
_JSON_BOOL = r"(true|false)"
_WS = r" ?"


def regex_for_json_schema(schema: dict, max_items: int = 8) -> str:
    """A (bounded) regex accepting JSON documents matching ``schema``.

    Supports the practical subset: ``type`` object/array/string/number/
    integer/boolean, ``properties`` (all required, in declaration order —
    fixed key order is what makes the language regular), ``enum`` of
    scalars, and ``items`` for arrays (1..max_items elements).  JSON is
    not a regular language; the point is the common LLM-extraction shape:
    a flat-ish object with known keys.  Nested objects/arrays work to any
    fixed depth since each level inlines its sub-regex."""
    t = schema.get("type")
    if "enum" in schema:
        import json as _json

        opts = "|".join(re_escape(_json.dumps(v)) for v in schema["enum"])
        return f"({opts})"
    if t == "string":
        return _JSON_STRING
    if t == "number":
        return _JSON_NUMBER
    if t == "integer":
        return _JSON_INT
    if t == "boolean":
        return _JSON_BOOL
    if t == "array":
        item = regex_for_json_schema(schema.get("items", {"type": "string"}),
                                     max_items)
        reps = max(max_items - 1, 0)
        return (rf"\[{_WS}{item}({_WS},{_WS}{item}){{0,{reps}}}{_WS}\]"
                if max_items > 0 else r"\[ ?\]")
    if t == "object" or "properties" in schema:
        props = schema.get("properties", {})
        parts = []
        for key, sub in props.items():
            val = regex_for_json_schema(sub, max_items)
            parts.append(f'"{re_escape(key)}"{_WS}:{_WS}{val}')
        body = f"{_WS},{_WS}".join(parts)
        return r"\{" + _WS + body + _WS + r"\}"
    raise ValueError(f"unsupported schema node: {schema!r}")


_REGEX_META = set("\\^$.|?*+()[]{}\"")


def re_escape(s: str) -> str:
    """Escape regex metacharacters for the local dialect."""
    return "".join("\\" + c if c in _REGEX_META and c != '"' else c
                   for c in s)

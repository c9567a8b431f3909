"""Grammar -> token-level DFA compiler for constrained decoding (copy of
``cake_tpu/constrain/fsm.py``; the cache key and file format are the
same, so either package loads a DFA the other cached).

The Outlines lesson (Willard & Louf 2023): a regular grammar
over *characters* lowers to a finite automaton over the *tokenizer
vocabulary* — for every automaton state, walk each vocab token's decoded
string through the character automaton; tokens whose walk survives are
the state's allowed set, and the walk's end state is the transition.
Constrained decoding is then one table lookup per emitted token on the
host plus one mask application on device — no per-token grammar work in
the hot path.

Pipeline here, stdlib + numpy only (no `interegular`/`outlines` in the
container):

1. a small regex engine — parse (literals, classes, escapes, ``.``,
   ``| ( ) * + ? {m,n}``; fullmatch semantics) -> Thompson NFA;
2. JSON Schema lowered to such a regex (``json_schema_to_regex``), with
   *bounded* repetitions everywhere so the lowered automaton is acyclic
   — a constrained stream provably terminates inside its token budget;
3. lazy subset construction driven by the vocab's actual strings
   (`build_token_dfa`): DFA states are discovered NFA-subset closures,
   yielding a ``trans [S, V] int32`` table (-1 = disallowed) and the
   per-state allowed-token masks packed little-endian as a
   ``mask_bits [S, ceil(V/8)] uint8`` array — the exact layout the
   engine uploads to device once and gathers from inside the compiled
   decode step (runtime/batch_generator.py).

EOS token ids never participate as *text* (a toy tokenizer may map the
EOS id onto a printable char — it must not satisfy a ``"`` transition);
they are OR'd into the mask of *accepting* states only, so a stream can
end exactly when its grammar is complete — and MUST end when the
accepting state has no outgoing transitions (the mask forces EOS).

Compiles are cached two ways: an in-process memo and a disk cache keyed
by content hash of (pattern, vocab, eos ids) under ``CAKE_FSM_CACHE_DIR``
(default ``~/.cache/cake_tpu/fsm``), because the vocab walk is
O(states x vocab x token length) and real vocabs are 32k+. Cache traffic
lands in ``constrain.fsm_cache_hits/misses``; compile wall in
``constrain.fsm_compile_ms``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np

from cake_tpu_torch.obs import metrics as obs_metrics

FSM_COMPILE_MS = obs_metrics.histogram("constrain.fsm_compile_ms")
FSM_CACHE_HITS = obs_metrics.counter("constrain.fsm_cache_hits")
FSM_CACHE_MISSES = obs_metrics.counter("constrain.fsm_cache_misses")

_MAX_CP = 0x10FFFF
_MAX_STATES = 4096  # subset-construction guard: beyond this, refuse
_CACHE_VERSION = "cakefsm1"

# -- regex parsing -----------------------------------------------------------
# AST: ("chars", ranges) | ("cat", [n..]) | ("alt", [n..])
#      | ("rep", node, min, max_or_None)
# ranges: sorted tuple of inclusive (lo, hi) codepoint pairs.

_ESCAPE_CLASSES = {
    "d": ((ord("0"), ord("9")),),
    "w": ((ord("0"), ord("9")), (ord("A"), ord("Z")), (ord("_"), ord("_")),
          (ord("a"), ord("z"))),
    "s": ((9, 10), (12, 13), (32, 32)),
}
_ESCAPE_CHARS = {"n": "\n", "r": "\r", "t": "\t", "f": "\f", "v": "\v",
                 "0": "\0"}


def _norm_ranges(ranges):
    """Sort + merge overlapping/adjacent inclusive ranges."""
    out: list[list[int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return tuple((lo, hi) for lo, hi in out)


def _negate_ranges(ranges):
    out, prev = [], 0
    for lo, hi in _norm_ranges(ranges):
        if lo > prev:
            out.append((prev, lo - 1))
        prev = hi + 1
    if prev <= _MAX_CP:
        out.append((prev, _MAX_CP))
    return tuple(out)


def _in_ranges(ranges, cp: int) -> bool:
    for lo, hi in ranges:
        if lo <= cp <= hi:
            return True
        if cp < lo:
            return False
    return False


class RegexError(ValueError):
    pass


class _Parser:
    """Recursive-descent parser for the supported regex subset."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self):
        ch = self._peek()
        if ch is None:
            raise RegexError(f"unexpected end of pattern: {self.p!r}")
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise RegexError(
                f"unbalanced pattern at char {self.i} of {self.p!r}")
        return node

    def _alt(self):
        arms = [self._concat()]
        while self._peek() == "|":
            self._next()
            arms.append(self._concat())
        return arms[0] if len(arms) == 1 else ("alt", arms)

    def _concat(self):
        items = []
        while self._peek() not in (None, "|", ")"):
            items.append(self._repeat())
        if not items:
            return ("cat", [])
        return items[0] if len(items) == 1 else ("cat", items)

    def _repeat(self):
        node = self._atom()
        ch = self._peek()
        if ch == "*":
            self._next()
            return ("rep", node, 0, None)
        if ch == "+":
            self._next()
            return ("rep", node, 1, None)
        if ch == "?":
            self._next()
            return ("rep", node, 0, 1)
        if ch == "{":
            save = self.i
            self._next()
            body = ""
            while self._peek() not in (None, "}"):
                body += self._next()
            if self._peek() != "}" or not _rep_body_ok(body):
                self.i = save  # literal '{' (e.g. inside JSON skeletons)
                return node
            self._next()
            lo, _, hi = body.partition(",")
            m = int(lo)
            n = m if not _has_comma(body) else (int(hi) if hi else None)
            if n is not None and n < m:
                raise RegexError(f"bad repetition {{{body}}} in {self.p!r}")
            return ("rep", node, m, n)
        return node

    def _atom(self):
        ch = self._next()
        if ch == "(":
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2  # non-capturing marker; groups never capture
            node = self._alt()
            if self._next() != ")":
                raise RegexError(f"unclosed group in {self.p!r}")
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            # any char except newline (re.fullmatch semantics)
            return ("chars", _negate_ranges(((10, 10),)))
        if ch == "\\":
            return self._escape()
        if ch in ")|*+?":
            raise RegexError(f"dangling {ch!r} in {self.p!r}")
        cp = ord(ch)
        return ("chars", ((cp, cp),))

    def _escape(self):
        ch = self._next()
        if ch in _ESCAPE_CLASSES:
            return ("chars", _norm_ranges(_ESCAPE_CLASSES[ch]))
        if ch.upper() in _ESCAPE_CLASSES and ch.isupper():
            return ("chars",
                    _negate_ranges(_ESCAPE_CLASSES[ch.lower()]))
        if ch in _ESCAPE_CHARS:
            cp = ord(_ESCAPE_CHARS[ch])
            return ("chars", ((cp, cp),))
        cp = ord(ch)  # \. \" \\ \[ \{ ... : the char itself
        return ("chars", ((cp, cp),))

    def _class_atom(self) -> tuple[tuple[tuple[int, int], ...], bool]:
        """One class member -> (ranges, is_single_char)."""
        ch = self._next()
        if ch == "\\":
            nxt = self._next()
            if nxt in _ESCAPE_CLASSES:
                return _norm_ranges(_ESCAPE_CLASSES[nxt]), False
            if nxt.upper() in _ESCAPE_CLASSES and nxt.isupper():
                return _negate_ranges(_ESCAPE_CLASSES[nxt.lower()]), False
            c = _ESCAPE_CHARS.get(nxt, nxt)
            return ((ord(c), ord(c)),), True
        return ((ord(ch), ord(ch)),), True

    def _char_class(self):
        negated = False
        if self._peek() == "^":
            self._next()
            negated = True
        ranges: list[tuple[int, int]] = []
        if self._peek() == "]":  # leading ] is literal
            self._next()
            ranges.append((ord("]"), ord("]")))
        while True:
            ch = self._peek()
            if ch is None:
                raise RegexError(f"unclosed class in {self.p!r}")
            if ch == "]":
                self._next()
                break
            r, single = self._class_atom()
            if (single and self._peek() == "-"
                    and self.p[self.i + 1:self.i + 2] not in ("]", "")):
                self._next()
                r2, single2 = self._class_atom()
                if not single2 or r2[0][0] < r[0][0]:
                    raise RegexError(f"bad range in class: {self.p!r}")
                ranges.append((r[0][0], r2[0][0]))
            else:
                ranges.extend(r)
        out = _norm_ranges(ranges)
        return ("chars", _negate_ranges(out) if negated else out)


def _rep_body_ok(body: str) -> bool:
    lo, comma, hi = body.partition(",")
    if not lo.isdigit():
        return False
    return (not comma) or hi == "" or hi.isdigit()


def _has_comma(body: str) -> bool:
    return "," in body


# -- Thompson NFA ------------------------------------------------------------

class _NFA:
    """eps[s] -> [targets]; chars[s] -> [(ranges, target)]."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.chars: list[list[tuple[tuple, int]]] = []
        self.start = 0
        self.accept = 0

    def new_state(self) -> int:
        self.eps.append([])
        self.chars.append([])
        return len(self.eps) - 1


def _build_frag(nfa: _NFA, node) -> tuple[int, int]:
    """Thompson-construct one AST node; returns (start, accept)."""
    kind = node[0]
    if kind == "chars":
        s, a = nfa.new_state(), nfa.new_state()
        nfa.chars[s].append((node[1], a))
        return s, a
    if kind == "cat":
        s = a = nfa.new_state()
        for child in node[1]:
            cs, ca = _build_frag(nfa, child)
            nfa.eps[a].append(cs)
            a = ca
        return s, a
    if kind == "alt":
        s, a = nfa.new_state(), nfa.new_state()
        for child in node[1]:
            cs, ca = _build_frag(nfa, child)
            nfa.eps[s].append(cs)
            nfa.eps[ca].append(a)
        return s, a
    if kind == "rep":
        _, child, m, n = node
        s = a = nfa.new_state()
        for _ in range(m):  # mandatory copies
            cs, ca = _build_frag(nfa, child)
            nfa.eps[a].append(cs)
            a = ca
        if n is None:  # unbounded tail: one looping copy
            cs, ca = _build_frag(nfa, child)
            nfa.eps[a].append(cs)
            nfa.eps[ca].append(cs)
            end = nfa.new_state()
            nfa.eps[a].append(end)
            nfa.eps[ca].append(end)
            return s, end
        skips = [a]
        for _ in range(n - m):  # optional copies
            cs, ca = _build_frag(nfa, child)
            nfa.eps[a].append(cs)
            a = ca
            skips.append(a)
        end = nfa.new_state()
        for sk in skips[:-1]:
            nfa.eps[sk].append(end)
        nfa.eps[a].append(end)
        return s, end
    raise AssertionError(f"unknown AST node {kind}")


def compile_nfa(pattern: str) -> _NFA:
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    nfa.start, nfa.accept = _build_frag(nfa, ast)
    return nfa


def _closure(nfa: _NFA, states) -> frozenset:
    seen = set(states)
    work = list(states)
    while work:
        s = work.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                work.append(t)
    return frozenset(seen)


# -- token-level DFA ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenDFA:
    """A grammar compiled against one tokenizer vocabulary.

    ``trans[s, v]`` is the next state after emitting token ``v`` from
    state ``s`` (-1: disallowed). ``mask_bits[s]`` packs the allowed-token
    bitmask for state ``s`` little-endian (bit ``v & 7`` of byte
    ``v >> 3``) — the row layout the engine's device-resident mask table
    uses verbatim. EOS ids are allowed (mask only) in accepting states.
    """

    trans: np.ndarray          # [S, V] int32
    mask_bits: np.ndarray      # [S, ceil(V/8)] uint8
    accepting: np.ndarray      # [S] bool
    pattern: str
    start: int = 0

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.trans.shape[1]

    def mask_bool(self, state: int) -> np.ndarray:
        """Unpacked [V] bool allowed mask for one state (host-side
        sampling of prefill/admission first tokens)."""
        bits = np.unpackbits(self.mask_bits[state], bitorder="little")
        return bits[: self.vocab_size].astype(bool)


def build_token_dfa(pattern: str, vocab: list[str],
                    eos_ids=()) -> TokenDFA:
    """Subset construction over the vocab's decoded strings (see module
    docstring). Empty-string tokens are never allowed — a zero-width
    transition would let a stream emit forever without advancing the
    grammar. EOS ids never match as text; accepting states allow them
    in the mask only."""
    nfa = compile_nfa(pattern)
    eos = {int(e) for e in eos_ids}
    vocab_n = len(vocab)
    start = _closure(nfa, (nfa.start,))
    index: dict[frozenset, int] = {start: 0}
    order = [start]
    step_memo: dict[tuple[frozenset, str], frozenset] = {}

    def step(sub: frozenset, ch: str) -> frozenset:
        key = (sub, ch)
        hit = step_memo.get(key)
        if hit is not None:
            return hit
        cp = ord(ch)
        nxt = {t for s in sub for rng, t in nfa.chars[s]
               if _in_ranges(rng, cp)}
        out = _closure(nfa, nxt) if nxt else frozenset()
        step_memo[key] = out
        return out

    rows: list[np.ndarray] = []
    w = 0
    while w < len(order):
        sub = order[w]
        w += 1
        row = np.full((vocab_n,), -1, np.int32)
        for tid, text in enumerate(vocab):
            if not text or tid in eos:
                continue
            cur = sub
            for ch in text:
                cur = step(cur, ch)
                if not cur:
                    break
            if not cur:
                continue
            nxt = index.get(cur)
            if nxt is None:
                nxt = index[cur] = len(order)
                order.append(cur)
                if len(order) > _MAX_STATES:
                    raise RegexError(
                        f"constraint too complex: > {_MAX_STATES} token-DFA "
                        f"states for pattern {pattern!r}")
            row[tid] = nxt
        rows.append(row)

    trans = np.stack(rows)
    accepting = np.asarray([nfa.accept in sub for sub in order], bool)
    allowed = trans >= 0
    for e in eos:
        if 0 <= e < vocab_n:
            allowed[accepting, e] = True
    mask_bits = np.packbits(allowed, axis=1, bitorder="little")
    return TokenDFA(trans=trans, mask_bits=mask_bits, accepting=accepting,
                    pattern=pattern)


# -- JSON Schema -> regex ----------------------------------------------------

_JSON_STR_CHAR = '[ !#-\\[\\]-~]'  # printable ASCII minus '"' and '\'
_INT_RE = "(-?(0|[1-9][0-9]{0,8}))"
_NUM_RE = "(-?(0|[1-9][0-9]{0,8})(\\.[0-9]{1,6})?)"


def _esc_literal(text: str) -> str:
    out = []
    for ch in text:
        if ch in ".^$*+?()[]{}|\\":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def json_schema_to_regex(schema: dict, _depth: int = 0) -> str:
    """Lower a JSON Schema subset to a regex over the canonical rendering
    (no insignificant whitespace except one space after ``:`` and ``,``).

    Supported: object (properties in declaration order — all listed
    properties are emitted; JSON-Schema optionality is out of scope),
    array (minItems/maxItems, default 0..4), string (maxLength, default
    48; ``pattern`` used verbatim for the content; ``enum``/``const``),
    integer, number, boolean, null. Every repetition is BOUNDED so the
    lowered automaton is acyclic: a constrained stream always reaches an
    accepting state (where only EOS is allowed if the grammar is done)
    within a computable token budget.
    """
    if _depth > 8:
        raise RegexError("json schema nests deeper than 8 levels")
    if not isinstance(schema, dict):
        raise RegexError("json schema must be an object")
    if "enum" in schema:
        import json as _json

        arms = [_esc_literal(_json.dumps(v)) for v in schema["enum"]]
        if not arms:
            raise RegexError("empty enum")
        return "(" + "|".join(arms) + ")"
    if "const" in schema:
        import json as _json

        return _esc_literal(_json.dumps(schema["const"]))
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties") or {}
        if not props:
            return "\\{\\}"
        parts = []
        for name, sub in props.items():
            parts.append('"%s": %s' % (
                _esc_literal(name), json_schema_to_regex(sub, _depth + 1)))
        return "\\{" + ", ".join(parts) + "\\}"
    if t == "array":
        item = json_schema_to_regex(schema.get("items") or {"type": "integer"},
                                    _depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", max(lo, 4)))
        if hi < lo:
            raise RegexError("maxItems < minItems")
        if hi == 0:
            return "\\[\\]"
        tail = "(, %s){0,%d}" % (item, hi - 1) if hi > 1 else ""
        body = "%s%s" % (item, tail)
        if lo == 0:
            return "\\[(%s)?\\]" % body
        return "\\[%s\\]" % body
    if t == "string":
        if "pattern" in schema:
            return '"%s"' % schema["pattern"]
        lo = int(schema.get("minLength", 0))
        hi = int(schema.get("maxLength", 48))
        return '"%s{%d,%d}"' % (_JSON_STR_CHAR, lo, hi)
    if t == "integer":
        return _INT_RE
    if t == "number":
        return _NUM_RE
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    raise RegexError(f"unsupported json schema: {schema!r}")


def spec_to_regex(spec: dict) -> str:
    """A serve-plane ``response_format`` body -> regex. Accepts
    ``{"type": "regex", "pattern"|"regex": ...}`` and
    ``{"type": "json_schema", "schema": ...}`` (also the OpenAI-style
    nesting ``{"json_schema": {"schema": ...}}``)."""
    if not isinstance(spec, dict):
        raise RegexError("'response_format' must be an object")
    kind = spec.get("type")
    if kind == "regex":
        pat = spec.get("pattern") or spec.get("regex")
        if not isinstance(pat, str) or not pat:
            raise RegexError("regex response_format needs a 'pattern'")
        return pat
    if kind == "json_schema":
        schema = spec.get("schema")
        if schema is None and isinstance(spec.get("json_schema"), dict):
            schema = spec["json_schema"].get("schema")
        if not isinstance(schema, dict):
            raise RegexError("json_schema response_format needs a 'schema'")
        return json_schema_to_regex(schema)
    raise RegexError(
        f"response_format type must be 'json_schema' or 'regex', "
        f"got {kind!r}")


# -- vocab extraction + caching ---------------------------------------------

def token_strings(tokenizer, vocab_size: int) -> list[str]:
    """Decode every vocab id standalone. Ids the tokenizer cannot decode
    (or that decode to nothing) become '' — never allowed by any DFA."""
    out = []
    for i in range(vocab_size):
        try:
            out.append(tokenizer.decode([i]) or "")
        except Exception:
            out.append("")
    return out


_VOCAB_CACHE: dict[int, tuple[object, list[str]]] = {}


def cached_token_strings(tokenizer, vocab_size: int) -> list[str]:
    """Per-tokenizer memo of :func:`token_strings` (the decode sweep is
    O(vocab); serve handlers call this per request)."""
    hit = _VOCAB_CACHE.get(id(tokenizer))
    if hit is not None and hit[0] is tokenizer and len(hit[1]) == vocab_size:
        return hit[1]
    strings = token_strings(tokenizer, vocab_size)
    if len(_VOCAB_CACHE) > 4:
        _VOCAB_CACHE.clear()
    _VOCAB_CACHE[id(tokenizer)] = (tokenizer, strings)
    return strings


def _vocab_digest(vocab: list[str]) -> str:
    h = hashlib.sha256()
    for s in vocab:
        h.update(s.encode("utf-8", "surrogatepass"))
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _cache_dir() -> str:
    return os.environ.get(
        "CAKE_FSM_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "cake_tpu", "fsm"),
    )


# in-process DFA memo, LRU-capped: a trans table can reach
# _MAX_STATES x vocab int32 (~0.5 GB at 32k vocab), and patterns arrive
# from CLIENTS on the serve plane — unbounded growth would be a
# memory-exhaustion vector (the disk cache bounds only compile time,
# not RSS)
_MEMO: dict[str, TokenDFA] = {}
_MEMO_CAP = 16


def _memo_put(key: str, dfa: TokenDFA) -> None:
    _MEMO.pop(key, None)
    _MEMO[key] = dfa
    while len(_MEMO) > _MEMO_CAP:
        _MEMO.pop(next(iter(_MEMO)))


def compile_constraint(pattern: str, vocab: list[str], eos_ids=(),
                       cache_dir: str | None = None) -> TokenDFA:
    """Pattern + vocab -> :class:`TokenDFA`, through the in-process memo
    and the on-disk cache (content-hash keyed; a cache entry is exactly
    the three arrays, np.savez'd). Misses compile and try to populate
    the disk cache (write failures are non-fatal: the cache is an
    optimization, not a dependency)."""
    key = hashlib.sha256("|".join((
        _CACHE_VERSION, pattern, str(sorted(int(e) for e in eos_ids)),
        str(len(vocab)), _vocab_digest(vocab),
    )).encode()).hexdigest()
    hit = _MEMO.get(key)
    if hit is not None:
        FSM_CACHE_HITS.inc()
        _memo_put(key, hit)  # bump to MRU
        return hit
    path = os.path.join(cache_dir or _cache_dir(), key + ".npz")
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                dfa = TokenDFA(
                    trans=z["trans"], mask_bits=z["mask_bits"],
                    accepting=z["accepting"], pattern=pattern,
                )
            FSM_CACHE_HITS.inc()
            _memo_put(key, dfa)
            return dfa
        except Exception:
            pass  # corrupt entry: fall through to a fresh compile
    FSM_CACHE_MISSES.inc()
    t0 = time.perf_counter()
    dfa = build_token_dfa(pattern, vocab, eos_ids)
    FSM_COMPILE_MS.observe((time.perf_counter() - t0) * 1e3)
    _memo_put(key, dfa)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, trans=dfa.trans, mask_bits=dfa.mask_bits,
                     accepting=dfa.accepting)
        os.replace(tmp, path)
    except OSError:
        pass
    return dfa

"""Grammar-constrained decoding: token-level FSMs applied as logit masks.

A copy of ``k8s_llm_rca_tpu/engine/constrain.py`` (numpy only), with one
difference: ``make_grammar`` has no native step (see its docstring).  The
text below is the JAX package's; in the port the device side is
``engine/sampling.py::sample_tokens_masked`` and
``engine/engine.py::dfa_scan_step``.

The reference extracts fenced ```json / ```cypher blocks with naive
``str.split`` and, when the model misformats, pushes the exception text back
into the thread and retries up to 3 times (reference
find_metapath/find_srckind_metapath_neo4j.py:193-196, test_all.py:70-83).
The serve layer already forces the fences themselves (forced_prefix / stop
strings, serve/backend.py); this module closes the remaining hole — the body
between the fences — with a character-level **JSON pushdown automaton**
lifted to token masks, so a run requested with ``grammar="json"`` cannot
emit unparseable JSON at all.  That converts the reference's retry loop
from a runtime recovery path into dead code.

Division of labor with the jitted decode path (SURVEY §7 hard part 4 —
"constrained decode that stays on the fast decode path"):

- the model forward + sampling stay compiled on device; the FSM runs on the
  host between ticks (the engines already sync one [B] token vector per
  tick, so the FSM adds no extra device round-trips);
- a *forced* token (e.g. EOS once the JSON value closes) costs nothing on
  device: the host overrides the sampled token before it feeds the next
  decode step — the overridden token is what gets written to the KV cache,
  because caches are written by the *next* tick's decode step;
- a *masked* step ships one [B, V] bool array to the device where
  ``sample_tokens_masked`` adds it to the logits — one small transfer, no
  recompilation (the mask is a traced argument).

Token→mask computation simulates each candidate token's characters through
a clone of the automaton.  For the 512-entry byte tokenizer this is
microseconds; for 32k+ BPE vocabs the per-token strings are precomputed
once and cached per tokenizer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from k8s_llm_rca_tpu_torch.utils.logging import get_logger
from k8s_llm_rca_tpu_torch.utils.tokenizer import Tokenizer

WS = " \t\n\r"
DIGITS = "0123456789"
HEX = DIGITS + "abcdefABCDEF"
# characters legal inside a JSON string (unescaped): anything above 0x1f
# except '"' and '\\'; we additionally exclude non-ASCII bytes so byte-level
# tokenizers can't split a multi-byte codepoint across a mask boundary
_STRING_CHARS = "".join(
    chr(c) for c in range(0x20, 0x7F) if chr(c) not in '"\\')
_ESCAPABLE = '"\\/bfnrtu'
# schema strings: the \u hex form is excluded (it would add 4 hex states
# per position); the named escapes cover quoted commands and JSON payloads
_SCHEMA_ESCAPABLE = '"\\/bfnrt'


@dataclass(frozen=True)
class Constraint:
    """What the FSM demands of the next token.

    ``force``: exact token id the engine must emit (no sampling).
    ``allow``: bool [V] mask of permitted token ids (sample under mask).
    Both ``None`` means the step is unconstrained.
    """

    force: Optional[int] = None
    allow: Optional[np.ndarray] = None

    @property
    def free(self) -> bool:
        return self.force is None and self.allow is None


class JsonCharAutomaton:
    """Incremental character-level validator for a single JSON value.

    ``accept(ch)`` consumes one character, returning False (and leaving the
    state unchanged) if it is not a legal continuation.  ``complete`` flips
    once a full top-level value has been consumed.  ``can_terminate`` also
    covers top-level numbers, which only end at end-of-input.
    """

    __slots__ = ("stack", "state", "lit", "lit_pos", "hex_left", "complete")

    def __init__(self):
        self.stack: List[str] = []       # 'obj' | 'arr'
        self.state = "value"
        self.lit = ""                    # target literal (true/false/null)
        self.lit_pos = 0
        self.hex_left = 0                # remaining \uXXXX hex digits
        self.complete = False

    def clone(self) -> "JsonCharAutomaton":
        c = JsonCharAutomaton.__new__(JsonCharAutomaton)
        c.stack = list(self.stack)
        c.state = self.state
        c.lit = self.lit
        c.lit_pos = self.lit_pos
        c.hex_left = self.hex_left
        c.complete = self.complete
        return c

    # ------------------------------------------------------------ helpers

    def _end_value(self) -> None:
        """A value just finished; decide what comes next."""
        if not self.stack:
            self.complete = True
            self.state = "trailing"
        else:
            self.state = "after_value"

    def _delimiters(self) -> str:
        """Characters that may legally follow a just-finished value."""
        if not self.stack:
            return WS
        return WS + (",}" if self.stack[-1] == "obj" else ",]")

    @property
    def can_terminate(self) -> bool:
        """True if end-of-input here yields a complete valid JSON value."""
        return self.complete or (
            not self.stack
            and self.state in ("num_zero", "num_int", "num_frac", "num_exp"))

    # ------------------------------------------------------------ accept

    def accept(self, ch: str) -> bool:  # noqa: C901 (it's a flat automaton)
        s = self.state
        if s in ("value", "arr_value"):
            if ch in WS:
                return True
            if ch == "{":
                self.stack.append("obj")
                self.state = "obj_key_or_end"
            elif ch == "[":
                self.stack.append("arr")
                self.state = "arr_value_or_end"
            elif ch == '"':
                self.state = "str"
            elif ch == "-":
                self.state = "num_minus"
            elif ch == "0":
                self.state = "num_zero"
            elif ch in "123456789":
                self.state = "num_int"
            elif ch in "tfn":
                self.lit = {"t": "true", "f": "false", "n": "null"}[ch]
                self.lit_pos = 1
                self.state = "lit"
            else:
                return False
            return True

        if s == "arr_value_or_end":
            if ch in WS:
                return True              # stay: '[  ]' is still closable
            if ch == "]":
                self.stack.pop()
                self._end_value()
                return True
            self.state = "value"
            ok = self.accept(ch)
            if not ok:
                self.state = "arr_value_or_end"
            return ok

        if s == "obj_key_or_end":
            if ch in WS:
                return True
            if ch == "}":
                self.stack.pop()
                self._end_value()
                return True
            if ch == '"':
                self.state = "key"
                return True
            return False

        if s == "obj_key":
            if ch in WS:
                return True
            if ch == '"':
                self.state = "key"
                return True
            return False

        if s in ("str", "key"):
            if ch == '"':
                self.state = "colon" if s == "key" else None
                if s == "str":
                    self._end_value()
                return True
            if ch == "\\":
                self.state = "str_esc" if s == "str" else "key_esc"
                return True
            return ch in _STRING_CHARS

        if s in ("str_esc", "key_esc"):
            base = "str" if s == "str_esc" else "key"
            if ch == "u":
                self.hex_left = 4
                self.state = base + "_hex"
                return True
            if ch in _ESCAPABLE:
                self.state = base
                return True
            return False

        if s in ("str_hex", "key_hex"):
            if ch in HEX:
                self.hex_left -= 1
                if self.hex_left == 0:
                    self.state = s[:3]
                return True
            return False

        if s == "colon":
            if ch in WS:
                return True
            if ch == ":":
                self.state = "value"
                return True
            return False

        if s == "after_value":
            if ch in WS:
                return True
            top = self.stack[-1]
            if ch == ",":
                self.state = "obj_key" if top == "obj" else "value"
                return True
            if ch == "}" and top == "obj":
                self.stack.pop()
                self._end_value()
                return True
            if ch == "]" and top == "arr":
                self.stack.pop()
                self._end_value()
                return True
            return False

        if s == "lit":
            if self.lit_pos < len(self.lit) and ch == self.lit[self.lit_pos]:
                self.lit_pos += 1
                if self.lit_pos == len(self.lit):
                    self._end_value()
                return True
            return False

        # ---- numbers: strict JSON grammar; they end on a delimiter, which
        # must then be re-dispatched through the post-value state
        if s in ("num_minus", "num_zero", "num_int",
                 "num_frac_start", "num_frac",
                 "num_exp_start", "num_exp_sign", "num_exp"):
            return self._accept_number(s, ch)

        if s == "trailing":
            return ch in WS

        raise AssertionError(f"unknown state {s}")

    def _closing_char(self) -> str:
        """One character moving toward the shortest valid completion."""
        s = self.state
        if s in ("value", "arr_value", "num_minus", "num_frac_start",
                 "num_exp_start", "num_exp_sign", "str_hex", "key_hex"):
            return "0"
        if s == "arr_value_or_end":
            return "]"
        if s == "obj_key_or_end":
            return "}"
        if s in ("obj_key", "str", "key"):
            return '"'
        if s in ("str_esc", "key_esc"):
            return "n"
        if s == "colon":
            return ":"
        if s == "after_value":
            return "}" if self.stack[-1] == "obj" else "]"
        if s == "lit":
            return self.lit[self.lit_pos]
        if s in ("num_zero", "num_int", "num_frac", "num_exp"):
            # number ends at the enclosing delimiter (top-level: end-of-input)
            return "}" if self.stack[-1] == "obj" else "]"
        raise AssertionError(f"no closing char for state {s}")

    def minimal_completion(self) -> str:
        """Shortest character string that completes a valid JSON value from
        the current state ('' if already complete / terminable)."""
        clone = self.clone()
        out = []
        while not clone.complete and not clone.can_terminate:
            ch = clone._closing_char()
            assert clone.accept(ch), (clone.state, ch)
            out.append(ch)
        return "".join(out)

    def _accept_number(self, s: str, ch: str) -> bool:
        cont = {
            "num_minus": {"0": "num_zero", **{d: "num_int" for d in "123456789"}},
            "num_zero": {".": "num_frac_start", "e": "num_exp_start",
                         "E": "num_exp_start"},
            "num_int": {**{d: "num_int" for d in DIGITS},
                        ".": "num_frac_start", "e": "num_exp_start",
                        "E": "num_exp_start"},
            "num_frac_start": {d: "num_frac" for d in DIGITS},
            "num_frac": {**{d: "num_frac" for d in DIGITS},
                         "e": "num_exp_start", "E": "num_exp_start"},
            "num_exp_start": {"+": "num_exp_sign", "-": "num_exp_sign",
                              **{d: "num_exp" for d in DIGITS}},
            "num_exp_sign": {d: "num_exp" for d in DIGITS},
            "num_exp": {d: "num_exp" for d in DIGITS},
        }[s]
        nxt = cont.get(ch)
        if nxt is not None:
            self.state = nxt
            return True
        # a complete number form may end at a delimiter of the enclosing
        # container; incomplete forms (num_minus, num_frac_start, ...) may not
        if s in ("num_zero", "num_int", "num_frac", "num_exp") and \
                ch in self._delimiters():
            self._end_value()
            if ch in WS:
                return True
            return self.accept(ch)   # re-dispatch ',' '}' ']'
        return False


def _token_strings(tokenizer: Tokenizer) -> List[str]:
    """Per-token decoded strings, cached ON the tokenizer instance (an
    id()-keyed module cache would leak tables and could serve a stale
    table after CPython address reuse)."""
    cached = getattr(tokenizer, "_token_strings_cache", None)
    if cached is None:
        cached = [tokenizer.decode([t]) for t in range(tokenizer.vocab_size)]
        tokenizer._token_strings_cache = cached
    return cached


def _vocab_force_tables(strings) -> Tuple[Dict[str, int], int]:
    """(single-char token map, force-close margin) for a vocab.

    The margin encodes the force-close invariant shared by every grammar:
    one sampled token can extend the minimal completion by a few chars per
    character it contains (an opening brace adds a closer, a key quote
    adds '":0', ...), while force-close emits one char per tick — so
    multi-char vocabs must start closing earlier."""
    char_token: Dict[str, int] = {}
    max_chars = 1
    for t, s in enumerate(strings):
        if len(s) == 1 and s not in char_token:
            char_token[s] = t
        max_chars = max(max_chars, len(s))
    return char_token, 2 + 4 * (max_chars - 1)


class JsonGrammar:
    """Token-level FSM guaranteeing the generated body parses as JSON.

    Constraint per step: mask to tokens whose every character the automaton
    accepts; once the top-level value is complete (or a top-level number can
    terminate and the sampled token would be trailing junk), force EOS.
    """

    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer
        self.auto = JsonCharAutomaton()
        self.eos_id = tokenizer.eos_id
        self._strings = _token_strings(tokenizer)
        self._mask_cache: Dict[Tuple, np.ndarray] = {}
        # exact single-character token ids for the force-close path (encode()
        # round trips are not identity for SentencePiece-style tokenizers)
        self._char_token, self._close_margin = _vocab_force_tables(
            self._strings)

    @property
    def done(self) -> bool:
        return self.auto.complete

    def _state_key(self) -> Tuple:
        a = self.auto
        return (tuple(a.stack), a.state, a.lit, a.lit_pos, a.hex_left)

    def constraint(self, remaining: Optional[int] = None) -> Constraint:
        """``remaining``: token budget left for this sequence.  When it
        shrinks to the minimal-completion length (+2 safety margin, 1 token
        per char worst case), the FSM stops sampling and force-closes the
        value so a "length"-terminated sequence still parses."""
        if self.auto.complete:
            return Constraint(force=self.eos_id)
        if remaining is not None:
            completion = self.auto.minimal_completion()
            if remaining <= len(completion) + self._close_margin:
                if not completion:
                    return Constraint(force=self.eos_id)
                forced = self._char_token.get(completion[0])
                if forced is None:
                    # vocab has no exact single-char token for the closer
                    # (never the case for byte vocabs): end cleanly if the
                    # value can terminate, else emit what encode() gives
                    if self.auto.can_terminate:
                        return Constraint(force=self.eos_id)
                    forced = self.tokenizer.encode(completion[0])[0]
                return Constraint(force=forced)
        key = self._state_key()
        allow = self._mask_cache.get(key)
        if allow is None:
            allow = np.zeros((self.tokenizer.vocab_size,), bool)
            for t, s in enumerate(self._strings):
                if not s:
                    continue            # specials / empty decodes: never legal
                if all(c in WS for c in s):
                    # JSON never REQUIRES whitespace; banning pure-ws tokens
                    # keeps output compact instead of letting a weak model
                    # burn its budget emitting newlines
                    continue
                sim = self.auto.clone()
                if all(sim.accept(c) for c in s):
                    allow[t] = True
            if self.auto.can_terminate:
                allow[self.eos_id] = True
            self._mask_cache[key] = allow
        if not allow.any():
            # un-continuable (shouldn't happen with a byte vocab): end the
            # sequence rather than decode garbage forever
            return Constraint(force=self.eos_id)
        return Constraint(allow=allow)

    def advance(self, token: int) -> None:
        if token == self.eos_id:
            return
        for ch in self._strings[token]:
            if not self.auto.accept(ch):
                raise ValueError(
                    f"token {token} ({self._strings[token]!r}) violates the "
                    f"JSON grammar in state {self.auto.state}")


# ---------------------------------------------------------------------------
# schema-constrained decoding (structured outputs)
# ---------------------------------------------------------------------------
#
# Where JsonGrammar guarantees "some valid JSON", SchemaGrammar guarantees a
# SPECIFIC shape: fixed object keys in order, enum-constrained strings,
# bounded arrays/integers.  Punctuation and keys are *forced* (the model
# never samples them); the model only chooses at genuine decision points
# (enum continuations, free-string characters, array continue-vs-close).
# This is what makes the RCA locator stage (rca/locator.py) robust for ANY
# model: even random weights yield a plan whose DestinationKind is a real
# kind from the metagraph vocabulary — the reference can only hope GPT-4
# follows its page-long prompt (reference
# find_metapath/find_srckind_metapath_neo4j.py:212-238).
#
# Supported schema nodes (plain dicts):
#   {"const": "text"}                      literal span (internal use)
#   {"enum": ["A", "B", ...]}              one of the quoted literals
#   {"type": "string", "max_len": N,
#    "escapes": bool}                       free string; escapes=True also
#                                           admits JSON escape pairs \" \\
#                                           \/ \b \f \n \r \t (~2x the DFA
#                                           states for that field)
#   {"type": "integer", "max_digits": N}   non-negative JSON integer
#   {"type": "boolean"}                    true | false
#   {"type": "array", "items": S,
#    "min_items": a, "max_items": b}       '[' items ', '-separated ']'
#   {"type": "object", "properties":
#    [(key, S), ...]}                      fixed keys, fixed order
#   {"type": "choice", "options":
#    ["txt1", "txt2", ...]}                 RAW-text alternative (no JSON
#                                           quoting; options prefix-free) —
#                                           compiled templates (e.g. the
#                                           Cypher skeleton grammar) offer
#                                           the model a bounded choice of
#                                           complete well-formed variants
#   {"type": "seq", "items": [S, ...]}     raw concatenation of nodes (no
#                                           JSON decorations; template glue)
#   {"type": "json", "max_depth": D,
#    "max_str": L, "max_digits": N,
#    "max_items": M, "key_len": K}         BOUNDED any-JSON value: nesting
#                                           capped at D, strings/ints/
#                                           containers bounded — FINITE by
#                                           construction, so generic JSON
#                                           decode compiles to DFA tables
#                                           and rides the on-device scan
#                                           (the unbounded JsonGrammar
#                                           cannot).  Alternation handled
#                                           by first-char dispatch ('{',
#                                           '[', '"', digit, t/f/n are
#                                           disjoint).


def _compile_schema(schema: Dict, _root: bool = True) -> Tuple:
    """Schema dict -> immutable node tree.  ``_root`` tracks whether this
    node is the DOCUMENT root (nested nodes always have a following
    delimiter, which changes what can terminate — see the json node)."""
    import json as _json

    if "const" in schema:
        return ("lit", schema["const"])
    if "enum" in schema:
        cands = tuple(str(c) for c in schema["enum"])
        if not cands:
            raise ValueError("enum must be non-empty")
        for c in cands:
            if any(ch not in _STRING_CHARS for ch in c):
                raise ValueError(f"enum literal {c!r} has non-plain chars")
        return ("enum", cands)
    t = schema.get("type")
    if t == "string":
        # escapes=True additionally admits \" \\ \/ \b \f \n \r \t inside
        # the string (JSON escape pairs; ~2x the DFA states per field, so
        # it is opt-in per field — fields carrying quoted commands/JSON
        # need it, short labels don't)
        return ("str", int(schema.get("max_len", 64)),
                bool(schema.get("escapes", False)))
    if t == "integer":
        return ("int", int(schema.get("max_digits", 6)))
    if t == "boolean":
        return ("bool", ("true", "false"))
    if t == "array":
        lo = int(schema.get("min_items", 0))
        hi = int(schema.get("max_items", 8))
        if not (0 <= lo <= hi and hi >= 1):
            raise ValueError(f"bad array bounds [{lo}, {hi}]")
        return ("arr", _compile_schema(schema["items"], False), lo, hi, "[", "]")
    if t == "object":
        props = schema["properties"]
        if isinstance(props, dict):
            props = list(props.items())
        nodes: List[Tuple] = []
        for i, (key, sub) in enumerate(props):
            opener = "{" if i == 0 else ", "
            nodes.append(("lit", f"{opener}{_json.dumps(key)}: "))
            nodes.append(_compile_schema(sub, False))
        nodes.append(("lit", "}" if props else "{}"))
        return ("seq", tuple(nodes))
    if t == "choice":
        # dedup by VALUE (duplicates would leave the candidate set unable
        # to narrow to one, so the frame could never pop)
        opts = tuple(dict.fromkeys(str(o) for o in schema["options"]))
        if not opts or any(not o for o in opts):
            raise ValueError("choice options must be non-empty strings")
        for a in opts:
            for b in opts:
                if a != b and b.startswith(a):
                    # the candidate-narrowing frame pops only on a UNIQUE
                    # fully-consumed candidate; prefix pairs would make the
                    # shorter option unreachable
                    raise ValueError(
                        f"choice options must be prefix-free: {a!r} "
                        f"prefixes {b!r}")
        if len(opts) == 1:
            return ("lit", opts[0])
        # raw-text alternatives reuse the boolean machinery: "bool" is
        # exactly candidate narrowing over ("true", "false")
        return ("bool", opts)
    if t == "seq":
        items = tuple(_compile_schema(s, False) for s in schema["items"])
        if not items:
            raise ValueError("seq items must be non-empty")
        return ("seq", items)
    if t == "json":
        depth = int(schema.get("max_depth", 2))
        if not 0 <= depth <= 6:
            raise ValueError(f"json max_depth {depth} out of range [0, 6]")
        return _json_value_node(
            depth,
            max_str=int(schema.get("max_str", 32)),
            max_digits=int(schema.get("max_digits", 9)),
            max_items=int(schema.get("max_items", 6)),
            key_len=int(schema.get("key_len", 16)),
            top=_root)
    raise ValueError(f"unsupported schema node: {schema!r}")


def _json_value_node(depth: int, max_str: int, max_digits: int,
                     max_items: int, key_len: int,
                     top: bool = False) -> Tuple:
    """Bounded any-JSON value as an alternation tree.

    The int child comes first by convention when present: "alt"
    forced-closing descends into child 0, and "0" is the shortest
    closable value.  At the TOP level the bare-int child is dropped: an
    int frame pops only at a delimiter, and a document's end has none, so
    a bare top-level number could never reach the complete state (every
    container/string/keyword closes on its own last char instead)."""
    scalars = (
        ("int", max_digits),
        ("bool", ("true", "false", "null")),
        ("str", max_str, True),
    )
    if top:
        scalars = scalars[1:]
    if depth <= 0:
        return ("alt", scalars)
    sub = _json_value_node(depth - 1, max_str, max_digits, max_items,
                           key_len)
    obj_entry = ("seq", (("str", key_len, False), ("lit", ": "), sub))
    return ("alt", scalars + (
        ("arr", sub, 0, max_items, "[", "]"),
        ("arr", obj_entry, 0, max_items, "{", "}"),
    ))


def _node_first_char(node: Tuple) -> str:
    kind = node[0]
    if kind == "lit":
        return node[1][0]
    if kind in ("str", "enum"):
        return '"'
    if kind == "int":
        return "0"
    if kind == "bool":                     # also generic raw-text choices
        return min(node[1], key=len)[0]
    if kind == "arr":
        return node[4]
    if kind == "seq":
        return _node_first_char(node[1][0])
    if kind == "alt":
        return _node_first_char(node[1][0])
    raise AssertionError(node)


def _node_first_chars(node: Tuple) -> str:
    """EVERY char the node can legally start with (alt dispatch)."""
    kind = node[0]
    if kind == "lit":
        return node[1][0]
    if kind in ("str", "enum"):
        return '"'
    if kind == "int":
        return DIGITS
    if kind == "bool":
        return "".join({c[0] for c in node[1]})
    if kind == "arr":
        return node[4]
    if kind == "seq":
        return _node_first_chars(node[1][0])
    if kind == "alt":
        return "".join(_node_first_chars(c) for c in node[1])
    raise AssertionError(node)


class SchemaAutomaton:
    """Character acceptor for one schema-shaped JSON value.

    Mutable frame stack; each frame is a list whose head names the kind.
    ``accept`` consumes one character (False = illegal, state unchanged for
    the dispatching frame); ``complete`` flips when the root value closes.
    """

    __slots__ = ("stack", "complete")

    def __init__(self, root: Tuple):
        self.stack: List[List] = []
        self.complete = False
        self._push(root)

    def clone(self) -> "SchemaAutomaton":
        c = SchemaAutomaton.__new__(SchemaAutomaton)
        c.stack = [list(f) for f in self.stack]
        c.complete = self.complete
        return c

    # ------------------------------------------------------------ frames

    def _push(self, node: Tuple) -> None:
        kind = node[0]
        if kind == "lit":
            self.stack.append(["lit", node[1], 0])
        elif kind == "str":
            # [_, max_len, n, opened, esc_pending, escapes_allowed]
            self.stack.append(["str", node[1], 0, False, False, node[2]])
        elif kind == "enum":
            self.stack.append(["enum", node[1], 0, False])
        elif kind == "int":
            self.stack.append(["int", node[1], 0, False])
        elif kind == "bool":
            self.stack.append(["bool", node[1], 0])
        elif kind == "arr":
            # [_, item, lo, hi, count, state, open_ch, close_ch]
            self.stack.append(["arr", node[1], node[2], node[3], 0, "open",
                               node[4], node[5]])
        elif kind == "seq":
            self.stack.append(["seq", node[1], 0])
            self._push(node[1][0])
        elif kind == "alt":
            self.stack.append(["alt", node[1]])
        else:
            raise AssertionError(node)

    def _pop_done(self) -> None:
        """Top frame finished; unwind seq/arr parents."""
        self.stack.pop()
        while self.stack:
            top = self.stack[-1]
            if top[0] == "seq":
                top[2] += 1
                if top[2] < len(top[1]):
                    self._push(top[1][top[2]])
                    return
                self.stack.pop()
            elif top[0] == "arr":
                top[4] += 1
                top[5] = "after_item"
                return
            else:
                raise AssertionError(top)
        self.complete = True

    # ------------------------------------------------------------ accept

    def accept(self, ch: str) -> bool:
        if self.complete:
            return ch in WS
        f = self.stack[-1]
        kind = f[0]

        if kind == "lit":
            if f[1][f[2]] != ch:
                return False
            f[2] += 1
            if f[2] == len(f[1]):
                self._pop_done()
            return True

        if kind == "str":           # [_, max_len, n, opened, esc, escapes]
            if not f[3]:
                if ch == '"':
                    f[3] = True
                    return True
                return False
            if f[4]:                        # escape pending: \X pair
                if ch in _SCHEMA_ESCAPABLE:
                    f[4] = False
                    f[2] += 1
                    return True
                return False
            if ch == '"':
                self._pop_done()
                return True
            if ch == "\\" and f[5] and f[2] < f[1]:
                f[4] = True
                return True
            if ch in _STRING_CHARS and f[2] < f[1]:
                f[2] += 1
                return True
            return False

        if kind == "enum":                  # [_, cands, pos, opened]
            if not f[3]:
                if ch == '"':
                    f[3] = True
                    return True
                return False
            if ch == '"':
                if any(len(c) == f[2] for c in f[1]):
                    self._pop_done()
                    return True
                return False
            nxt = tuple(c for c in f[1] if len(c) > f[2] and c[f[2]] == ch)
            if not nxt:
                return False
            f[1] = nxt
            f[2] += 1
            return True

        if kind == "int":                   # [_, max_digits, n, leading_zero]
            if ch in DIGITS:
                if f[2] == 0:
                    f[2], f[3] = 1, ch == "0"
                    return True
                if f[3] or f[2] >= f[1]:
                    return False
                f[2] += 1
                return True
            if f[2] > 0:                    # number ends at the delimiter:
                self._pop_done()            # pop, then re-dispatch the char
                return self.accept(ch)
            return False

        if kind == "bool":                  # [_, cands, pos]
            nxt = tuple(c for c in f[1] if len(c) > f[2] and c[f[2]] == ch)
            if not nxt:
                return False
            f[1] = nxt
            f[2] += 1
            if len(f[1]) == 1 and f[2] == len(f[1][0]):
                self._pop_done()
            return True

        if kind == "arr":     # [_, item, lo, hi, count, state, open, close]
            state = f[5]
            if state == "open":
                if ch != f[6]:
                    return False
                f[5] = "first"
                return True
            if state == "first":
                if ch == f[7] and f[2] == 0:
                    self._pop_done()
                    return True
                depth = len(self.stack)      # a seq item pushes >1 frame
                f[5] = "in"
                self._push(f[1])
                if self.accept(ch):
                    return True
                del self.stack[depth:]       # illegal first char: undo
                f[5] = "first"
                return False
            if state == "after_item":
                if ch == "," and f[4] < f[3]:
                    f[5] = "sep"
                    return True
                if ch == f[7] and f[4] >= f[2]:
                    self._pop_done()
                    return True
                return False
            if state == "sep":
                if ch != " ":
                    return False
                f[5] = "in"
                self._push(f[1])
                return True
            raise AssertionError(state)

        if kind == "alt":                   # [_, children]
            for child in f[1]:
                if ch in _node_first_chars(child):
                    # commit to the unique child claiming this first char
                    self.stack.pop()
                    self._push(child)
                    return self.accept(ch)
            return False

        raise AssertionError(kind)

    # ---------------------------------------------------- forced closing

    def _min_step(self) -> Optional[str]:
        """One character of the shortest completion, or None if the step is
        a charless transition (e.g. a finished integer popping)."""
        f = self.stack[-1]
        kind = f[0]
        if kind == "lit":
            return f[1][f[2]]
        if kind == "str":
            return "n" if f[4] else '"'     # finish a pending escape first
        if kind == "enum":
            if not f[3]:
                return '"'
            best = min(f[1], key=len)
            return '"' if len(best) == f[2] else best[f[2]]
        if kind == "int":
            if f[2] == 0:
                return "0"
            self._pop_done()                # ends at delimiter: charless pop
            return None
        if kind == "bool":
            return min(f[1], key=len)[f[2]]
        if kind == "arr":
            state = f[5]
            if state == "open":
                return f[6]
            if state == "first":
                return f[7] if f[2] == 0 else _node_first_char(f[1])
            if state == "after_item":
                return f[7] if f[4] >= f[2] else ","
            if state == "sep":
                return " "
        if kind == "alt":
            # descend into child 0 (the minimal-completion child by
            # construction); charless transition
            self.stack.pop()
            self._push(f[1][0])
            return None
        raise AssertionError(f)

    def minimal_completion(self) -> str:
        clone = self.clone()
        out: List[str] = []
        for _ in range(100_000):
            if clone.complete:
                return "".join(out)
            ch = clone._min_step()
            if ch is None:
                continue
            assert clone.accept(ch), (clone.stack, ch)
            out.append(ch)
        raise AssertionError("schema completion did not converge")

    def state_key(self) -> Tuple:
        return (self.complete, tuple(tuple(f) for f in self.stack))


class SchemaGrammar:
    """Token-level FSM enforcing a schema template (structured outputs).

    Same engine protocol as JsonGrammar: ``constraint(remaining)`` /
    ``advance(token)``.  Literal spans are *forced* as the longest matching
    vocab token, so skeleton text costs one forced token per tick (one per
    char on byte vocabs) and zero sampling."""

    def __init__(self, schema: Dict, tokenizer: Tokenizer):
        self.tokenizer = tokenizer
        self.root = _compile_schema(schema)
        self.auto = SchemaAutomaton(self.root)
        self.eos_id = tokenizer.eos_id
        self._strings = _token_strings(tokenizer)
        self._mask_cache: Dict[Tuple, np.ndarray] = {}
        self._char_token, self._close_margin = _vocab_force_tables(
            self._strings)

    @property
    def done(self) -> bool:
        return self.auto.complete

    def min_budget(self) -> int:
        """Smallest max_new_tokens that can hold a valid document (worst
        case one char per token).  Budgets below this cannot terminate in a
        parseable state; EngineBackend.start rejects them."""
        return len(SchemaAutomaton(self.root).minimal_completion()) \
            + self._close_margin

    def _force_char(self, ch: str) -> Constraint:
        forced = self._char_token.get(ch)
        if forced is None:
            forced = self.tokenizer.encode(ch)[0]
        return Constraint(force=forced)

    def _forced_literal(self) -> Optional[Constraint]:
        """When the automaton sits in a literal span — or a candidate
        ("bool"/choice) frame whose remaining candidates all agree on the
        next characters — force the longest token lying entirely inside
        the agreed span.  This keeps per-request template grammars (e.g.
        the stage-2 Cypher skeleton, long literals + one branch point)
        O(1) per token: the O(V·len) mask build runs only at genuine
        divergence points."""
        f = self.auto.stack[-1] if self.auto.stack else None
        if f is None:
            return None
        if f[0] == "lit":
            upcoming = f[1][f[2]:]
        elif f[0] == "bool":
            # common prefix of all remaining candidates' suffixes
            suffixes = [c[f[2]:] for c in f[1]]
            upcoming = suffixes[0]
            for s in suffixes[1:]:
                n = min(len(upcoming), len(s))
                i = 0
                while i < n and upcoming[i] == s[i]:
                    i += 1
                upcoming = upcoming[:i]
            if not upcoming:
                return None                  # divergence point: mask
        else:
            return None
        best = self._char_token.get(upcoming[0])
        best_len = 1 if best is not None else 0
        if len(upcoming) > 1:
            for t, s in enumerate(self._strings):
                if len(s) > best_len and len(s) <= len(upcoming) \
                        and upcoming.startswith(s):
                    best, best_len = t, len(s)
        if best is None:
            return None                     # no in-span token: mask instead
        return Constraint(force=best)

    def constraint(self, remaining: Optional[int] = None) -> Constraint:
        """Budget soundness: a fixed close-margin is NOT enough for schema
        templates — one sampled ',' can commit the document to a whole
        mandatory item, jumping the minimal completion by dozens of chars.
        The mask is therefore BUDGET-AWARE: a token is legal only if the
        document can still complete within ``remaining`` after it (the
        per-token completion lengths are cached per state)."""
        if self.auto.complete:
            return Constraint(force=self.eos_id)
        forced = self._forced_literal()
        if forced is not None:
            # literal span: skip the O(V) mask build — the forced token is
            # ON the template path, so it can only shrink the completion;
            # verify the budget on it directly
            if remaining is None:
                return forced
            sim = self.auto.clone()
            ok = all(sim.accept(ch) for ch in self._strings[forced.force])
            if ok and len(sim.minimal_completion()) <= remaining - 2:
                return forced
        key = self.auto.state_key()
        entry = self._mask_cache.get(key)
        if entry is None:
            allow = np.zeros((self.tokenizer.vocab_size,), bool)
            next_len = np.full((self.tokenizer.vocab_size,),
                               np.iinfo(np.int32).max, np.int32)
            for t, s in enumerate(self._strings):
                if not s:
                    continue   # empty decodes would self-loop forever;
                # (pure-WS tokens stay legal: schema templates REQUIRE
                # their separators' whitespace, unlike free-form JSON)
                sim = self.auto.clone()
                if all(sim.accept(c) for c in s):
                    allow[t] = True
                    next_len[t] = len(sim.minimal_completion())
            self._mask_cache[key] = entry = (allow, next_len)
        allow, next_len = entry
        if remaining is not None:
            # the token itself + the completion chars (1 token/char worst
            # case) + the EOS token must all fit the budget
            allow = allow & (next_len <= remaining - 2)
        if not allow.any():
            completion = self.auto.minimal_completion()
            if not completion:          # already terminable: end cleanly
                return Constraint(force=self.eos_id)
            return self._force_char(completion[0])
        hits = np.flatnonzero(allow)
        if len(hits) == 1:
            return Constraint(force=int(hits[0]))
        return Constraint(allow=allow)

    def advance(self, token: int) -> None:
        if token == self.eos_id:
            return
        for ch in self._strings[token]:
            if not self.auto.accept(ch):
                raise ValueError(
                    f"token {token} ({self._strings[token]!r}) violates the "
                    f"schema grammar at {self.auto.stack[-1:]!r}")


def _template_text_len(node) -> int:
    """Estimated DFA state count for a choice/seq template grammar: the
    automaton has ~one state per emittable literal character, so sum the
    literal text lengths (choice options, seq items).  Non-literal
    sub-nodes fall back to their serialized length (conservative)."""
    if isinstance(node, str):
        return len(node)
    if isinstance(node, dict):
        t = node.get("type")
        if t == "choice":
            return sum(_template_text_len(o) for o in node.get("options", ()))
        if t == "seq":
            return sum(_template_text_len(i) for i in node.get("items", ()))
    import json as _json

    return len(_json.dumps(node, default=str))


def make_grammar(name, tokenizer: Tokenizer, prefer_native: bool = True):
    """GenOptions.grammar -> FSM instance (None = unconstrained).

    ``name`` may be the string "json" (any-JSON grammar: the bounded DFA,
    else the C++ ``NativeJsonGrammar`` of ``native/`` with
    ``prefer_native``, else the Python ``JsonGrammar``; the last two are
    mask for mask equal, and their mask is O(V·len) per tick) or a schema
    dict (SchemaGrammar structured output)."""
    if name is None:
        return None
    if isinstance(name, dict):
        if name.get("type") in ("choice", "seq"):
            # raw-text template grammars (e.g. the per-incident Cypher
            # skeleton) are typically ONE-SHOT, so the DFA compile is pure
            # overhead for THAT run — but an interpreted slot degrades the
            # engine's WHOLE batch to per-token stepwise ticks
            # (_scan_chunk), which on dispatch-latency-dominated hosts
            # costs far more than the compile (observed: the shared-engine
            # sweep serialized onto host ticks whenever any stage-2
            # skeleton was in flight).  Compile when the estimated table
            # (one state per template char x vocab) stays small; fall back
            # to the interpreted FSM above that or on compile refusal.
            # The estimate sums the template's LITERAL text lengths — the
            # DFA has roughly one state per emittable char; counting the
            # serialized dict's keys/syntax (len(json.dumps)) overshot ~2x
            # and flipped mid-size templates to the interpreted FSM, which
            # degrades the whole shared batch to per-token host ticks.
            est_states = _template_text_len(name)
            if est_states * tokenizer.vocab_size * 5 <= \
                    _DFA_TEMPLATE_TABLE_BYTES:
                try:
                    return DFAGrammar(name, tokenizer)
                except (ValueError, MemoryError) as e:
                    get_logger(__name__).info(
                        "template DFA unavailable (%s); interpreted", e)
            return SchemaGrammar(name, tokenizer)
        # prefer the compiled DFA (tables cached per tokenizer; enables the
        # engines' on-device constrained scan); fall back to the
        # interpreted FSM when the schema's state space is too large
        try:
            return DFAGrammar(name, tokenizer)
        except (ValueError, MemoryError) as e:
            get_logger(__name__).info("schema DFA unavailable (%s); using "
                                      "the interpreted FSM", e)
            return SchemaGrammar(name, tokenizer)
    if name == "json":
        # bounded-depth DFA first: generic JSON then rides the engines'
        # on-device constrained scan like schema grammars (the unbounded
        # automaton cannot compile — VERDICT r2 item 6).  The bounds
        # restrict output to canonical JSON of modest depth/size, which is
        # strictly parseable; oversized vocabularies blow the table budget
        # and fall through to the unbounded host-side grammars.
        try:
            import time as _time

            t0 = _time.perf_counter()
            g = DFAGrammar({"type": "json"}, tokenizer)
            dt = _time.perf_counter() - t0
            if dt > 0.2:
                # the one-off BFS costs seconds; mark it so the first
                # request's latency cliff is attributable (later requests
                # hit the per-tokenizer table cache)
                get_logger(__name__).info(
                    "compiled bounded-json DFA (%d states) in %.1fs "
                    "(cached per tokenizer)", g.tables.n_states, dt)
            return g
        except (ValueError, MemoryError) as e:
            get_logger(__name__).info(
                "bounded-json DFA unavailable (%s); using the unbounded "
                "host grammar", e)
        if prefer_native:
            from k8s_llm_rca_tpu_torch import native
            if native.available():
                return native.NativeJsonGrammar(tokenizer)
        return JsonGrammar(tokenizer)
    raise ValueError(f"unknown grammar {name!r} (supported: 'json' or a "
                     f"schema dict)")


# ---------------------------------------------------------------------------
# compiled DFA: schema-constrained decode ON the device (zero host sync)
# ---------------------------------------------------------------------------
#
# SchemaAutomaton is FINITE by construction (fixed keys, bounded strings /
# arrays / integers), so the whole grammar compiles to lookup tables:
#
#   char_next  [S, C]   char-level DFA (BFS over automaton states)
#   token_next [S, V]   char DFA lifted through each token's characters
#   allow      [S, V]   token legal in state s (host mask, bit-identical)
#   dist       [S]      chars to the nearest completion (budget force-close)
#   close_tok  [S]      next token on that shortest completion path
#   complete   [S]      full document consumed -> force EOS
#
# With the FSM reduced to gathers, the jitted decode scan applies the
# grammar itself (engine.decode_scan_dfa): mask -> sample -> state
# transition, all on device — the "constrained decode that stays on the
# fast decode path" hard part of SURVEY §7, solved the TPU way.  Host-side
# DFAGrammar speaks the same constraint/advance protocol (table lookups),
# so stepwise ticks, preemption and retries keep working unchanged.

_DFA_REJECT = -1
# cap on the compiled tables' footprint: token_next int32 + allow bool per
# (state, vocab) cell.  BFS enforces it incrementally, so oversized schemas
# fail fast with ValueError and make_grammar falls back to the interpreted
# FSM instead of allocating unbounded [S, V] arrays
_DFA_MAX_TABLE_BYTES = 256 * 1024 * 1024
_DFA_FAR = np.int32(1 << 30)

# table budget for ONE-SHOT template grammars (choice/seq): smaller than
# _DFA_MAX_TABLE_BYTES because the compile amortizes over a single run —
# at 32 MB a 512-token test vocab admits ~13k template chars while a 32k
# production vocab flips long templates to the interpreted FSM (where the
# compile would cost minutes)
_DFA_TEMPLATE_TABLE_BYTES = 32 << 20


class DFATables:
    """Host (numpy) tables for one compiled schema x tokenizer."""

    __slots__ = ("token_next", "allow", "dist", "close_tok", "complete",
                 "start", "free_state", "close_margin", "eos_id",
                 "n_states", "single")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _enumerate_char_dfa(root, alphabet: str, max_states: int):
    """BFS the automaton over ``alphabet``; returns (char_next [S, C],
    complete [S], automatons-per-state for distance bootstrapping)."""
    start = SchemaAutomaton(root)
    ids: Dict[Tuple, int] = {start.state_key(): 0}
    autos = [start]
    rows: List[List[int]] = []
    frontier = [0]
    while frontier:
        nxt_frontier: List[int] = []
        for sid in frontier:
            a = autos[sid]
            row = []
            for ch in alphabet:
                sim = a.clone()
                if not sim.accept(ch):
                    row.append(_DFA_REJECT)
                    continue
                key = sim.state_key()
                tid = ids.get(key)
                if tid is None:
                    tid = len(autos)
                    if tid >= max_states:
                        raise ValueError(
                            f"schema DFA exceeds {max_states} states "
                            f"(table budget {_DFA_MAX_TABLE_BYTES >> 20} MB)")
                    ids[key] = tid
                    autos.append(sim)
                    nxt_frontier.append(tid)
                row.append(tid)
            rows.append(row)
        frontier = nxt_frontier
    char_next = np.asarray(rows, np.int32)
    complete = np.asarray([a.complete for a in autos], bool)
    return char_next, complete


def compile_schema_dfa(schema: Dict, tokenizer: Tokenizer) -> DFATables:
    """Compile a schema to device-ready DFA tables (see module section)."""
    root = _compile_schema(schema)
    strings = _token_strings(tokenizer)
    char_token, close_margin = _vocab_force_tables(strings)

    # alphabet: every char any vocab token can emit (others always reject)
    alphabet = sorted(set("".join(strings)))
    col = {ch: i for i, ch in enumerate(alphabet)}
    max_states = max(256, _DFA_MAX_TABLE_BYTES // (5 * len(strings)))
    char_next, complete = _enumerate_char_dfa(root, alphabet, max_states)
    n = char_next.shape[0]

    # dist (chars to completion) + the closing char, by fixpoint relaxation
    dist = np.where(complete, 0, _DFA_FAR).astype(np.int64)
    close_col = np.zeros((n,), np.int32)
    # neighbor distances: dist over char_next with REJECT -> FAR
    for _ in range(n + 1):
        nb = np.where(char_next >= 0, dist[np.maximum(char_next, 0)],
                      _DFA_FAR)                        # [S, C]
        best = nb.min(axis=1)
        cand = np.minimum(dist, 1 + best)
        if (cand == dist).all():
            break
        improved = cand < dist
        close_col = np.where(improved, nb.argmin(axis=1), close_col)
        dist = cand
    if (dist >= _DFA_FAR).any():
        raise ValueError("schema DFA has states with no completion path")

    # lift the char DFA through every token's characters: [S, V]
    V = len(strings)
    max_len = max((len(s) for s in strings), default=1)
    # the alphabet is built FROM the vocab strings, so every token char
    # has a column by construction
    tok_chars = np.full((V, max_len), -1, np.int32)
    tok_len = np.zeros((V,), np.int32)
    for t, s in enumerate(strings):
        tok_len[t] = len(s)
        for i, ch in enumerate(s):
            tok_chars[t, i] = col[ch]

    cur = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                          (n, V)).copy()
    for pos in range(max_len):
        active = pos < tok_len                        # [V]
        chars = np.maximum(tok_chars[:, pos], 0)      # [V]
        safe = np.maximum(cur, 0)
        stepped = char_next[safe, chars[None, :]]     # [S, V]
        stepped = np.where(cur < 0, _DFA_REJECT, stepped)
        cur = np.where(active[None, :], stepped, cur)

    allow = cur >= 0
    # ban empty decodes (they would self-loop forever); pure-WS tokens stay
    # LEGAL — schema templates REQUIRE their separators' spaces, unlike
    # free-form JSON where whitespace is optional padding
    for t, s in enumerate(strings):
        if not s:
            allow[:, t] = False
    allow[:, tokenizer.eos_id] = False     # EOS is forced via `complete`
    allow[complete] = False                # complete -> force EOS

    # closing token per state: exact single-char token for the closing char
    close_tok = np.zeros((n,), np.int32)
    for s in range(n):
        if complete[s]:
            close_tok[s] = tokenizer.eos_id
            continue
        ch = alphabet[close_col[s]]
        tid = char_token.get(ch)
        if tid is None:
            # No exact single-char vocab token for this closing char: a
            # multi-char encode() fallback could land the scan's force-close
            # on a token whose extra chars derail the DFA (worst case the
            # state maps to FREE and the slot decodes unconstrained while the
            # host-side advance raises mid-serve).  Refuse to compile;
            # make_grammar falls back to the interpreted SchemaGrammar,
            # which force-closes char-by-char on the host.
            raise ValueError(
                f"closing char {ch!r} has no single-char vocab token; "
                f"schema DFA cannot force-close safely")
        close_tok[s] = tid

    # singleton states (literal spans): exactly one legal token -> the
    # host constraint can FORCE it instead of shipping a mask
    single = np.where(allow.sum(axis=1) == 1,
                      allow.argmax(axis=1), -1).astype(np.int32)

    # append the FREE row (unconstrained slots in a mixed scan batch)
    free = n
    token_next = np.concatenate(
        [np.where(cur >= 0, cur, free).astype(np.int32),
         np.full((1, V), free, np.int32)], axis=0)
    allow = np.concatenate([allow, np.ones((1, V), bool)], axis=0)
    # FREE row distance is 0: unconstrained slots must always pass the
    # budget-fits mask (their budgets are enforced by the engine, not the
    # grammar)
    dist = np.concatenate([dist.astype(np.int32), [0]])
    close_tok = np.concatenate([close_tok, [tokenizer.eos_id]])
    complete = np.concatenate([complete, [False]])
    single = np.concatenate([single, [-1]])

    return DFATables(token_next=token_next, allow=allow, dist=dist,
                     close_tok=close_tok, complete=complete, start=0,
                     free_state=free, close_margin=close_margin,
                     eos_id=tokenizer.eos_id, n_states=n + 1,
                     single=single)


def _dfa_cache_get(schema: Dict, tokenizer: Tokenizer) -> DFATables:
    """Per-tokenizer cache keyed by the canonical schema JSON (compilation
    costs seconds; serving reuses one schema for thousands of runs)."""
    import json as _json

    # no default=str: two distinct non-serializable values whose str() forms
    # collide would alias to one compiled table set.  A non-serializable
    # schema refuses here (as ValueError so make_grammar's interpreted-FSM
    # fallback applies; SchemaGrammar coerces values itself)
    try:
        key = _json.dumps(schema, sort_keys=True)
    except TypeError as e:
        raise ValueError(f"schema is not canonically JSON-serializable: {e}")
    cache = getattr(tokenizer, "_dfa_tables_cache", None)
    if cache is None:
        cache = {}
        tokenizer._dfa_tables_cache = cache
    tables = cache.get(key)
    if tables is not None:
        cache[key] = cache.pop(key)       # LRU refresh: hot schemas (the
        # per-stage plan/report) must survive one-shot skeleton churn
        if isinstance(tables, str):
            raise ValueError(tables)      # negative-cached compile refusal
        return tables
    try:
        tables = compile_schema_dfa(schema, tokenizer)
    except ValueError as e:
        # negative-cache refusals too: an uncompilable schema (state
        # blowup, vocab missing a closer token) must not re-pay the full
        # BFS + token lift on every request before falling back.  Store
        # the message only — the live exception's traceback would pin the
        # partially-built [S, V] compile arrays in the cache
        tables = str(e)
    # bound the cache: a server fed ever-changing schemas must not
    # accumulate multi-MB table sets (or unbounded refusal entries)
    # forever (FIFO eviction; dict preserves insertion order)
    while len(cache) >= 8:
        cache.pop(next(iter(cache)))
    cache[key] = tables
    if isinstance(tables, str):
        raise ValueError(tables)
    return tables


class DFAGrammar:
    """SchemaGrammar drop-in backed by compiled tables.

    Same host protocol (constraint/advance) via O(1) lookups, PLUS
    ``tables`` for the engines' on-device constrained scan
    (engine.decode_scan_dfa) — grammar slots no longer force per-token
    host ticks."""

    def __init__(self, schema: Dict, tokenizer: Tokenizer):
        self.tokenizer = tokenizer
        self.tables = _dfa_cache_get(schema, tokenizer)
        self.eos_id = tokenizer.eos_id
        self.state = self.tables.start

    @property
    def done(self) -> bool:
        return bool(self.tables.complete[self.state])

    def min_budget(self) -> int:
        return int(self.tables.dist[self.tables.start]) \
            + self.tables.close_margin

    def constraint(self, remaining: Optional[int] = None) -> Constraint:
        """Budget-aware: only tokens from which the document still
        completes within ``remaining`` are legal (dist of the successor
        state; a fixed margin is unsound for templates — see
        SchemaGrammar.constraint)."""
        t = self.tables
        if t.complete[self.state]:
            return Constraint(force=self.eos_id)
        row = t.allow[self.state]
        if remaining is not None:
            nxt = t.token_next[self.state]
            row = row & (np.where(row, t.dist[np.minimum(
                nxt, t.n_states - 1)], _DFA_FAR) <= remaining - 2)
        if not row.any():
            return Constraint(force=int(t.close_tok[self.state]))
        hits = np.flatnonzero(row)
        if len(hits) == 1:
            return Constraint(force=int(hits[0]))
        return Constraint(allow=row)

    def advance(self, token: int) -> None:
        if token == self.eos_id:
            return
        t = self.tables
        nxt = int(t.token_next[self.state, token])
        if nxt == t.free_state and not t.allow[self.state, token]:
            raise ValueError(
                f"token {token} violates the schema DFA in state "
                f"{self.state}")
        self.state = nxt

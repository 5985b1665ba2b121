"""Mini-Cypher interpreter over the in-memory property graph.

Covers the Cypher surface the RCA pipeline actually emits — both the
hand-written queries and the shapes the LLM/deterministic compiler generate
(reference query inventory, SURVEY §2 #3,#4,#6,#10,#11):

- multiple MATCH clauses with shared bindings, comma-separated patterns,
  path assignment ``p = (a)-[*1..3]->(b)``, variable-length and undirected
  relationships, label constraints on nodes and types on relationships;
- WHERE with comparisons, CONTAINS, IN, IS [NOT] NULL, AND/OR/NOT, parens,
  list literals, parameters ($x), property access, list slicing
  ``nodes(path)[1..-1]``, and the quantifiers all/any/single/none
  ``(x IN list WHERE pred)``;
- WITH projection with LIMIT (``WITH evt LIMIT 1``);
- RETURN [DISTINCT] items [AS alias] [ORDER BY ...] [LIMIT n].

Result rows come back as store.Record with the neo4j access styles.
Keywords are case-insensitive (the reference mixes ``MATCH``/``match``,
``CONTAINS``/``contains``); identifiers and labels are case-sensitive
(``Event`` entity vs ``EVENT`` state labels are distinct — reference data
model, SURVEY §1).

Relationship uniqueness follows Cypher trail semantics: a relationship
instance is used at most once per pattern match (this is what makes the
reference's ``*1..3`` ladder terminate on cyclic metagraphs).

Errors raise CypherSyntaxError so the pipeline's retry-with-feedback loop
(test_all.py:109-115) sees the same exception category the neo4j driver
would raise.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from k8s_llm_rca_tpu_torch.graph.store import Graph, Node, Path, Record, Relationship


class CypherSyntaxError(ValueError):
    """Mirror of neo4j.exceptions.CypherSyntaxError for the retry loops."""


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*)
  | (?P<string>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<number>\d+(?:\.\d+)?)
  | (?P<param>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><>|<=|>=|<-|->|\.\.|[()\[\]{},;:.\-<>=*+|])
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "match", "where", "with", "return", "limit", "distinct", "and", "or",
    "not", "in", "contains", "as", "order", "by", "is", "null", "asc",
    "desc", "all", "any", "single", "none", "size", "nodes",
    "relationships", "true", "false", "starts", "ends", "optional",
}

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "'": "'", '"': '"', "\\": "\\"}


def _unescape(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


@dataclass
class Token:
    kind: str       # 'string' | 'number' | 'param' | 'name' | 'kw' | 'op' | 'eof'
    value: Any
    pos: int


def tokenize(text: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise CypherSyntaxError(
                f"unexpected character {text[pos]!r} at offset {pos}")
        kind = m.lastgroup
        val = m.group()
        if kind not in ("ws", "comment"):
            if kind == "string":
                tokens.append(Token("string", _unescape(val[1:-1]), pos))
            elif kind == "number":
                num = float(val) if "." in val else int(val)
                tokens.append(Token("number", num, pos))
            elif kind == "param":
                tokens.append(Token("param", val[1:], pos))
            elif kind == "name":
                if val.lower() in _KEYWORDS:
                    tokens.append(Token("kw", val.lower(), pos))
                else:
                    tokens.append(Token("name", val, pos))
            else:
                tokens.append(Token("op", val, pos))
        pos = m.end()
    tokens.append(Token("eof", None, pos))
    return tokens


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

Expr = Callable[["Ctx"], Any]   # compiled expressions are closures over Ctx


@dataclass
class NodePat:
    var: Optional[str]
    label: Optional[str]


@dataclass
class RelPat:
    var: Optional[str]
    type: Optional[str]
    direction: str              # 'out' | 'in' | 'both'
    min_hops: int = 1
    max_hops: int = 1
    var_length: bool = False


@dataclass
class Pattern:
    path_var: Optional[str]
    nodes: List[NodePat]
    rels: List[RelPat]


@dataclass
class MatchClause:
    patterns: List[Pattern]
    where: Optional[Expr]
    refs: set = field(default_factory=set)    # variables read by WHERE


@dataclass
class WithClause:
    items: List[Tuple[str, Expr]]        # (output name, expr)
    limit: Optional[int]
    refs: set = field(default_factory=set)


@dataclass
class ReturnClause:
    items: List[Tuple[str, Expr]]
    distinct: bool
    order_by: List[Tuple[Expr, bool]]    # (expr, descending)
    limit: Optional[int]
    refs: set = field(default_factory=set)


@dataclass
class Ctx:
    row: Dict[str, Any]
    params: Dict[str, Any]


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: List[Token], source: str):
        self.toks = tokens
        self.i = 0
        self.source = source
        self._refs: List[set] = [set()]   # variable-reference scope stack

    # -- token helpers

    def peek(self, offset: int = 0) -> Token:
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def expect_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            raise CypherSyntaxError(
                f"expected {kw.upper()} at offset {self.peek().pos}, "
                f"got {self.peek().value!r}")
        return self.next()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise CypherSyntaxError(
                f"expected {op!r} at offset {self.peek().pos}, "
                f"got {self.peek().value!r}")
        return self.next()

    def expect_name(self) -> str:
        t = self.peek()
        if t.kind != "name":
            raise CypherSyntaxError(
                f"expected identifier at offset {t.pos}, got {t.value!r}")
        return self.next().value

    def expect_int(self) -> int:
        t = self.peek()
        if t.kind != "number" or not isinstance(t.value, int):
            raise CypherSyntaxError(
                f"expected integer literal at offset {t.pos}, "
                f"got {t.value!r}")
        return self.next().value

    def slice_text(self, start_tok: Token, end_tok: Token) -> str:
        return self.source[start_tok.pos:end_tok.pos].strip()

    # -- top level

    def parse(self) -> List[Any]:
        clauses: List[Any] = []
        while not self.peek().kind == "eof":
            if self.at_op(";"):
                self.next()
                continue
            if self.at_kw("optional"):
                raise CypherSyntaxError("OPTIONAL MATCH is not supported")
            if self.at_kw("match"):
                clauses.append(self.parse_match())
            elif self.at_kw("with"):
                clauses.append(self.parse_with())
            elif self.at_kw("return"):
                clauses.append(self.parse_return())
            else:
                raise CypherSyntaxError(
                    f"expected MATCH/WITH/RETURN at offset {self.peek().pos}, "
                    f"got {self.peek().value!r}")
        if not clauses or not isinstance(clauses[-1], ReturnClause):
            raise CypherSyntaxError("query must end with a RETURN clause")
        self._check_scopes(clauses)
        return clauses

    def _check_scopes(self, clauses: List[Any]) -> None:
        """Plan-time variable scoping: undefined names fail even on queries
        that would match zero rows (the neo4j behavior the retry loop needs)."""
        defined: set = set()
        for clause in clauses:
            if isinstance(clause, MatchClause):
                for p in clause.patterns:
                    if p.path_var:
                        defined.add(p.path_var)
                    defined.update(n.var for n in p.nodes if n.var)
                    defined.update(r.var for r in p.rels if r.var)
                missing = clause.refs - defined
            elif isinstance(clause, WithClause):
                missing = clause.refs - defined
                defined = {name for name, _ in clause.items}
            else:
                missing = clause.refs - defined
            if missing:
                raise CypherSyntaxError(
                    f"variable(s) {sorted(missing)} not defined")

    # -- clauses

    def parse_match(self) -> MatchClause:
        self.expect_kw("match")
        patterns = [self.parse_pattern()]
        while self.at_op(","):
            self.next()
            patterns.append(self.parse_pattern())
        where = None
        self._refs.append(set())
        if self.at_kw("where"):
            self.next()
            where = self.parse_expr()
        return MatchClause(patterns, where, refs=self._refs.pop())

    def parse_with(self) -> WithClause:
        self.expect_kw("with")
        self._refs.append(set())
        items = self.parse_items()
        limit = None
        if self.at_kw("limit"):
            self.next()
            limit = self.expect_int()
        return WithClause(items, limit, refs=self._refs.pop())

    def parse_return(self) -> ReturnClause:
        self.expect_kw("return")
        distinct = False
        if self.at_kw("distinct"):
            self.next()
            distinct = True
        self._refs.append(set())
        items = self.parse_items()
        order_by: List[Tuple[Expr, bool]] = []
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.at_kw("asc"):
                    self.next()
                elif self.at_kw("desc"):
                    self.next()
                    desc = True
                order_by.append((e, desc))
                if self.at_op(","):
                    self.next()
                    continue
                break
        limit = None
        if self.at_kw("limit"):
            self.next()
            limit = self.expect_int()
        return ReturnClause(items, distinct, order_by, limit,
                            refs=self._refs.pop())

    def parse_items(self) -> List[Tuple[str, Expr]]:
        items: List[Tuple[str, Expr]] = []
        while True:
            start = self.peek()
            expr = self.parse_expr()
            end = self.peek()
            name = self.slice_text(start, end)
            if self.at_kw("as"):
                self.next()
                name = self.expect_name()
            items.append((name, expr))
            if self.at_op(","):
                self.next()
                continue
            break
        return items

    # -- patterns

    def parse_pattern(self) -> Pattern:
        path_var = None
        if (self.peek().kind == "name" and self.peek(1).kind == "op"
                and self.peek(1).value == "=" and self.peek(2).kind == "op"
                and self.peek(2).value == "("):
            path_var = self.next().value
            self.next()  # '='
        nodes = [self.parse_node_pat()]
        rels: List[RelPat] = []
        while self.at_op("-", "<-"):
            rels.append(self.parse_rel_pat())
            nodes.append(self.parse_node_pat())
        return Pattern(path_var, nodes, rels)

    def parse_node_pat(self) -> NodePat:
        self.expect_op("(")
        var = label = None
        if self.peek().kind == "name":
            var = self.next().value
        if self.at_op(":"):
            self.next()
            label = self.expect_name()
        self.expect_op(")")
        return NodePat(var, label)

    def parse_rel_pat(self) -> RelPat:
        direction = "both"
        if self.at_op("<-"):
            self.next()
            direction = "in"
        else:
            self.expect_op("-")
        var = rtype = None
        min_hops = max_hops = 1
        var_length = False
        if self.at_op("["):
            self.next()
            if self.peek().kind == "name":
                var = self.next().value
            if self.at_op(":"):
                self.next()
                rtype = self.expect_name()
            if self.at_op("*"):
                self.next()
                var_length = True
                min_hops, max_hops = 1, 3
                if self.peek().kind == "number":
                    min_hops = self.expect_int()
                    max_hops = min_hops
                    if self.at_op(".."):
                        self.next()
                        max_hops = self.expect_int()
                elif self.at_op(".."):
                    self.next()
                    max_hops = self.expect_int()
            self.expect_op("]")
        if self.at_op("->"):
            if direction == "in":
                raise CypherSyntaxError("relationship has both directions")
            self.next()
            direction = "out"
        elif self.at_op("-"):
            self.next()
        else:
            raise CypherSyntaxError(
                f"unterminated relationship at offset {self.peek().pos}")
        return RelPat(var, rtype, direction, min_hops, max_hops, var_length)

    # -- expressions

    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.at_kw("or"):
            self.next()
            right = self.parse_and()
            l, r = left, right
            left = lambda ctx, l=l, r=r: bool(l(ctx)) or bool(r(ctx))
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.at_kw("and"):
            self.next()
            right = self.parse_not()
            l, r = left, right
            left = lambda ctx, l=l, r=r: bool(l(ctx)) and bool(r(ctx))
        return left

    def parse_not(self) -> Expr:
        if self.at_kw("not"):
            self.next()
            inner = self.parse_not()
            return lambda ctx, e=inner: not bool(e(ctx))
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        left = self.parse_postfix()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "<>", "<", ">", "<=", ">="):
            op = self.next().value
            right = self.parse_postfix()
            return _compare(op, left, right)
        if self.at_kw("contains"):
            self.next()
            right = self.parse_postfix()
            return lambda ctx, l=left, r=right: (
                isinstance(l(ctx), str) and isinstance(r(ctx), str)
                and r(ctx) in l(ctx))
        if self.at_kw("starts"):
            self.next()
            self.expect_kw("with")
            right = self.parse_postfix()
            return lambda ctx, l=left, r=right: (
                isinstance(l(ctx), str) and isinstance(r(ctx), str)
                and l(ctx).startswith(r(ctx)))
        if self.at_kw("ends"):
            self.next()
            self.expect_kw("with")
            right = self.parse_postfix()
            return lambda ctx, l=left, r=right: (
                isinstance(l(ctx), str) and isinstance(r(ctx), str)
                and l(ctx).endswith(r(ctx)))
        if self.at_kw("in"):
            self.next()
            right = self.parse_postfix()
            def _in(ctx, l=left, r=right):
                lv, rv = l(ctx), r(ctx)
                if rv is None or not isinstance(rv, (list, tuple)):
                    return False
                return lv in rv
            return _in
        if self.at_kw("is"):
            self.next()
            negate = False
            if self.at_kw("not"):
                self.next()
                negate = True
            self.expect_kw("null")
            return lambda ctx, l=left, n=negate: (l(ctx) is not None) if n \
                else (l(ctx) is None)
        return left

    def parse_postfix(self) -> Expr:
        expr = self.parse_primary()
        while True:
            if self.at_op("."):
                self.next()
                key = self.expect_name()
                def _prop(ctx, e=expr, k=key):
                    obj = e(ctx)
                    if obj is None:
                        return None
                    if isinstance(obj, (Node, Relationship)):
                        return obj[k]
                    if isinstance(obj, dict):
                        return obj.get(k)
                    raise CypherSyntaxError(
                        f"cannot access property {k!r} on {type(obj).__name__}")
                expr = _prop
            elif self.at_op("["):
                self.next()
                # index or slice [a..b] where either side optional
                lo = hi = None
                is_slice = False
                if not self.at_op(".."):
                    lo = self.parse_expr()
                if self.at_op(".."):
                    self.next()
                    is_slice = True
                    if not self.at_op("]"):
                        hi = self.parse_expr()
                self.expect_op("]")
                def _index(ctx, e=expr, lo=lo, hi=hi, is_slice=is_slice):
                    seq = e(ctx)
                    if seq is None:
                        return None
                    if is_slice:
                        lov = lo(ctx) if lo is not None else None
                        hiv = hi(ctx) if hi is not None else None
                        return list(seq)[lov:hiv]
                    return seq[lo(ctx)]
                expr = _index
            else:
                return expr

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "string" or t.kind == "number":
            self.next()
            return lambda ctx, v=t.value: v
        if t.kind == "param":
            self.next()
            return lambda ctx, name=t.value: ctx.params.get(name)
        if t.kind == "op" and t.value == "-":       # unary minus (e.g. [1..-1])
            self.next()
            inner = self.parse_primary()
            return lambda ctx, e=inner: -e(ctx)
        if t.kind == "op" and t.value == "(":
            self.next()
            inner = self.parse_expr()
            self.expect_op(")")
            return inner
        if t.kind == "op" and t.value == "[":
            self.next()
            elems: List[Expr] = []
            while not self.at_op("]"):
                elems.append(self.parse_expr())
                if self.at_op(","):
                    self.next()
            self.expect_op("]")
            return lambda ctx, es=tuple(elems): [e(ctx) for e in es]
        if t.kind == "kw":
            if t.value == "null":
                self.next()
                return lambda ctx: None
            if t.value == "true":
                self.next()
                return lambda ctx: True
            if t.value == "false":
                self.next()
                return lambda ctx: False
            if t.value in ("all", "any", "single", "none"):
                return self.parse_quantifier()
            if t.value in ("size", "nodes", "relationships"):
                fn = t.value
                self.next()
                self.expect_op("(")
                arg = self.parse_expr()
                self.expect_op(")")
                return _builtin(fn, arg)
        if t.kind == "name":
            name = self.next().value
            if self.at_op("(") :
                raise CypherSyntaxError(f"unknown function {name!r}")
            self._refs[-1].add(name)
            def _var(ctx, n=name):
                if n not in ctx.row:
                    raise CypherSyntaxError(f"variable {n!r} not defined")
                return ctx.row[n]
            return _var
        raise CypherSyntaxError(
            f"unexpected token {t.value!r} at offset {t.pos}")

    def parse_quantifier(self) -> Expr:
        kind = self.next().value            # all | any | single | none
        self.expect_op("(")
        var = self.expect_name()
        self.expect_kw("in")
        list_expr = self.parse_expr()
        self.expect_kw("where")
        self._refs.append(set())            # quantifier var is locally bound
        pred = self.parse_expr()
        inner_refs = self._refs.pop()
        self._refs[-1].update(inner_refs - {var})
        self.expect_op(")")

        def _quant(ctx, kind=kind, var=var, list_expr=list_expr, pred=pred):
            seq = list_expr(ctx)
            if seq is None:
                return False
            hits = 0
            for item in seq:
                inner = Ctx({**ctx.row, var: item}, ctx.params)
                if bool(pred(inner)):
                    hits += 1
            if kind == "all":
                return hits == len(list(seq))
            if kind == "any":
                return hits >= 1
            if kind == "none":
                return hits == 0
            return hits == 1                 # single
        return _quant


def _compare(op: str, left: Expr, right: Expr) -> Expr:
    def cmp(ctx):
        lv, rv = left(ctx), right(ctx)
        if op == "=":
            return lv == rv if lv is not None and rv is not None else False
        if op == "<>":
            return lv != rv if lv is not None and rv is not None else False
        if lv is None or rv is None:
            return False
        if isinstance(lv, bool) or isinstance(rv, bool):
            return False
        if isinstance(lv, str) != isinstance(rv, str):
            return False                     # mixed-type ordering is null
        if op == "<":
            return lv < rv
        if op == ">":
            return lv > rv
        if op == "<=":
            return lv <= rv
        return lv >= rv
    return cmp


def _builtin(fn: str, arg: Expr) -> Expr:
    def call(ctx):
        v = arg(ctx)
        if v is None:
            return None
        if fn == "size":
            return len(v)
        if fn == "nodes":
            if not isinstance(v, Path):
                raise CypherSyntaxError("nodes() expects a path")
            return list(v.nodes)
        if fn == "relationships":
            if not isinstance(v, Path):
                raise CypherSyntaxError("relationships() expects a path")
            return list(v.relationships)
        raise CypherSyntaxError(f"unknown function {fn!r}")
    return call


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _match_pattern(graph: Graph, pattern: Pattern, row: Dict[str, Any],
                   params: Dict[str, Any]) -> List[Dict[str, Any]]:
    """All extensions of ``row`` that satisfy one pattern (trail semantics)."""
    results: List[Dict[str, Any]] = []

    def node_candidates(pat: NodePat, bound: Dict[str, Any]) -> List[Node]:
        if pat.var is not None and pat.var in bound:
            n = bound[pat.var]
            if not isinstance(n, Node):
                raise CypherSyntaxError(
                    f"variable {pat.var!r} is not a node")
            if pat.label is not None and pat.label not in n.labels:
                return []
            return [n]
        return graph.nodes_with_label(pat.label)

    def bind_node(pat: NodePat, node: Node, bound: Dict[str, Any]
                  ) -> Optional[Dict[str, Any]]:
        if pat.label is not None and pat.label not in node.labels:
            return None
        if pat.var is None:
            return bound
        if pat.var in bound:
            return bound if bound[pat.var] == node else None
        new = dict(bound)
        new[pat.var] = node
        return new

    def rel_steps(node: Node, rel_pat: RelPat):
        """(relationship, neighbor) pairs leaving ``node`` under rel_pat.

        An undirected pattern traverses a SELF-LOOP once, not once per
        orientation (Neo4j/openCypher loop semantics; found by the
        brute-force differential oracle, tests/test_cypher_differential
        .py — the out pass already yielded the loop, so the in pass must
        skip it or every loop row would double)."""
        steps = []
        if rel_pat.direction in ("out", "both"):
            for r in graph.out_rels(node):
                steps.append((r, r.end_node))
        if rel_pat.direction in ("in", "both"):
            for r in graph.in_rels(node):
                if rel_pat.direction == "both" \
                        and r.start_node is r.end_node:
                    continue
                steps.append((r, r.start_node))
        if rel_pat.type is not None:
            steps = [(r, n) for (r, n) in steps if r.type == rel_pat.type]
        return steps

    def extend(i: int, node: Node, bound: Dict[str, Any],
               path_nodes: List[Node], path_rels: List[Relationship],
               used: frozenset) -> None:
        if i == len(pattern.rels):
            final = bound
            if pattern.path_var is not None:
                final = dict(final)
                final[pattern.path_var] = Path(path_nodes, path_rels)
            results.append(final)
            return
        rel_pat = pattern.rels[i]
        next_pat = pattern.nodes[i + 1]
        if not rel_pat.var_length:
            for rel, nbr in rel_steps(node, rel_pat):
                if rel.element_id in used:
                    continue
                nb = bind_node(next_pat, nbr, bound)
                if nb is None:
                    continue
                if rel_pat.var is not None:
                    if rel_pat.var in nb and nb[rel_pat.var] != rel:
                        continue
                    nb = dict(nb)
                    nb[rel_pat.var] = rel
                extend(i + 1, nbr, nb, path_nodes + [nbr], path_rels + [rel],
                       used | {rel.element_id})
        else:
            # enumerate trails of length min..max from ``node``
            def walk(cur: Node, hops: int, trail_nodes: List[Node],
                     trail_rels: List[Relationship], wused: frozenset) -> None:
                if rel_pat.min_hops <= hops:
                    nb = bind_node(next_pat, cur, bound)
                    if nb is not None:
                        if rel_pat.var is not None:
                            nb = dict(nb)
                            nb[rel_pat.var] = list(trail_rels[-hops:] if hops
                                                   else [])
                        extend(i + 1, cur, nb, trail_nodes, trail_rels, wused)
                if hops >= rel_pat.max_hops:
                    return
                for rel, nbr in rel_steps(cur, rel_pat):
                    if rel.element_id in wused:
                        continue
                    walk(nbr, hops + 1, trail_nodes + [nbr],
                         trail_rels + [rel], wused | {rel.element_id})

            walk(node, 0, path_nodes, path_rels, used)

    first = pattern.nodes[0]
    for start in node_candidates(first, row):
        bound = bind_node(first, start, row)
        if bound is None:
            continue
        extend(0, start, bound, [start], [], frozenset())
    return results


def _dedup_key(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_dedup_key(v) for v in value)
    return value


def run_query(graph: Graph, query: str,
              parameters: Optional[Dict[str, Any]] = None) -> List[Record]:
    """Parse + execute; returns a list of Records (eagerly materialized, like
    the reference executor's list(result) — neo4j_query_executor.py:15-24)."""
    params = parameters or {}
    clauses = _Parser(tokenize(query), query).parse()

    rows: List[Dict[str, Any]] = [{}]
    for clause in clauses:
        if isinstance(clause, MatchClause):
            for pattern in clause.patterns:
                new_rows: List[Dict[str, Any]] = []
                for row in rows:
                    new_rows.extend(_match_pattern(graph, pattern, row, params))
                rows = new_rows
            if clause.where is not None:
                rows = [r for r in rows
                        if bool(clause.where(Ctx(r, params)))]
        elif isinstance(clause, WithClause):
            projected = []
            for row in rows:
                ctx = Ctx(row, params)
                projected.append(
                    {name: expr(ctx) for name, expr in clause.items})
            rows = projected
            if clause.limit is not None:
                rows = rows[: clause.limit]
        elif isinstance(clause, ReturnClause):
            records: List[Record] = []
            keys = [name for name, _ in clause.items]
            evaluated: List[Tuple[List[Any], Dict[str, Any]]] = []
            for row in rows:
                ctx = Ctx(row, params)
                evaluated.append(([expr(ctx) for _, expr in clause.items], row))
            if clause.order_by:
                # stable multi-key sort: precompute each key once per row
                for e, desc in reversed(clause.order_by):
                    keyed = []
                    for pair in evaluated:
                        v = e(Ctx(pair[1], params))
                        keyed.append(((v is None, v), pair))
                    keyed.sort(key=lambda kv: kv[0], reverse=desc)
                    evaluated = [pair for _, pair in keyed]
            seen = set()
            for values, _ in evaluated:
                if clause.distinct:
                    key = tuple(_dedup_key(v) for v in values)
                    if key in seen:
                        continue
                    seen.add(key)
                records.append(Record(keys, values))
                if clause.limit is not None and len(records) >= clause.limit:
                    break
            return records
    raise CypherSyntaxError("query must end with RETURN")  # pragma: no cover

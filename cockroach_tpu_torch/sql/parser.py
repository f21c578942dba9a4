"""SQL text -> AST: tokenizer + recursive-descent parser for the SELECT
subset the engine executes (TPC-H shape: implicit/explicit joins, WHERE,
GROUP BY, HAVING, ORDER BY, LIMIT, IN-subqueries, BETWEEN/LIKE/CASE/
EXTRACT/CAST, date + interval literals).

Reference seam: pkg/sql/parser/sql.y (goyacc grammar -> sem/tree ASTs).
The reference monomorphizes a 20K-line grammar; this engine needs only
the analytics subset, so a hand-written recursive-descent parser with
classic precedence climbing replaces yacc. The AST here is deliberately
unresolved (names, literal types stay raw) — binding happens against a
Catalog in sql/bind.py, mirroring the reference's parse -> optbuilder
split (pkg/sql/opt/optbuilder/builder.go:242).

Counterpart of cockroach_tpu/sql/parser.py, copied whole: the tokenizer,
the parser, `parse`, `ParseError` and every AST node, the DDL/DML nodes
included (the read-only session rejects those by type). The messages are
the JAX package's, letter for letter.
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class ParseError(ValueError):
    pass


# ------------------------------------------------------------------ tokens

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+(\.\d+)?([eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op>\|\||<->|<=>|<=|>=|<>|!=|=|<|>|\+|-|\*|/|\(|\)|,|\.|;)
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having",
    "order", "limit", "offset", "as", "and", "or", "not", "in", "between",
    "like", "is", "null", "case", "when", "then", "else", "end", "cast",
    "right", "full", "outer",
    "extract", "date", "interval", "join", "inner", "left", "on", "asc",
    "desc", "exists", "true", "false", "year", "month", "day", "count",
    "sum", "avg", "min", "max", "substring", "union", "all", "over",
    "partition",
}


@dataclass
class Token:
    kind: str  # num | str | name | kw | op | eof
    text: str
    pos: int


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise ParseError(f"unexpected character {sql[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        kind = m.lastgroup
        if kind == "name" and text.lower() in KEYWORDS:
            kind, text = "kw", text.lower()
        out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


# --------------------------------------------------------------------- AST

class Node:
    pass


@dataclass
class ColRef(Node):
    name: str
    qualifier: Optional[str] = None


@dataclass
class Num(Node):
    text: str  # raw; binder decides int vs decimal-scaled

    @property
    def is_float(self):
        return "." in self.text or "e" in self.text.lower()

    @property
    def value(self):
        return float(self.text) if self.is_float else int(self.text)


@dataclass
class Str(Node):
    value: str


@dataclass
class DateLit(Node):
    days: int  # days since unix epoch


@dataclass
class IntervalLit(Node):
    n: int
    unit: str  # day | month | year


@dataclass
class NullLit(Node):
    pass


@dataclass
class BoolLit(Node):
    value: bool


@dataclass
class Unary(Node):
    op: str  # "-" | "not"
    arg: Node


@dataclass
class Binary(Node):
    op: str  # + - * / = <> < <= > >= and or
    left: Node
    right: Node


@dataclass
class Between(Node):
    arg: Node
    lo: Node
    hi: Node
    negate: bool = False


@dataclass
class InListAst(Node):
    arg: Node
    values: List[Node]
    negate: bool = False


@dataclass
class InSubquery(Node):
    arg: Node
    query: "SelectStmt"
    negate: bool = False


@dataclass
class ExistsAst(Node):
    query: "SelectStmt"
    negate: bool = False


@dataclass
class LikeAst(Node):
    arg: Node
    pattern: str
    negate: bool = False


@dataclass
class IsNullAst(Node):
    arg: Node
    negate: bool = False


@dataclass
class FuncCall(Node):
    name: str  # lowercased
    args: List[Node]
    star: bool = False  # count(*)
    distinct: bool = False
    params: Tuple[int, ...] = ()  # substring (start, length)


@dataclass
class WindowCall(Node):
    call: FuncCall
    partition_by: List[Node]
    order_by: List[Tuple[Node, bool]]  # (expr, desc)


@dataclass
class CaseAst(Node):
    whens: List[Tuple[Node, Node]]
    otherwise: Optional[Node] = None


@dataclass
class CastAst(Node):
    arg: Node
    to: str  # type name text


@dataclass
class ExtractAst(Node):
    part: str
    arg: Node


@dataclass
class TableRef(Node):
    name: str
    alias: Optional[str] = None
    how: str = "inner"             # join type joining THIS table
    on: Optional[Node] = None      # outer joins: ON condition (equi)


@dataclass
class ExplainStmt(Node):
    stmt: "SelectStmt"
    analyze: bool = False
    debug: bool = False  # EXPLAIN ANALYZE (DEBUG): statement bundle


@dataclass
class ColumnDef(Node):
    name: str
    type_name: str  # normalized: int|decimal(s)|float|date|string
    primary_key: bool = False
    not_null: bool = False


@dataclass
class CreateTable(Node):
    name: str
    columns: List[ColumnDef] = field(default_factory=list)
    if_not_exists: bool = False


@dataclass
class DropTable(Node):
    name: str
    if_exists: bool = False


@dataclass
class CreateIndex(Node):
    name: str
    table: str
    column: str


@dataclass
class AlterTable(Node):
    """ALTER TABLE <t> ADD [COLUMN] c <type> | DROP [COLUMN] c."""

    table: str
    op: str                # "add" | "drop"
    column: str
    type_name: Optional[str] = None  # add only


@dataclass
class AnalyzeStmt(Node):
    table: str


@dataclass
class Insert(Node):
    table: str
    columns: Optional[List[str]]
    rows: List[List[Node]] = field(default_factory=list)
    upsert: bool = False  # UPSERT INTO: same-pk rows overwrite


@dataclass
class Update(Node):
    table: str
    sets: List[Tuple[str, Node]] = field(default_factory=list)
    where: Optional[Node] = None


@dataclass
class Delete(Node):
    table: str
    where: Optional[Node] = None


@dataclass
class CreateChangefeed(Node):
    """CREATE CHANGEFEED FOR TABLE t [WITH opt[=val], ...]."""

    table: str
    options: dict = field(default_factory=dict)


@dataclass
class StreamChangefeed(Node):
    """EXPERIMENTAL CHANGEFEED FOR t [WITH ...]: rows stream over the
    open pgwire portal instead of running as a job."""

    table: str
    options: dict = field(default_factory=dict)


@dataclass
class CreateMatView(Node):
    name: str
    query: "SelectStmt"
    sql: str  # the SELECT body text, persisted with the definition
    if_not_exists: bool = False


@dataclass
class DropMatView(Node):
    name: str
    if_exists: bool = False


@dataclass
class RefreshMatView(Node):
    name: str


@dataclass
class JobControl(Node):
    op: str  # cancel | pause | resume
    job_id: int


@dataclass
class CancelQuery(Node):
    """CANCEL QUERY <id>: route a cancel to the owning statement's
    CancelContext through the process-wide query registry — works
    cross-session (the id came from SHOW QUERIES / cluster_queries)."""

    query_id: int


@dataclass
class ShowStmt(Node):
    """SHOW QUERIES | SESSIONS | JOBS — sugar over the crdb_internal
    virtual-table providers."""

    kind: str  # queries | sessions | jobs


@dataclass
class TxnControl(Node):
    op: str  # begin | commit | rollback


@dataclass
class SetVar(Node):
    name: str
    value: object


@dataclass
class ShowVar(Node):
    name: str


@dataclass
class SelectStmt(Node):
    items: List[Tuple[Node, Optional[str]]] = field(default_factory=list)
    distinct: bool = False
    tables: List[TableRef] = field(default_factory=list)
    where: Optional[Node] = None  # includes ON conditions, conjoined
    group_by: List[Node] = field(default_factory=list)
    having: Optional[Node] = None
    order_by: List[Tuple[Node, bool]] = field(default_factory=list)  # desc?
    limit: Optional[int] = None
    offset: int = 0


# ------------------------------------------------------------------ parser

class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ----------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (text is None or t.text == text):
            return self.next()
        return None

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.accept(kind, text)
        if t is None:
            got = self.peek()
            raise ParseError(
                f"expected {text or kind}, got {got.text!r} at {got.pos}")
        return t

    def accept_kw(self, *words: str) -> Optional[Token]:
        t = self.peek()
        if t.kind == "kw" and t.text in words:
            return self.next()
        return None

    def expect_kw(self, word: str) -> Token:
        t = self.accept_kw(word)
        if t is None:
            got = self.peek()
            raise ParseError(
                f"expected {word.upper()}, got {got.text!r} at {got.pos}")
        return t

    # -- entry ------------------------------------------------------------
    def parse(self) -> Node:
        stmt = self._parse_statement()
        self.accept("op", ";")
        if self.peek().kind != "eof":
            t = self.peek()
            raise ParseError(f"trailing input {t.text!r} at {t.pos}")
        return stmt

    def _parse_statement(self) -> Node:
        t = self.peek()
        word = t.text.lower() if t.kind in ("name", "kw") else ""
        if word == "explain":
            self.next()
            analyze = False
            debug = False
            t2 = self.peek()
            if t2.kind == "name" and t2.text.lower() == "analyze":
                self.next()
                analyze = True
                # EXPLAIN ANALYZE (DEBUG): also write a statement
                # bundle (the reference's support-bundle-per-statement)
                if self.accept("op", "("):
                    if self._name().lower() != "debug":
                        raise ParseError(
                            "expected DEBUG in EXPLAIN ANALYZE (...)")
                    self.expect("op", ")")
                    debug = True
            return ExplainStmt(self.parse_select(), analyze, debug)
        if word == "analyze":
            self.next()
            return AnalyzeStmt(self._name())
        if word == "create":
            return self._parse_create()
        if word == "experimental":
            self.next()
            if self._name().lower() != "changefeed":
                raise ParseError("expected CHANGEFEED after EXPERIMENTAL")
            if self._name().lower() != "for":
                raise ParseError("expected FOR")
            if self.peek().kind == "name" \
                    and self.peek().text.lower() == "table":
                self.next()
            return StreamChangefeed(self._name(),
                                    self._parse_with_options())
        if word == "refresh":
            self.next()
            if self._name().lower() != "materialized":
                raise ParseError("expected MATERIALIZED VIEW")
            if self._name().lower() != "view":
                raise ParseError("expected MATERIALIZED VIEW")
            return RefreshMatView(self._name())
        if word in ("cancel", "pause", "resume") \
                and self.peek(1).kind == "name" \
                and self.peek(1).text.lower() == "job":
            self.next()
            self.next()
            return JobControl(word, int(self.expect("num").text))
        if word == "cancel" and self.peek(1).kind == "name" \
                and self.peek(1).text.lower() == "query":
            self.next()
            self.next()
            return CancelQuery(int(self.expect("num").text))
        if word == "alter":
            return self._parse_alter()
        if word == "drop":
            return self._parse_drop()
        if word == "insert":
            return self._parse_insert()
        if word == "upsert":
            return self._parse_insert(upsert=True)
        if word == "update":
            return self._parse_update()
        if word == "delete":
            return self._parse_delete()
        if word == "set":
            return self._parse_set()
        if word == "show":
            self.next()
            name = self._name().lower()
            if name in ("queries", "sessions", "jobs"):
                return ShowStmt(name)
            return ShowVar(name)
        if word in ("begin", "commit", "rollback", "abort", "start"):
            self.next()
            if word == "start":  # START TRANSACTION
                if self._name().lower() != "transaction":
                    raise ParseError("expected TRANSACTION after START")
                word = "begin"
            elif self.peek().kind == "name" and \
                    self.peek().text.lower() in ("transaction", "work"):
                self.next()  # optional suffix on any txn control
            return TxnControl("rollback" if word == "abort" else word)
        return self.parse_select()

    def _name(self) -> str:
        t = self.next()
        if t.kind not in ("name", "kw"):
            raise ParseError(f"expected identifier, got {t.text!r} "
                             f"at {t.pos}")
        return t.text

    def _parse_create(self):
        self.next()  # create
        kind = self._name().lower()
        if kind == "index":
            # CREATE INDEX name ON table (column)
            name = self._name()
            if self._name().lower() != "on":
                raise ParseError("expected ON")
            table = self._name()
            self.expect("op", "(")
            column = self._name()
            self.expect("op", ")")
            return CreateIndex(name, table, column)
        if kind == "changefeed":
            # CREATE CHANGEFEED FOR TABLE t [WITH opt[=val], ...]
            if self._name().lower() != "for":
                raise ParseError("expected FOR")
            if self.peek().kind == "name" \
                    and self.peek().text.lower() == "table":
                self.next()
            return CreateChangefeed(self._name(),
                                    self._parse_with_options())
        if kind == "materialized":
            # CREATE MATERIALIZED VIEW v AS SELECT ...
            if self._name().lower() != "view":
                raise ParseError("expected VIEW after MATERIALIZED")
            if_not_exists = False
            if self.peek().kind == "name" \
                    and self.peek().text.lower() == "if":
                self.next()
                self.expect_kw("not")
                if self._name().lower() != "exists":
                    raise ParseError("expected EXISTS")
                if_not_exists = True
            name = self._name()
            self.expect_kw("as")
            body_pos = self.peek().pos
            query = self.parse_select()
            body = self.sql[body_pos:].rstrip().rstrip(";").rstrip()
            return CreateMatView(name, query, body, if_not_exists)
        if kind != "table":
            raise ParseError("only CREATE TABLE / CREATE INDEX / "
                             "CREATE CHANGEFEED / CREATE MATERIALIZED "
                             "VIEW supported")
        if_not_exists = False
        if self.peek().kind == "name" and self.peek().text.lower() == "if":
            self.next()
            self.expect_kw("not")
            if self._name().lower() != "exists":
                raise ParseError("expected EXISTS")
            if_not_exists = True
        name = self._name()
        self.expect("op", "(")
        cols: List[ColumnDef] = []
        while True:
            cname = self._name()
            ty = self._type_name()
            pk = False
            not_null = False
            while True:
                if self.peek().kind == "name" \
                        and self.peek().text.lower() == "primary":
                    self.next()
                    if self._name().lower() != "key":
                        raise ParseError("expected KEY after PRIMARY")
                    pk = True
                elif self.accept_kw("not"):
                    self.expect_kw("null")
                    not_null = True
                else:
                    break
            cols.append(ColumnDef(cname, ty, pk, not_null))
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        return CreateTable(name, cols, if_not_exists)

    def _type_name(self) -> str:
        base = self._name().lower()
        if base in ("int", "integer", "bigint", "smallint", "int8",
                    "int4"):
            return "int"
        if base in ("float", "double", "real", "float8", "float4"):
            return "float"
        if base == "date":
            return "date"
        if base in ("text", "string", "varchar", "char"):
            if self.accept("op", "("):
                self.expect("num")
                self.expect("op", ")")
            return "string"
        if base in ("decimal", "numeric"):
            scale = 2
            if self.accept("op", "("):
                self.expect("num")
                if self.accept("op", ","):
                    scale = int(self.expect("num").text)
                self.expect("op", ")")
            return f"decimal({scale})"
        if base in ("bool", "boolean"):
            return "bool"
        if base == "vector":
            # VECTOR(d): the dimension is part of the type (pgvector)
            self.expect("op", "(")
            dim = int(self.expect("num").text)
            self.expect("op", ")")
            if dim < 1:
                raise ParseError("vector dimension must be >= 1")
            return f"vector({dim})"
        raise ParseError(f"unsupported column type {base!r}")

    def _parse_alter(self) -> "AlterTable":
        self.next()  # alter
        if self._name().lower() != "table":
            raise ParseError("only ALTER TABLE is supported")
        table = self._name()
        op = self._name().lower()
        if op not in ("add", "drop"):
            raise ParseError("expected ADD or DROP")
        nxt = self.peek()
        if nxt.kind == "name" and nxt.text.lower() == "column":
            self.next()
        col = self._name()
        if op == "add":
            return AlterTable(table, "add", col, self._type_name())
        return AlterTable(table, "drop", col)

    def _parse_drop(self):
        self.next()
        kind = self._name().lower()
        matview = False
        if kind == "materialized":
            if self._name().lower() != "view":
                raise ParseError("expected VIEW after MATERIALIZED")
            matview = True
        elif kind != "table":
            raise ParseError(
                "only DROP TABLE / DROP MATERIALIZED VIEW supported")
        if_exists = False
        if self.peek().kind == "name" and self.peek().text.lower() == "if":
            self.next()
            if self._name().lower() != "exists":
                raise ParseError("expected EXISTS")
            if_exists = True
        name = self._name()
        if matview:
            return DropMatView(name, if_exists)
        return DropTable(name, if_exists)

    def _parse_with_options(self) -> dict:
        """[WITH key[=value] (, ...)] -> options dict; a bare key means
        boolean True (the reference's `WITH resolved` form)."""
        opts: dict = {}
        if not (self.peek().kind == "name"
                and self.peek().text.lower() == "with"):
            return opts
        self.next()
        while True:
            key = self._name().lower()
            val: object = True
            if self.accept("op", "="):
                t = self.next()
                if t.kind == "num":
                    val = float(t.text) if "." in t.text else int(t.text)
                elif t.kind == "str":
                    val = t.text[1:-1].replace("''", "'")
                elif t.kind in ("name", "kw"):
                    low = t.text.lower()
                    val = {"true": True, "false": False}.get(low, t.text)
                else:
                    raise ParseError(
                        f"bad option value {t.text!r} at {t.pos}")
            opts[key] = val
            if not self.accept("op", ","):
                break
        return opts

    def _parse_insert(self, upsert: bool = False) -> Insert:
        self.next()
        if self._name().lower() != "into":
            raise ParseError("expected INTO")
        table = self._name()
        columns = None
        if self.accept("op", "("):
            columns = [self._name()]
            while self.accept("op", ","):
                columns.append(self._name())
            self.expect("op", ")")
        if self._name().lower() != "values":
            raise ParseError("expected VALUES")
        rows = []
        while True:
            self.expect("op", "(")
            row = [self.expr()]
            while self.accept("op", ","):
                row.append(self.expr())
            self.expect("op", ")")
            rows.append(row)
            if not self.accept("op", ","):
                break
        return Insert(table, columns, rows, upsert=upsert)

    def _parse_update(self) -> Update:
        self.next()
        table = self._name()
        if self._name().lower() != "set":
            raise ParseError("expected SET")
        sets = []
        while True:
            col = self._name()
            self.expect("op", "=")
            sets.append((col, self.expr()))
            if not self.accept("op", ","):
                break
        where = self.expr() if self.accept_kw("where") else None
        return Update(table, sets, where)

    def _parse_delete(self) -> Delete:
        self.next()
        if self._name().lower() != "from":
            raise ParseError("expected FROM")
        table = self._name()
        where = self.expr() if self.accept_kw("where") else None
        return Delete(table, where)

    def _parse_set(self) -> SetVar:
        self.next()
        name = self._name().lower()
        self.expect("op", "=")
        t = self.next()
        if t.kind == "num":
            value: object = (float(t.text) if "." in t.text
                             else int(t.text))
        elif t.kind == "str":
            value = t.text[1:-1].replace("''", "'")
        else:
            value = t.text.lower()
        return SetVar(name, value)

    def parse_select(self) -> SelectStmt:
        self.expect_kw("select")
        stmt = SelectStmt()
        stmt.distinct = bool(self.accept_kw("distinct"))
        if self.peek().kind == "op" and self.peek().text == "*":
            # SELECT * — a bare star item (binding resolves or rejects
            # it; today only materialized-view reads accept it)
            self.next()
            stmt.items.append((ColRef("*"), None))
            self.expect_kw("from")
            self._table_refs(stmt)
            if self.accept_kw("where"):
                stmt.where = self._conjoin(stmt.where, self.expr())
            if self.accept_kw("limit"):
                stmt.limit = int(self.expect("num").text)
            return stmt
        while True:
            e = self.expr()
            alias = None
            if self.accept_kw("as"):
                alias = self.expect("name").text
            elif self.peek().kind == "name":
                alias = self.next().text
            stmt.items.append((e, alias))
            if not self.accept("op", ","):
                break
        self.expect_kw("from")
        self._table_refs(stmt)
        if self.accept_kw("where"):
            stmt.where = self._conjoin(stmt.where, self.expr())
        if self.accept_kw("group"):
            self.expect_kw("by")
            while True:
                stmt.group_by.append(self.expr())
                if not self.accept("op", ","):
                    break
        if self.accept_kw("having"):
            stmt.having = self.expr()
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.expr()
                desc = False
                if self.accept_kw("desc"):
                    desc = True
                elif self.accept_kw("asc"):
                    pass
                stmt.order_by.append((e, desc))
                if not self.accept("op", ","):
                    break
        if self.accept_kw("limit"):
            stmt.limit = int(self.expect("num").text)
        if self.accept_kw("offset"):
            stmt.offset = int(self.expect("num").text)
        return stmt

    def _table_refs(self, stmt: SelectStmt):
        stmt.tables.append(self._one_table())
        while True:
            if self.accept("op", ","):
                stmt.tables.append(self._one_table())
                continue
            how = None
            if self.accept_kw("left"):
                how = "left"
            elif self.accept_kw("right"):
                how = "right"
            elif self.accept_kw("full"):
                how = "outer"
            if how is not None:
                self.accept_kw("outer")
                self.expect_kw("join")
            elif self.accept_kw("inner"):
                self.expect_kw("join")
                how = "inner"
            elif self.accept_kw("join"):
                how = "inner"
            else:
                break
            t = self._one_table()
            self.expect_kw("on")
            cond = self.expr()
            if how == "inner":
                # inner ON folds into WHERE (reorderable)
                stmt.where = self._conjoin(stmt.where, cond)
            else:
                t.how = how
                t.on = cond
            stmt.tables.append(t)

    def _one_table(self) -> TableRef:
        # schema-qualified names (crdb_internal.cluster_queries) fold
        # into one dotted table name; the binder/catalog treat the
        # dotted string as the table's full name
        name = self.expect("name").text
        while self.accept("op", "."):
            name += "." + self.expect("name").text
        alias = None
        if self.accept_kw("as"):
            alias = self.expect("name").text
        elif self.peek().kind == "name":
            alias = self.next().text
        return TableRef(name, alias)

    @staticmethod
    def _conjoin(a: Optional[Node], b: Node) -> Node:
        return b if a is None else Binary("and", a, b)

    # -- expressions (precedence climbing) --------------------------------
    def expr(self) -> Node:
        return self.or_expr()

    def or_expr(self) -> Node:
        e = self.and_expr()
        while self.accept_kw("or"):
            e = Binary("or", e, self.and_expr())
        return e

    def and_expr(self) -> Node:
        e = self.not_expr()
        while self.accept_kw("and"):
            e = Binary("and", e, self.not_expr())
        return e

    def not_expr(self) -> Node:
        if self.accept_kw("not"):
            return Unary("not", self.not_expr())
        return self.comparison()

    def comparison(self) -> Node:
        e = self.additive()
        negate = bool(self.accept_kw("not"))
        if self.accept_kw("between"):
            lo = self.additive()
            self.expect_kw("and")
            hi = self.additive()
            return Between(e, lo, hi, negate)
        if self.accept_kw("in"):
            self.expect("op", "(")
            if self.peek().kind == "kw" and self.peek().text == "select":
                q = self.parse_select()
                self.expect("op", ")")
                return InSubquery(e, q, negate)
            values = [self.additive()]
            while self.accept("op", ","):
                values.append(self.additive())
            self.expect("op", ")")
            return InListAst(e, values, negate)
        if self.accept_kw("like"):
            pat = self.expect("str").text
            return LikeAst(e, pat[1:-1].replace("''", "'"), negate)
        if negate:
            raise ParseError(
                f"expected BETWEEN/IN/LIKE after NOT at {self.peek().pos}")
        if self.accept_kw("is"):
            neg = bool(self.accept_kw("not"))
            self.expect_kw("null")
            return IsNullAst(e, neg)
        t = self.peek()
        if t.kind == "op" and t.text in ("=", "<>", "!=", "<", "<=", ">",
                                         ">="):
            self.next()
            return Binary(t.text, e, self.additive())
        return e

    def additive(self) -> Node:
        e = self.multiplicative()
        while True:
            t = self.peek()
            # <-> / <=> (vector distances) sit at additive precedence so
            # `emb <-> '[..]' < 0.5` parses as `(emb <-> '[..]') < 0.5`
            if t.kind == "op" and t.text in ("+", "-", "||", "<->", "<=>"):
                self.next()
                e = Binary(t.text, e, self.multiplicative())
            else:
                return e

    def multiplicative(self) -> Node:
        e = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("*", "/"):
                self.next()
                e = Binary(t.text, e, self.unary())
            else:
                return e

    def unary(self) -> Node:
        if self.accept("op", "-"):
            return Unary("-", self.unary())
        if self.accept("op", "+"):
            return self.unary()
        return self.primary()

    def primary(self) -> Node:
        t = self.peek()
        if t.kind == "num":
            self.next()
            return Num(t.text)
        if t.kind == "str":
            self.next()
            return Str(t.text[1:-1].replace("''", "'"))
        if t.kind == "op" and t.text == "(":
            self.next()
            e = self.expr()
            self.expect("op", ")")
            return e
        if t.kind == "kw":
            return self._keyword_primary(t)
        if t.kind == "name":
            self.next()
            if self.accept("op", "."):
                col = self.next()  # name or keyword used as a column
                return ColRef(col.text, qualifier=t.text)
            if self.peek().kind == "op" and self.peek().text == "(":
                return self._maybe_over(self._call(t.text.lower()))
            return ColRef(t.text)
        raise ParseError(f"unexpected {t.text!r} at {t.pos}")

    def _maybe_over(self, call: "FuncCall") -> Node:
        if not self.accept_kw("over"):
            return call
        self.expect("op", "(")
        partition: List[Node] = []
        order: List[Tuple[Node, bool]] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.expr())
            while self.accept("op", ","):
                partition.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.expr()
                desc = False
                if self.accept_kw("desc"):
                    desc = True
                elif self.accept_kw("asc"):
                    pass
                order.append((e, desc))
                if not self.accept("op", ","):
                    break
        self.expect("op", ")")
        return WindowCall(call, partition, order)

    def _keyword_primary(self, t: Token) -> Node:
        if t.text in ("sum", "avg", "min", "max", "count"):
            self.next()
            return self._maybe_over(self._call(t.text))
        if t.text == "substring":
            # substring(s, start, len) | substring(s from a for b)
            self.next()
            self.expect("op", "(")
            arg = self.expr()
            if self.peek().kind == "name" \
                    and self.peek().text.lower() == "from":
                self.next()
                start = int(self.expect("num").text)
                ln = 1 << 30
                if self.peek().kind == "name" \
                        and self.peek().text.lower() == "for":
                    self.next()
                    ln = int(self.expect("num").text)
            else:
                self.expect("op", ",")
                start = int(self.expect("num").text)
                ln = 1 << 30
                if self.accept("op", ","):
                    ln = int(self.expect("num").text)
            self.expect("op", ")")
            return FuncCall("substring", [arg],
                            params=(start, ln))
        if t.text == "null":
            self.next()
            return NullLit()
        if t.text in ("true", "false"):
            self.next()
            return BoolLit(t.text == "true")
        if t.text == "date":
            self.next()
            s = self.expect("str").text[1:-1]
            d = datetime.date.fromisoformat(s)
            return DateLit((d - datetime.date(1970, 1, 1)).days)
        if t.text == "interval":
            self.next()
            s = self.expect("str").text[1:-1]
            unit_tok = self.next()
            unit = unit_tok.text.lower().rstrip("s")
            if unit not in ("day", "month", "year"):
                raise ParseError(f"unsupported interval unit {unit!r}")
            return IntervalLit(int(s), unit)
        if t.text == "case":
            self.next()
            whens = []
            while self.accept_kw("when"):
                cond = self.expr()
                self.expect_kw("then")
                whens.append((cond, self.expr()))
            otherwise = self.expr() if self.accept_kw("else") else None
            self.expect_kw("end")
            return CaseAst(whens, otherwise)
        if t.text == "cast":
            self.next()
            self.expect("op", "(")
            e = self.expr()
            self.expect_kw("as")
            ty = self.next().text
            # allow e.g. decimal(12,2)
            if self.accept("op", "("):
                args = [self.expect("num").text]
                while self.accept("op", ","):
                    args.append(self.expect("num").text)
                self.expect("op", ")")
                ty += "(" + ",".join(args) + ")"
            self.expect("op", ")")
            return CastAst(e, ty.lower())
        if t.text == "extract":
            self.next()
            self.expect("op", "(")
            part = self.next().text.lower()
            self.expect_kw("from")
            e = self.expr()
            self.expect("op", ")")
            return ExtractAst(part, e)
        if t.text == "exists":
            self.next()
            self.expect("op", "(")
            q = self.parse_select()
            self.expect("op", ")")
            return ExistsAst(q)
        raise ParseError(f"unexpected keyword {t.text!r} at {t.pos}")

    def _call(self, name: str) -> FuncCall:
        self.expect("op", "(")
        if name == "count" and self.accept("op", "*"):
            self.expect("op", ")")
            return FuncCall("count", [], star=True)
        distinct = bool(self.accept_kw("distinct"))
        args = []
        if not self.accept("op", ")"):
            args.append(self.expr())
            while self.accept("op", ","):
                args.append(self.expr())
            self.expect("op", ")")
        return FuncCall(name, args, distinct=distinct)


def parse(sql: str) -> SelectStmt:
    """Parse one SELECT statement."""
    return Parser(sql).parse()

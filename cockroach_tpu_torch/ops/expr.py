"""Scalar expression IR and its evaluation over a Batch — filter and
projection.

Counterpart of cockroach_tpu/ops/expr.py, for the nodes Col, Lit, BinOp,
Cmp, BoolOp, Not, IsNull, Case, Cast, InList, Like, Extract and
ScalarFunc. Semantics follow SQL:
- three-valued logic: any NULL operand of arithmetic/comparison yields
  NULL; AND/OR are Kleene;
- a filter keeps rows whose predicate is TRUE (NULL drops);
- decimals are int64 scaled by 10^scale: +/- align scales, * adds scales
  (int64 products wrap), / produces float32;
- strings are dictionary codes; predicates against literals (=, <, IN,
  LIKE) are resolved host-side through the schema's dictionary into
  literal codes or a boolean table indexed by code;
- dates are int32 days since the epoch; EXTRACT runs the civil-calendar
  integer algorithm on the device.

The results equal the JAX package's compiled (jit) programs on the CPU
bit for bit, which differ from PyTorch's eager arithmetic in four places
the port makes explicit:
- XLA's float -> integer conversion saturates (NaN -> 0, +-inf and
  out-of-range values -> the integer type's bounds); PyTorch leaves those
  inputs undefined (INT_MIN for all of them on the CPU), so the port
  clamps explicitly (_to_dtype);
- XLA's compiled float arithmetic treats subnormal float32 operands as
  zero and flushes subnormal results to zero (_ftz), except where its
  algebraic simplifier removes the operation: an add or subtract of a
  constant zero, a multiply or divide by a constant 1 or -1, a divide by
  a constant zero (whose NULL lanes divide by 1) and -0.0 - x leave the
  other operand's bits as they are, or negated (_xla_fold);
- XLA's CPU backend divides by a constant as a multiply by its float32
  reciprocal (a subnormal divisor tested for zero unflushed), merges
  chains of constant multipliers, and contracts a product that feeds an
  add or subtract into one fused multiply-add, rounded once (_fma);
- `//` is floor division and `mod` truncates (lax.rem), as in the JAX
  package.

StrFunc is not evaluated here, as in the JAX package: a computed string
is a new string that the row engine mints on the host (exec/rowexec.py
eval_datum), and the planner sends every projection that computes one
there. VecLit broadcasts its query vector to (capacity, d), and
VecDistance evaluates ops/vector.py's `l2_distance`/`cosine_distance`
rowwise, the functions the searchers use, so the exact SQL path and
the searchers agree bit for bit.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import (
    BOOL, DATE, DECIMAL, FLOAT, INT, STRING, Batch, ColType, Column, Kind,
    Schema,
)

# where each JAX expression node that is not ported yet is queued
_NOT_PORTED = "not ported yet (ROADMAP.md queue 1)"


class Expr:
    """Base class. Subclasses are frozen dataclasses."""

    def type(self, schema: Schema) -> ColType:
        raise NotImplementedError

    # sugar
    def __add__(self, o): return BinOp("+", self, _lit(o))
    def __sub__(self, o): return BinOp("-", self, _lit(o))
    def __mul__(self, o): return BinOp("*", self, _lit(o))
    def __truediv__(self, o): return BinOp("/", self, _lit(o))
    def __rsub__(self, o): return BinOp("-", _lit(o), self)
    def __radd__(self, o): return BinOp("+", _lit(o), self)
    def __rmul__(self, o): return BinOp("*", _lit(o), self)
    def __eq__(self, o): return Cmp("==", self, _lit(o))  # type: ignore
    def __ne__(self, o): return Cmp("!=", self, _lit(o))  # type: ignore
    def __lt__(self, o): return Cmp("<", self, _lit(o))
    def __le__(self, o): return Cmp("<=", self, _lit(o))
    def __gt__(self, o): return Cmp(">", self, _lit(o))
    def __ge__(self, o): return Cmp(">=", self, _lit(o))
    def __and__(self, o): return BoolOp("and", (self, _lit(o)))
    def __or__(self, o): return BoolOp("or", (self, _lit(o)))
    def __invert__(self): return Not(self)
    # defining __eq__ would otherwise null out hashability
    __hash__ = object.__hash__


def _lit(v):
    return v if isinstance(v, Expr) else Lit(v)


@dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def type(self, schema):
        return schema.field(self.name).type


@dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: object
    ty: Optional[ColType] = None

    def type(self, schema):
        if self.ty is not None:
            return self.ty
        v = self.value
        if isinstance(v, bool):
            return BOOL
        if isinstance(v, int):
            return INT
        if isinstance(v, float):
            return FLOAT
        if isinstance(v, str):
            return STRING
        raise TypeError(f"cannot type literal {v!r}")


@dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str  # + - * /
    left: Expr
    right: Expr

    def type(self, schema):
        lt, rt = self.left.type(schema), self.right.type(schema)
        if lt.kind is Kind.DECIMAL or rt.kind is Kind.DECIMAL:
            ls = lt.scale if lt.kind is Kind.DECIMAL else 0
            rs = rt.scale if rt.kind is Kind.DECIMAL else 0
            if self.op in ("+", "-"):
                return DECIMAL(max(ls, rs))
            if self.op == "*":
                return DECIMAL(ls + rs)
            return FLOAT  # division
        if lt.kind is Kind.FLOAT or rt.kind is Kind.FLOAT or self.op == "/":
            return FLOAT
        if lt.kind is Kind.DATE and rt.kind is Kind.INT:
            return DATE  # date +/- days
        return INT


@dataclass(frozen=True, eq=False)
class Cmp(Expr):
    op: str  # == != < <= > >=
    left: Expr
    right: Expr

    def type(self, schema):
        return BOOL


@dataclass(frozen=True, eq=False)
class BoolOp(Expr):
    op: str  # and / or
    args: Tuple[Expr, ...]

    def type(self, schema):
        return BOOL


@dataclass(frozen=True, eq=False)
class Not(Expr):
    arg: Expr

    def type(self, schema):
        return BOOL


@dataclass(frozen=True, eq=False)
class IsNull(Expr):
    arg: Expr
    negate: bool = False

    def type(self, schema):
        return BOOL


@dataclass(frozen=True, eq=False)
class Case(Expr):
    whens: Tuple[Tuple[Expr, Expr], ...]
    otherwise: Optional[Expr] = None

    def type(self, schema):
        return self.whens[0][1].type(schema)


@dataclass(frozen=True, eq=False)
class Cast(Expr):
    arg: Expr
    to: ColType

    def type(self, schema):
        return self.to


@dataclass(frozen=True, eq=False)
class InList(Expr):
    arg: Expr
    values: Tuple[object, ...]

    def type(self, schema):
        return BOOL


@dataclass(frozen=True, eq=False)
class Like(Expr):
    """SQL LIKE over a dictionary-encoded string column (%/_ wildcards).
    Resolved host-side: pattern -> bool table over the dictionary."""

    arg: Expr  # must be a STRING Col
    pattern: str
    negate: bool = False

    def type(self, schema):
        return BOOL


@dataclass(frozen=True, eq=False)
class Extract(Expr):
    part: str  # "year" | "month" | "day"
    arg: Expr

    def type(self, schema):
        return INT


@dataclass(frozen=True, eq=False)
class VecLit(Expr):
    """Constant query vector, broadcast to every lane."""

    values: Tuple[float, ...]

    def type(self, schema):
        return ColType(Kind.VECTOR, len(self.values))


@dataclass(frozen=True, eq=False)
class VecDistance(Expr):
    """`<->` (Euclidean) / `<=>` (cosine distance) between a VECTOR
    column and a query vector (VecLit or another VECTOR column)."""

    metric: str  # "l2" | "cos"
    left: Expr
    right: Expr

    def type(self, schema):
        return FLOAT


@dataclass(frozen=True, eq=False)
class ScalarFunc(Expr):
    """Device-evaluable scalar builtins: abs, mod, sign, floor, ceil,
    coalesce, nullif, greatest, least, length (string dictionary lookup,
    table resolved at bind time)."""

    func: str
    args: Tuple[Expr, ...]
    # length(): host-resolved per-code lengths of the column dictionary
    table: Optional[Tuple[int, ...]] = None

    def type(self, schema):
        if self.func in ("length", "sign", "floor", "ceil"):
            return INT
        # the first argument's type
        return self.args[0].type(schema) if self.args else INT


@dataclass(frozen=True, eq=False)
class StrFunc(Expr):
    """Computed string expression: upper/lower/substring/concat,
    evaluated by the row engine only (exec/rowexec.py)."""

    func: str
    args: Tuple[Expr, ...]
    params: Tuple[int, ...] = ()

    def type(self, schema):
        return STRING


# ---------------------------------------------------------------------------


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d tensor on the device, made by a fill and not by a copy from
    the host. Float operands are passed this way because PyTorch's CUDA
    division by a host scalar multiplies by the scalar's reciprocal; the
    port keeps every float step explicit."""
    return torch.full((), value, dtype=dtype, device=device)


def decimal_unscale(scale: int, device) -> torch.Tensor:
    """float32 1 / 10^scale. The JAX package divides a decimal by the
    float32 constant 10^scale inside jit, and XLA compiles a division by a
    constant into a multiplication by its float32 reciprocal; the port
    multiplies by the same reciprocal, so both round alike."""
    return _scalar(np.float32(1.0) / np.float32(10 ** scale), torch.float32,
                   device)


def _ftz(v: torch.Tensor) -> torch.Tensor:
    """Subnormal float lanes as zero of the same sign. The JAX package's
    compiled programs treat subnormal float32 operands of arithmetic,
    comparisons, min/max, sign and floor/ceil as zero and flush subnormal
    results of arithmetic to zero; PyTorch computes with them, so the
    port flushes those operands and results explicitly."""
    tiny = torch.finfo(v.dtype).tiny
    return torch.where(v.abs() < tiny,
                       torch.copysign(torch.zeros((), dtype=v.dtype,
                                                  device=v.device), v), v)


def _to_dtype(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`v.astype(dtype)` as the JAX package's compiled programs convert:
    float -> integer saturates (NaN -> 0, values at or past the integer
    type's bounds, +-inf included, -> those bounds; the rest truncate
    toward zero), and float -> bool is `!= 0` with subnormals as zero.
    Every other conversion is PyTorch's own, which agrees."""
    if v.dtype == dtype or not v.dtype.is_floating_point:
        return v.to(dtype)
    if dtype == torch.bool:
        return _ftz(v) != 0
    if dtype.is_floating_point:
        return v.to(dtype)
    info = torch.iinfo(dtype)
    hi = -float(info.min)  # 2^(bits-1): exact in float32
    big, small = v >= hi, v < float(info.min)
    safe = torch.where(big | small | torch.isnan(v),
                       torch.zeros((), dtype=v.dtype, device=v.device), v)
    out = safe.to(dtype)
    out = torch.where(big, torch.full((), info.max, dtype=dtype,
                                      device=v.device), out)
    return torch.where(small, torch.full((), info.min, dtype=dtype,
                                         device=v.device), out)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _rescale(values: torch.Tensor, from_scale: int, to_scale: int) -> torch.Tensor:
    if to_scale == from_scale:
        return values
    if to_scale > from_scale:
        return values * (10 ** (to_scale - from_scale))
    # round-half-away-from-zero when dropping digits; // floors toward
    # -inf, so negatives round on the magnitude and re-negate
    div = 10 ** (from_scale - to_scale)
    half = div // 2
    return torch.where(values >= 0,
                       (values + half) // div,
                       -((-values + half) // div))


def _decimal_to_float(values: torch.Tensor, scale: int) -> torch.Tensor:
    return values.to(torch.float32) * decimal_unscale(scale, values.device)


def _string_code(schema: Schema, col: str, s: str) -> int:
    """Host-side: literal string -> dictionary code (-1 if absent)."""
    d = schema.dictionary(col)
    if d is None:
        raise ValueError(f"column {col} has no dictionary")
    hits = np.nonzero(d == s)[0]
    return int(hits[0]) if len(hits) else -1


def _find_string_col(e: Expr) -> Optional[str]:
    return e.name if isinstance(e, Col) else None


def _cmp(op: str, lv, rv) -> torch.Tensor:
    return {"==": lv == rv, "!=": lv != rv, "<": lv < rv,
            "<=": lv <= rv, ">": lv > rv, ">=": lv >= rv}[op]


# Tables: what an operator keeps between batches for one schema, keyed by
# (id of the expression node, device) -> a host-resolved table already on
# the device (LIKE's match table, ordering and rank tables, length()),
# or the literal codes of a string IN list. An operator's expressions
# and schema are fixed, so each entry is built once per operator and
# device instead of once per batch.
Tables = Dict[tuple, object]


def _table(tables: Tables, expr: Expr, device,
           make: Callable[[], object]):
    key = (id(expr), device)
    hit = tables.get(key)
    if hit is None:
        hit = tables[key] = make()
    return hit


def _lookup(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table[clip(codes, 0, len - 1)], the JAX package's clipped gather."""
    return table[codes.clamp(0, table.shape[0] - 1).long()]


def eval_expr(expr: Expr, batch: Batch, schema: Schema,
              tables: Tables) -> Column:
    """Evaluate to a Column of batch.capacity lanes. `tables` (a dict the
    caller keeps across batches of one schema) holds the host-resolved
    dictionary tables, so that they are built and copied once."""
    cap = batch.capacity
    dev = batch.device

    def ev(e: Expr) -> Column:
        return eval_expr(e, batch, schema, tables)

    if isinstance(expr, Col):
        return batch.col(expr.name)

    if isinstance(expr, Lit):
        ty = expr.type(schema)
        if expr.value is None:
            return Column(torch.zeros(cap, dtype=ty.dtype, device=dev),
                          torch.zeros(cap, dtype=torch.bool, device=dev))
        v = expr.value
        if ty.kind is Kind.DECIMAL and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            v = round(v * 10 ** ty.scale)
        if ty.kind is Kind.STRING:
            raise ValueError(
                "string literals must appear inside Cmp/InList/Like")
        return Column(torch.full((cap,), v, dtype=ty.dtype, device=dev))

    if isinstance(expr, BinOp):
        lt, rt = expr.left.type(schema), expr.right.type(schema)
        out_ty = expr.type(schema)
        if out_ty.kind is Kind.FLOAT:
            # XLA's rewrites read only a part of the tree below: evaluate
            # just that part, once
            form = _table(tables, expr, "xla_form",
                          lambda: _float_form(expr, schema))
            if form is not None:
                return _eval_float_form(form, ev, schema, cap, dev)
        lc = ev(expr.left)
        rc = ev(expr.right)
        validity = _combine_validity(lc, rc)

        if out_ty.kind is Kind.DECIMAL:
            ls = lt.scale if lt.kind is Kind.DECIMAL else 0
            rs = rt.scale if rt.kind is Kind.DECIMAL else 0
            # a float operand truncates to int64 as it is, saturating
            lv = _to_dtype(lc.values, torch.int64)
            rv = _to_dtype(rc.values, torch.int64)
            if expr.op in ("+", "-"):
                s = out_ty.scale
                lv, rv = _rescale(lv, ls, s), _rescale(rv, rs, s)
                vals = lv + rv if expr.op == "+" else lv - rv
            elif expr.op == "*":
                vals = lv * rv
            else:
                raise AssertionError(expr.op)
            return Column(vals, validity)

        if out_ty.kind is Kind.FLOAT:
            lv = _as_float(lc.values, lt)
            rv = _as_float(rc.values, rt)
            if expr.op == "/":
                # a constant divisor is tested on the host, unflushed
                zero_test = (_float32(rc.values, rt)
                             if not _has_col(expr.right) else rv)
                validity = _and_validity(validity, zero_test != 0)
                one = _scalar(1.0, torch.float32, dev)
                vals = lv / torch.where(rv == 0, one, rv)
            else:
                vals = {"+": lv + rv, "-": lv - rv, "*": lv * rv}[expr.op]
            return Column(_ftz(vals), validity)

        lv, rv = lc.values, rc.values
        if out_ty.kind is Kind.DATE:
            vals = {"+": lv + rv.to(lv.dtype),
                    "-": lv - rv.to(lv.dtype)}[expr.op]
            return Column(vals, validity)
        lv = lv.to(torch.int64)
        rv = rv.to(torch.int64)
        vals = {"+": lv + rv, "-": lv - rv, "*": lv * rv}[expr.op]
        return Column(vals, validity)

    if isinstance(expr, Cmp):
        lt, rt = expr.left.type(schema), expr.right.type(schema)
        # string vs literal: compare dictionary codes
        if lt.kind is Kind.STRING and isinstance(expr.right, Lit):
            col = _find_string_col(expr.left)
            lc = ev(expr.left)
            if expr.op in ("==", "!="):
                code = _table(tables, expr, dev, lambda: _string_code(
                    schema, col, expr.right.value))
                vals = lc.values == code
                if expr.op == "!=":
                    vals = ~vals
                return Column(vals, lc.validity)
            # ordering comparison against a literal: host-built table
            table = _table(tables, expr, dev, lambda: _cmp_table(
                schema.dictionary(col), expr.op, expr.right.value, dev))
            return Column(_lookup(table, lc.values), lc.validity)
        lc = ev(expr.left)
        rc = ev(expr.right)
        validity = _combine_validity(lc, rc)
        if lt.kind is Kind.STRING and rt.kind is Kind.STRING:
            lname, rname = _find_string_col(expr.left), _find_string_col(expr.right)
            lref = schema.field(lname).dict_ref if lname else None
            rref = schema.field(rname).dict_ref if rname else None
            if lref != rref or lref is None:
                raise NotImplementedError(
                    "comparing string columns with different dictionaries; "
                    "re-encode to a shared dictionary first")
            if expr.op in ("==", "!="):
                lv, rv = lc.values, rc.values
            else:
                # codes are in first-occurrence order, not lexicographic:
                # map through a host-built rank table
                rank = _table(tables, expr, dev, lambda: torch.from_numpy(
                    np.argsort(np.argsort(schema.dictionary(lname).astype(
                        str)))).to(dev))
                lv, rv = _lookup(rank, lc.values), _lookup(rank, rc.values)
            return Column(_cmp(expr.op, lv, rv), validity)
        lv, rv = _numeric_align(lc.values, lt, rc.values, rt)
        return Column(_cmp(expr.op, lv, rv), validity)

    if isinstance(expr, BoolOp):
        cols = [ev(a) for a in expr.args]
        none = torch.zeros(cap, dtype=torch.bool, device=dev)
        any_null = none
        # Kleene: track (value, known)
        if expr.op == "and":
            val = torch.ones(cap, dtype=torch.bool, device=dev)
            known_false = none
            for c in cols:
                v = c.values
                nv = none if c.validity is None else ~c.validity
                known_false = known_false | (~v & ~nv)
                any_null = any_null | nv
                val = val & (nv | v)
            validity = known_false | ~any_null
            return Column(val & ~known_false, validity)
        known_true = none
        val = none
        for c in cols:
            v = c.values
            nv = none if c.validity is None else ~c.validity
            known_true = known_true | (v & ~nv)
            any_null = any_null | nv
            val = val | (~nv & v)
        validity = known_true | ~any_null
        return Column(val | known_true, validity)

    if isinstance(expr, Not):
        c = ev(expr.arg)
        return Column(~c.values, c.validity)

    if isinstance(expr, IsNull):
        c = ev(expr.arg)
        isnull = (torch.zeros(cap, dtype=torch.bool, device=dev)
                  if c.validity is None else ~c.validity)
        return Column(~isnull if expr.negate else isnull)

    if isinstance(expr, ScalarFunc):
        return _scalar_func(expr, [ev(a) for a in expr.args], schema, tables)

    if isinstance(expr, Case):
        vals = None
        validity = None
        decided = torch.zeros(cap, dtype=torch.bool, device=dev)
        for cond, res in expr.whens:
            cc = ev(cond)
            hit = cc.values & cc.valid_mask() & ~decided
            rc = ev(res)
            if vals is None:
                vals = torch.where(hit, rc.values, torch.zeros(
                    (), dtype=rc.values.dtype, device=dev))
                validity = hit & rc.valid_mask()
            else:
                vals = torch.where(hit, _to_dtype(rc.values, vals.dtype),
                                   vals)
                validity = torch.where(hit, rc.valid_mask(), validity)
            decided = decided | hit
        if expr.otherwise is not None:
            oc = ev(expr.otherwise)
            vals = torch.where(decided, vals,
                               _to_dtype(oc.values, vals.dtype))
            validity = torch.where(decided, validity, oc.valid_mask())
        # rows not decided and no ELSE => NULL
        return Column(vals, validity)

    if isinstance(expr, Cast):
        c = ev(expr.arg)
        ft = expr.arg.type(schema)
        tt = expr.to
        v = c.values
        if ft.kind is Kind.DECIMAL and tt.kind is Kind.FLOAT:
            v = _decimal_to_float(v, ft.scale)
        elif ft.kind is Kind.DECIMAL and tt.kind is Kind.DECIMAL:
            v = _rescale(v, ft.scale, tt.scale)
        elif tt.kind is Kind.DECIMAL and ft.kind is not Kind.FLOAT:
            v = v.to(torch.int64) * (10 ** tt.scale)
        elif tt.kind is Kind.DECIMAL:
            # round half to even, as jnp.round; a subnormal product
            # rounds to zero whether flushed or not
            v = _to_dtype(torch.round(v * _scalar(
                np.float32(10 ** tt.scale), torch.float32, dev)),
                torch.int64)
        else:
            v = _to_dtype(v, tt.dtype)
        return Column(v, c.validity)

    if isinstance(expr, InList):
        ty = expr.arg.type(schema)
        c = ev(expr.arg)
        hit = torch.zeros(cap, dtype=torch.bool, device=dev)
        if ty.kind is Kind.STRING:
            col = _find_string_col(expr.arg)
            codes = _table(tables, expr, dev, lambda: [
                _string_code(schema, col, s) for s in expr.values])
            for code in codes:
                hit = hit | (c.values == code)
            return Column(hit, c.validity)
        flt = c.values.dtype.is_floating_point
        vals = _ftz(c.values) if flt else c.values
        for v in expr.values:
            if ty.kind is Kind.DECIMAL and isinstance(v, float):
                v = round(v * 10 ** ty.scale)
            # the literal in the column's dtype, as jnp.asarray(v, dtype)
            lit = _scalar(torch.tensor(v, dtype=c.values.dtype).item(),
                          c.values.dtype, dev)
            hit = hit | (vals == (_ftz(lit) if flt else lit))
        return Column(hit, c.validity)

    if isinstance(expr, Like):
        col = _find_string_col(expr.arg)
        table = _table(tables, expr, dev, lambda: _like_table(
            schema.dictionary(col), expr.pattern, dev))
        c = ev(expr.arg)
        hit = _lookup(table, c.values) & (c.values >= 0)
        if expr.negate:
            hit = ~hit
        return Column(hit, c.validity)

    if isinstance(expr, Extract):
        c = ev(expr.arg)
        y, m, day = _civil_from_days(c.values.to(torch.int64))
        return Column({"year": y, "month": m, "day": day}[expr.part],
                      c.validity)

    if isinstance(expr, VecLit):
        # the query vector goes to the device once per operator (the
        # fused tier's warm-up makes it before any graph capture)
        q = _table(tables, expr, dev, lambda: torch.tensor(
            expr.values, dtype=torch.float32, device=dev))
        return Column(q.expand(cap, q.shape[0]))

    if isinstance(expr, VecDistance):
        from cockroach_tpu_torch.ops.vector import (cosine_distance,
                                                    l2_distance)

        lc = ev(expr.left)
        rc = ev(expr.right)
        validity = _combine_validity(lc, rc)
        fn = l2_distance if expr.metric == "l2" else cosine_distance
        return Column(fn(lc.values, rc.values), validity)

    if isinstance(expr, StrFunc):
        # the row engine's (exec/rowexec.py): the JAX package's message
        raise TypeError(f"cannot evaluate {type(expr).__name__}")
    raise NotImplementedError(f"{type(expr).__name__}: {_NOT_PORTED}")


def _scalar_func(expr: ScalarFunc, cs, schema: Schema,
                 tables: Tables) -> Column:
    f = expr.func
    if f == "length":
        c = cs[0]
        dev = c.values.device
        tbl = _table(tables, expr, dev, lambda: torch.tensor(
            expr.table, dtype=torch.int64, device=dev))
        return Column(_lookup(tbl, c.values.to(torch.int32)), c.validity)
    if f == "coalesce":
        vals = cs[0].values
        valid = cs[0].valid_mask()
        for c in cs[1:]:
            vals = torch.where(valid, vals, _to_dtype(c.values, vals.dtype))
            valid = valid | c.valid_mask()
        return Column(vals, valid)
    if f == "nullif":
        a, b = cs
        av, bv = a.values, _to_dtype(b.values, a.values.dtype)
        if av.dtype.is_floating_point:
            av, bv = _ftz(av), _ftz(bv)
        eq = (av == bv) & a.valid_mask() & b.valid_mask()
        return Column(a.values, a.valid_mask() & ~eq)
    if f == "abs":
        c = cs[0]
        return Column(torch.abs(c.values), c.validity)
    if f == "sign":
        c = cs[0]
        v = _ftz(c.values) if c.values.dtype.is_floating_point else c.values
        return Column(_to_dtype(torch.sign(v), torch.int64), c.validity)
    if f == "mod":
        a, b = cs
        bv = _to_dtype(b.values, a.values.dtype)
        zero = (_ftz(bv) if bv.dtype.is_floating_point else bv) == 0
        # mod 0 -> NULL
        validity = _and_validity(_combine_validity(a, b), ~zero)
        safe = torch.where(zero, torch.ones((), dtype=bv.dtype,
                                            device=bv.device), bv)
        return Column(_rem(a.values, safe), validity)
    if f in ("greatest", "least"):
        op = torch.maximum if f == "greatest" else torch.minimum
        vals = cs[0].values
        valid = cs[0].valid_mask()
        flt = vals.dtype.is_floating_point
        for c in cs[1:]:
            other = _to_dtype(c.values, vals.dtype)
            both = valid & c.valid_mask()
            best = op(_ftz(vals), _ftz(other)) if flt else op(vals, other)
            vals = torch.where(both, best,
                               torch.where(c.valid_mask() & ~valid,
                                           other, vals))
            valid = valid | c.valid_mask()
        return Column(vals, valid)  # SQL: NULL args are skipped
    if f in ("floor", "ceil"):
        c = cs[0]
        ty = expr.args[0].type(schema)
        if ty.kind is Kind.DECIMAL:
            s = 10 ** ty.scale
            v = c.values.to(torch.int64)
            q = _floordiv(v, s) if f == "floor" else -_floordiv(-v, s)
            return Column(q, c.validity)
        if c.values.dtype.is_floating_point:
            fn = torch.floor if f == "floor" else torch.ceil
            return Column(_to_dtype(fn(_ftz(c.values)), torch.int64),
                          c.validity)
        return Column(c.values.to(torch.int64), c.validity)
    raise ValueError(f"unknown scalar function {f!r}")


def _rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """lax.rem: the remainder that truncates (C fmod), exact. x rem -1 is
    0 for integers (no INT_MIN trap). Floats (float32 columns) take the
    remainder in float64: PyTorch's vectorized CPU fmod loses the result
    when a / b overflows its type (9.3e18 rem 1e-20 gives NaN in
    float32), a float32 quotient cannot overflow float64, and the exact
    remainder of two float32 values is a float32 value, so the cast back
    is exact on the CPU and on the card alike."""
    if not a.dtype.is_floating_point:
        return torch.where(b == -1, torch.zeros_like(a), torch.fmod(a, b))
    return torch.fmod(a.double(), b.double()).to(a.dtype)


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def _like_table(dictionary: np.ndarray, pattern: str, device):
    rx = re.compile(_like_to_regex(pattern), re.S)
    return torch.from_numpy(np.array([bool(rx.fullmatch(s))
                                      for s in dictionary],
                                     dtype=np.bool_)).to(device)


def _cmp_table(dictionary: np.ndarray, op: str, literal: str, device):
    f = {"<": np.less, "<=": np.less_equal,
         ">": np.greater, ">=": np.greater_equal}[op]
    return torch.from_numpy(np.asarray(f(dictionary.astype(str), literal))).to(device)


def _combine_validity(lc: Column, rc: Column):
    if lc.validity is None and rc.validity is None:
        return None
    return lc.valid_mask() & rc.valid_mask()


def _and_validity(validity, extra):
    if validity is None:
        return extra
    return validity & extra


def _float32(values: torch.Tensor, ty: ColType) -> torch.Tensor:
    """A numeric column's values in float32, subnormals kept."""
    if ty.kind is Kind.DECIMAL:
        return _decimal_to_float(values, ty.scale)
    return values.to(torch.float32)


def _as_float(values: torch.Tensor, ty: ColType) -> torch.Tensor:
    """An operand of float arithmetic or comparison, in float32;
    subnormal float lanes read as zero (_ftz)."""
    v = _float32(values, ty)
    return _ftz(v) if ty.kind is Kind.FLOAT else v


def _has_col(e) -> bool:
    """Whether an expression (or a tuple of them, as Case's whens)
    references a column."""
    if isinstance(e, Col):
        return True
    if isinstance(e, Expr):
        return any(_has_col(v) for v in vars(e).values())
    if isinstance(e, tuple):
        return any(_has_col(x) for x in e)
    return False


def _constant_float(e: Expr, schema: Schema) -> Optional[float]:
    """The float32 value of an expression without column references
    (NULL reads as its zero lane), evaluated on the host; None for any
    other expression."""
    if _has_col(e):
        return None
    return float(_float32(_constant_column(e, schema).values,
                          e.type(schema))[0])


def _constant_column(e: Expr, schema: Schema) -> Column:
    """An expression without column references, evaluated on the host
    in one lane."""
    one = Batch({}, torch.ones(1, dtype=torch.bool),
                torch.ones((), dtype=torch.int32))
    return eval_expr(e, one, schema, {})


def _xla_fold(expr: BinOp, schema: Schema):
    """The float BinOp forms XLA's algebraic simplifier removes under
    jit, found by running the JAX package's eval_expr under jax.jit on the
    CPU: x + 0, 0 + x, x - 0 (either zero's sign), x * 1, 1 * x, x / 1
    and x / 0 (a zero divisor is replaced by 1 before the division) keep
    x's bits; x * -1, -1 * x, x / -1 and -0.0 - x negate them. A constant
    is any expression without column references, a NULL literal included
    (its lanes hold zero). -> (index of the operand kept, negated?) or
    None; there no flush happens, so a subnormal passes through."""
    lc = _constant_float(expr.left, schema)
    rc = _constant_float(expr.right, schema)
    if expr.op == "+":
        if rc == 0.0:
            return 0, False
        if lc == 0.0:
            return 1, False
    elif expr.op == "-":
        if rc == 0.0:
            return 0, False
        if lc == 0.0 and math.copysign(1.0, lc) < 0:
            return 1, True
    elif expr.op == "*":
        if rc in (1.0, -1.0):
            return 0, rc < 0
        if lc in (1.0, -1.0):
            return 1, lc < 0
    elif expr.op == "/" and rc in (0.0, 1.0, -1.0):
        return 0, rc < 0
    return None


# XLA's CPU backend rewrites float products further, found the same way
# (jax.jit of the JAX package's eval_expr against every form):
# - x / c, for a constant c that _xla_fold keeps, becomes x * fl(1 / c),
#   the reciprocal taken on the host without a flush (so x / 1e-45 is
#   x * inf, and its lanes stay valid);
# - (a * c1) * c2 becomes a * fl(c1 * c2), the outer constants first:
#   ((a * c1) * c2) * c3 is a * fl(c1 * fl(c2 * c3)); a decimal's
#   conversion to float is such a product (the integer value times
#   fl(1 / 10^scale));
# - a product that feeds an add or subtract directly, through folds, a
#   float-to-float cast or a negation, contracts into one fused
#   multiply-add, rounded once; when both operands are products, the
#   left one contracts. Only a product with one consumer contracts: an
#   expression that repeats a product is not held to this.

def _recip(c) -> np.float32:
    with np.errstate(all="ignore"):
        return np.float32(1.0) / np.float32(c)


def _operand_chain(e: Expr, schema: Schema):
    """(base, constants) when a float operand's value is base times the
    constants (float32, innermost first) after XLA's rewrites; None
    otherwise."""
    if not _has_col(e):
        return None
    ty = e.type(schema)
    if ty.kind is Kind.DECIMAL:
        return e, (_recip(10 ** ty.scale),)
    if isinstance(e, Cast) and ty.kind is Kind.FLOAT:
        ft = e.arg.type(schema)
        return (_operand_chain(e.arg, schema)
                if ft.kind in (Kind.DECIMAL, Kind.FLOAT) else None)
    if not (isinstance(e, BinOp) and ty.kind is Kind.FLOAT):
        return None
    return _scale_chain(e, schema)


def _chain_constant(consts) -> np.float32:
    """The one constant a chain multiplies by, combined outermost first."""
    acc = consts[-1]
    with np.errstate(all="ignore"):
        for c in reversed(consts[:-1]):
            acc = np.float32(c * acc)
    return acc


def _scale_chain(e: BinOp, schema: Schema):
    """_operand_chain of a float BinOp: a fold passes its kept operand's
    chain on (negated or not), a multiply by a constant or a divide by
    one extends its operand's chain."""
    fold = _xla_fold(e, schema)
    if fold is not None:
        side, negate = fold
        sub = _operand_chain((e.left, e.right)[side], schema)
        if sub is None:
            return None
        return sub[0], sub[1][:-1] + (-sub[1][-1] if negate else sub[1][-1],)
    lc = _constant_float(e.left, schema)
    rc = _constant_float(e.right, schema)
    if e.op == "*" and (lc is None) != (rc is None):
        other, c = (e.left, np.float32(rc)) if lc is None else (
            e.right, np.float32(lc))
    elif e.op == "/" and lc is None and rc is not None:
        other, c = e.left, _recip(rc)
    else:
        return None
    sub = _operand_chain(other, schema)
    if sub is None:
        return other, (c,)
    return sub[0], sub[1] + (c,)


def _product(e: Expr, schema: Schema):
    if not _has_col(e):
        return None
    chain = _operand_chain(e, schema)
    if chain is not None:
        base, c = chain[0], _chain_constant(chain[1])
        return None if c in (1.0, -1.0) else (("raw", base), ("const", c),
                                              False)
    if isinstance(e, Cast) and e.to.kind is Kind.FLOAT \
            and e.arg.type(schema).kind is Kind.FLOAT:
        return _product(e.arg, schema)
    if isinstance(e, BinOp) and e.type(schema).kind is Kind.FLOAT:
        fold = _xla_fold(e, schema)
        if fold is not None:
            side, negate = fold
            sub = _product((e.left, e.right)[side], schema)
            return None if sub is None else (sub[0], sub[1], sub[2] != negate)
        if e.op == "*":
            return ("val", e.left), ("val", e.right), False
    return None


def _raw_float(c: Column, ty: ColType, flush: bool = True) -> torch.Tensor:
    """The float32 value a chain multiplies: a decimal's integer value
    unscaled, a float flushed (when it is a multiply's operand)."""
    if ty.kind is Kind.FLOAT:
        return _ftz(c.values) if flush else c.values
    return c.values.to(torch.float32)


class _FloatForm(NamedTuple):
    """How XLA computes a float BinOp it rewrites. `kind` is "fold"
    (srcs[0] kept, negated or not), "scale" (srcs[0] times `const`) or
    "fma" (srcs[0] * srcs[1] + srcs[2], the product negated or not, the
    addend negated when `neg_other`). `leaves` are the expressions
    evaluated, whose validity the result takes, with what the nodes
    above them add (`extra`, _form_validity)."""

    kind: str
    srcs: tuple
    const: Optional[np.float32]
    negate: bool
    neg_other: bool
    leaves: tuple
    extra: Optional[bool]


def _float_form(e: BinOp, schema: Schema) -> Optional[_FloatForm]:
    """The rewritten form of a float BinOp, or None for the plain one.
    Sources are ("val", expr) (an operand, flushed), ("raw", expr) (a
    chain's base, _raw_float), ("keep", expr) (unflushed) or
    ("const", c)."""
    fold = _xla_fold(e, schema)
    if fold is not None:
        side, negate = fold
        srcs, const, neg_other = (("keep", (e.left, e.right)[side]),), \
            None, False
    elif (chain := _scale_chain(e, schema)) is not None:
        base, c = chain[0], _chain_constant(chain[1])
        unit = c in (1.0, -1.0)  # the combined constant folds away
        # then a float base passes unflushed; a decimal's integer value
        # is read as it is either way
        keep = unit and base.type(schema).kind is Kind.FLOAT
        srcs = (("keep" if keep else "raw", base),)
        const = None if unit else c
        negate, neg_other = unit and c < 0, False
    elif e.op in ("+", "-"):
        for side, operand in enumerate((e.left, e.right)):
            prod = _product(operand, schema)
            if prod is not None:
                break
        else:
            return None
        x, y, negate = prod
        other = ("val", (e.left, e.right)[1 - side])
        neg_other = e.op == "-" and side == 0
        if e.op == "-" and side == 1:
            negate = not negate
        srcs, const = (x, y, other), None
    else:
        return None
    leaves = tuple(x for kind, x in srcs if kind != "const")
    return _FloatForm("fold" if fold is not None else
                      "scale" if len(srcs) == 1 else "fma", srcs, const,
                      negate, neg_other, leaves,
                      _form_validity(e, leaves, schema))


def _form_validity(e: Expr, leaves: tuple, schema: Schema
                   ) -> Optional[bool]:
    """What the nodes between `e` and its leaves (float BinOps and
    casts) add to the leaves' validity: None nothing, True a mask that
    is all valid (a divide by a nonzero constant, a constant that
    carries one), False every lane NULL (a NULL constant, a divide by a
    constant zero)."""
    if any(e is leaf for leaf in leaves):
        return None
    if not _has_col(e):
        v = _constant_column(e, schema).validity
        return None if v is None else bool(v[0])
    if isinstance(e, Cast):
        return _form_validity(e.arg, leaves, schema)
    assert isinstance(e, BinOp), e
    parts = [_form_validity(e.left, leaves, schema),
             _form_validity(e.right, leaves, schema)]
    if e.op == "/":
        parts.append(_constant_float(e.right, schema) != 0.0)
    if False in parts:
        return False
    return True if True in parts else None


def _eval_float_form(form: _FloatForm, ev, schema: Schema, cap: int,
                     device) -> Column:
    cols = {}
    for leaf in form.leaves:
        if id(leaf) not in cols:
            cols[id(leaf)] = ev(leaf)
    validity = None
    if form.extra is not None:
        validity = torch.full((cap,), form.extra, dtype=torch.bool,
                              device=device)
    for c in cols.values():
        if c.validity is not None:
            validity = _and_validity(validity, c.validity)

    def source(src) -> torch.Tensor:
        kind, x = src
        if kind == "const":
            return _scalar(x, torch.float32, device)
        ty, values = x.type(schema), cols[id(x)].values
        if kind == "keep":
            return _float32(values, ty)
        if kind == "raw":
            return _raw_float(cols[id(x)], ty)
        return _as_float(values, ty)

    if form.kind == "fold":
        kept = source(form.srcs[0])
        return Column(-kept if form.negate else kept, validity)
    if form.kind == "scale":
        v = source(form.srcs[0])
        if form.const is None:
            return Column(-v if form.negate else v, validity)
        return Column(_ftz(v * _scalar(form.const, torch.float32, device)),
                      validity)
    xv, yv, other = (source(s) for s in form.srcs)
    return Column(_fma(-xv if form.negate else xv, yv,
                       -other if form.neg_other else other), validity)


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 x * y + z rounded once, then flushed: the product is exact
    in float64, the sum's rounding error exact by TwoSum, and a sum that
    was rounded with a nonzero error is moved to the odd neighbour, so
    the final rounding to float32 cannot round twice."""
    x, y, z = (t.to(torch.float64) for t in (x, y, z))
    p = x * y
    s = p + z
    bp = s - p
    err = (p - (s - bp)) + (z - bp)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, math.inf),
                       torch.full_like(s, -math.inf))
    s = torch.where(torch.isfinite(s) & (err != 0) & even,
                    torch.nextafter(s, away), s)
    return _ftz(s.to(torch.float32))


def _numeric_align(lv, lt: ColType, rv, rt: ColType):
    """Align two columns for comparison."""
    if lt.kind is Kind.DECIMAL or rt.kind is Kind.DECIMAL:
        ls = lt.scale if lt.kind is Kind.DECIMAL else 0
        rs = rt.scale if rt.kind is Kind.DECIMAL else 0
        s = max(ls, rs)
        if lt.kind is Kind.FLOAT or rt.kind is Kind.FLOAT:
            return _as_float(lv, lt), _as_float(rv, rt)
        return (_rescale(lv.to(torch.int64), ls, s),
                _rescale(rv.to(torch.int64), rs, s))
    if lt.kind is Kind.FLOAT or rt.kind is Kind.FLOAT:
        return _as_float(lv, lt), _as_float(rv, rt)
    return lv, rv


def _civil_from_days(z: torch.Tensor):
    """days-since-epoch -> (year, month, day), int64; Howard Hinnant's
    algorithm, with floor division throughout (dates before 1970 too)."""
    z = z + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def filter_mask(expr: Expr, batch: Batch, schema: Schema,
                tables: Tables) -> torch.Tensor:
    """Predicate -> boolean keep-mask (TRUE only; NULL/FALSE drop)."""
    c = eval_expr(expr, batch, schema, tables)
    return c.values & c.valid_mask()

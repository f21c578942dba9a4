"""Scalar expression IR and its evaluation over a Batch — filter and
projection.

Counterpart of cockroach_tpu/ops/expr.py, for the nodes Col, Lit, BinOp,
Cmp, BoolOp, Not and IsNull. Semantics follow SQL:
- three-valued logic: any NULL operand of arithmetic/comparison yields
  NULL; AND/OR are Kleene;
- a filter keeps rows whose predicate is TRUE (NULL drops);
- decimals are int64 scaled by 10^scale: +/- align scales, * adds scales
  (int64 products wrap), / produces float32;
- strings are dictionary codes; predicates against literals are resolved
  host-side through the schema's dictionary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import (
    BOOL, DATE, DECIMAL, FLOAT, INT, STRING, Batch, ColType, Column, Kind,
    Schema,
)

# where each JAX expression node that is not ported yet is queued
_NOT_PORTED = "not ported yet (ROADMAP.md queue 1, item 2: the remaining eval_expr nodes)"


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


def eval_expr(expr: Expr, batch: Batch, schema: Schema) -> Column:
    """Evaluate to a Column of batch.capacity lanes."""
    cap = batch.capacity
    dev = batch.device

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
            raise ValueError("string literals must appear inside Cmp")
        return Column(torch.full((cap,), v, dtype=ty.dtype, device=dev))

    if isinstance(expr, BinOp):
        lt, rt = expr.left.type(schema), expr.right.type(schema)
        lc = eval_expr(expr.left, batch, schema)
        rc = eval_expr(expr.right, batch, schema)
        validity = _combine_validity(lc, rc)
        out_ty = expr.type(schema)

        if out_ty.kind is Kind.DECIMAL:
            ls = lt.scale if lt.kind is Kind.DECIMAL else 0
            rs = rt.scale if rt.kind is Kind.DECIMAL else 0
            lv = lc.values.to(torch.int64)
            rv = rc.values.to(torch.int64)
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
                validity = _and_validity(validity, rv != 0)
                one = _scalar(1.0, torch.float32, dev)
                vals = lv / torch.where(rv == 0, one, rv)
            else:
                vals = {"+": lv + rv, "-": lv - rv, "*": lv * rv}[expr.op]
            return Column(vals, validity)

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
            code = _string_code(schema, col, expr.right.value)
            lc = eval_expr(expr.left, batch, schema)
            if expr.op in ("==", "!="):
                vals = lc.values == code
                if expr.op == "!=":
                    vals = ~vals
                return Column(vals, lc.validity)
            # ordering comparison against a literal: host-built table
            d = schema.dictionary(col)
            table = _cmp_table(d, expr.op, expr.right.value, dev)
            return Column(table[lc.values.clamp(0, len(d) - 1).long()],
                          lc.validity)
        lc = eval_expr(expr.left, batch, schema)
        rc = eval_expr(expr.right, batch, schema)
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
                d = schema.dictionary(lname)
                rank = torch.from_numpy(
                    np.argsort(np.argsort(d.astype(str)))).to(dev)
                lv = rank[lc.values.clamp(0, len(d) - 1).long()]
                rv = rank[rc.values.clamp(0, len(d) - 1).long()]
            return Column(_cmp(expr.op, lv, rv), validity)
        lv, rv = _numeric_align(lc.values, lt, rc.values, rt)
        return Column(_cmp(expr.op, lv, rv), validity)

    if isinstance(expr, BoolOp):
        cols = [eval_expr(a, batch, schema) for a in expr.args]
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
        c = eval_expr(expr.arg, batch, schema)
        return Column(~c.values, c.validity)

    if isinstance(expr, IsNull):
        c = eval_expr(expr.arg, batch, schema)
        isnull = (torch.zeros(cap, dtype=torch.bool, device=dev)
                  if c.validity is None else ~c.validity)
        return Column(~isnull if expr.negate else isnull)

    raise NotImplementedError(f"{type(expr).__name__}: {_NOT_PORTED}")


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


def _as_float(values: torch.Tensor, ty: ColType) -> torch.Tensor:
    if ty.kind is Kind.DECIMAL:
        return _decimal_to_float(values, ty.scale)
    return values.to(torch.float32)


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


def filter_mask(expr: Expr, batch: Batch, schema: Schema) -> torch.Tensor:
    """Predicate -> boolean keep-mask (TRUE only; NULL/FALSE drop)."""
    c = eval_expr(expr, batch, schema)
    return c.values & c.valid_mask()

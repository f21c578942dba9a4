"""Row-at-a-time engine — exact datum semantics on the host.

Counterpart of cockroach_tpu/exec/rowexec.py. Reference (SURVEY.md §2.3
+ §7.4 item 6): the reference's vectorized engine falls back to
datum-backed vectors or the row engine for types and operations with no
native columnar representation. `RowMapOp` evaluates a projection per
row with Python's arbitrary-precision int and decimal.Decimal, then
re-encodes the results into columns.

The planner routes a Project here when an output computes a string
(a StrFunc, or any STRING-typed output that is not a plain column, such
as a CASE of strings: the device holds dictionary codes, and a new
string grows the dictionary on the host), and,
under `sql.tpu.exact_arithmetic`, when it divides a decimal (the device
path's BinOp "/" gives float32). The row engine is host code by design:
it reads its child's batch back in one device-to-host copy (the
selection and the columns the computed outputs read), and puts each
computed column back onto the batch's own device; plain column outputs
pass through untouched, and the batch's capacity and selection are kept.
"""

from __future__ import annotations

import datetime
import re
from decimal import Decimal, ROUND_HALF_UP
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import (
    Batch, ColType, Column, DECIMAL, FLOAT, Field, Kind, Schema,
)
from cockroach_tpu_torch.exec import stats as _stats
from cockroach_tpu_torch.ops.expr import (
    BinOp, BoolOp, Case, Cast, Cmp, Col, Expr, Extract, InList, IsNull,
    Like, Lit, Not, ScalarFunc, StrFunc,
)
from cockroach_tpu_torch.util.settings import Settings

EXACT_ARITHMETIC = Settings.register(
    "sql.tpu.exact_arithmetic",
    False,
    "route decimal division through the exact row-at-a-time fallback",
)

DIV_SCALE = 6  # result scale of exact decimal division (numeric-ish)


# ------------------------------------------------------------ typing -----

def exact_type(e: Expr, schema: Schema) -> ColType:
    """Expr type under EXACT rules: decimal / decimal -> DECIMAL(6)
    instead of the device path's float32."""
    if isinstance(e, BinOp) and e.op == "/":
        lt, rt = exact_type(e.left, schema), exact_type(e.right, schema)
        if Kind.DECIMAL in (lt.kind, rt.kind) or \
                (lt.kind is Kind.INT and rt.kind is Kind.INT):
            return DECIMAL(DIV_SCALE)
        return FLOAT
    if isinstance(e, BinOp):
        lt, rt = exact_type(e.left, schema), exact_type(e.right, schema)
        if Kind.DECIMAL in (lt.kind, rt.kind):
            ls = lt.scale if lt.kind is Kind.DECIMAL else 0
            rs = rt.scale if rt.kind is Kind.DECIMAL else 0
            if e.op in ("+", "-"):
                return DECIMAL(max(ls, rs))
            if e.op == "*":
                return DECIMAL(ls + rs)
        return e.type(schema)
    if isinstance(e, Case):
        return exact_type(e.whens[0][1], schema)
    return e.type(schema)


def has_string_compute(e: Expr) -> bool:
    """Does the expression mint NEW strings (StrFunc anywhere)? Such
    projections must run on the row engine: the device representation is
    dictionary codes and the dictionary grows host-side."""
    if isinstance(e, StrFunc):
        return True
    for v in getattr(e, "__dict__", {}).values():
        if isinstance(v, Expr) and has_string_compute(v):
            return True
        if isinstance(v, tuple):
            for item in v:
                if isinstance(item, Expr) and has_string_compute(item):
                    return True
    return False


def has_decimal_division(e: Expr, schema: Schema) -> bool:
    if isinstance(e, BinOp) and e.op == "/":
        lt = e.left.type(schema)
        rt = e.right.type(schema)
        if Kind.DECIMAL in (lt.kind, rt.kind):
            return True
    for v in getattr(e, "__dict__", {}).values():
        if isinstance(v, Expr) and has_decimal_division(v, schema):
            return True
        if isinstance(v, tuple):
            for item in v:
                if isinstance(item, Expr) \
                        and has_decimal_division(item, schema):
                    return True
                if isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, Expr) \
                                and has_decimal_division(sub, schema):
                            return True
    return False


# ------------------------------------------------------ datum evaluation --

def _decode(vals, validity, ty: ColType, dictionary) -> List:
    out = []
    for i in range(len(vals)):
        if validity is not None and not bool(validity[i]):
            out.append(None)
        elif ty.kind is Kind.DECIMAL:
            out.append(Decimal(int(vals[i])).scaleb(-ty.scale))
        elif ty.kind is Kind.STRING and dictionary is not None:
            out.append(str(dictionary[int(vals[i])]))
        elif ty.kind is Kind.FLOAT:
            out.append(float(vals[i]))
        elif ty.kind is Kind.BOOL:
            out.append(bool(vals[i]))
        else:
            out.append(int(vals[i]))
    return out


def eval_datum(e: Expr, row: Dict[str, object], schema: Schema):
    """Evaluate one row with exact host semantics; None = SQL NULL."""
    if isinstance(e, Col):
        return row[e.name]
    if isinstance(e, ScalarFunc):
        vals = [eval_datum(a, row, schema) for a in e.args]
        f = e.func
        if f == "coalesce":
            return next((v for v in vals if v is not None), None)
        if f == "nullif":
            a, b = vals
            return None if (a is not None and a == b) else a
        if f in ("greatest", "least"):
            nn = [v for v in vals if v is not None]
            if not nn:
                return None
            return max(nn) if f == "greatest" else min(nn)
        if vals[0] is None or (len(vals) > 1 and vals[1] is None):
            return None
        if f == "abs":
            return abs(vals[0])
        if f == "sign":
            return (vals[0] > 0) - (vals[0] < 0)
        if f == "mod":
            if vals[1] == 0:
                return None
            import math

            return math.fmod(vals[0], vals[1])
        if f == "length":
            return len(str(vals[0]))
        if f == "floor":
            import math

            return int(math.floor(vals[0]))
        if f == "ceil":
            import math

            return int(math.ceil(vals[0]))
    if isinstance(e, StrFunc):
        vals = [eval_datum(a, row, schema) for a in e.args]
        if any(v is None for v in vals):
            return None
        if e.func == "concat":
            return "".join(str(v) for v in vals)
        v = str(vals[0])
        if e.func == "upper":
            return v.upper()
        if e.func == "lower":
            return v.lower()
        start, ln = e.params  # SQL substring: 1-based start
        return v[max(start - 1, 0):max(start - 1, 0) + ln]
    if isinstance(e, Lit):
        v = e.value
        if v is None:
            return None
        if e.ty is not None and e.ty.kind is Kind.DECIMAL:
            return Decimal(str(v))
        return v
    if isinstance(e, BinOp):
        lv = eval_datum(e.left, row, schema)
        rv = eval_datum(e.right, row, schema)
        if lv is None or rv is None:
            return None
        if e.op == "/":
            if rv == 0:
                return None  # division by zero -> NULL (device parity)
            if isinstance(lv, (Decimal, int)) and \
                    isinstance(rv, (Decimal, int)):
                q = Decimal(lv) / Decimal(rv)
                return q.quantize(Decimal(1).scaleb(-DIV_SCALE),
                                  rounding=ROUND_HALF_UP)
            return float(lv) / float(rv)
        if isinstance(lv, Decimal) or isinstance(rv, Decimal):
            lv, rv = Decimal(lv), Decimal(rv)
        return {"+": lambda: lv + rv, "-": lambda: lv - rv,
                "*": lambda: lv * rv}[e.op]()
    if isinstance(e, Cmp):
        lv = eval_datum(e.left, row, schema)
        rv = eval_datum(e.right, row, schema)
        if lv is None or rv is None:
            return None
        if isinstance(lv, Decimal) or isinstance(rv, Decimal):
            lv, rv = Decimal(str(lv)), Decimal(str(rv))
        return {"==": lv == rv, "!=": lv != rv, "<": lv < rv,
                "<=": lv <= rv, ">": lv > rv, ">=": lv >= rv}[e.op]
    if isinstance(e, BoolOp):
        vals = [eval_datum(a, row, schema) for a in e.args]
        if e.op == "and":
            if any(v is False for v in vals):
                return False
            return None if any(v is None for v in vals) else True
        if any(v is True for v in vals):
            return True
        return None if any(v is None for v in vals) else False
    if isinstance(e, Not):
        v = eval_datum(e.arg, row, schema)
        return None if v is None else (not v)
    if isinstance(e, IsNull):
        v = eval_datum(e.arg, row, schema)
        return (v is not None) if e.negate else (v is None)
    if isinstance(e, Case):
        for cond, val in e.whens:
            if eval_datum(cond, row, schema) is True:
                return eval_datum(val, row, schema)
        return (eval_datum(e.otherwise, row, schema)
                if e.otherwise is not None else None)
    if isinstance(e, Cast):
        v = eval_datum(e.arg, row, schema)
        if v is None:
            return None
        if e.to.kind is Kind.DECIMAL:
            return Decimal(str(v)).quantize(
                Decimal(1).scaleb(-e.to.scale), rounding=ROUND_HALF_UP)
        if e.to.kind is Kind.INT:
            return int(v)
        if e.to.kind is Kind.FLOAT:
            return float(v)
        return v
    if isinstance(e, Extract):
        v = eval_datum(e.arg, row, schema)
        if v is None:
            return None
        d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
        return {"year": d.year, "month": d.month, "day": d.day}[e.part]
    if isinstance(e, InList):
        v = eval_datum(e.arg, row, schema)
        if v is None:
            return None
        return v in e.values
    if isinstance(e, Like):
        v = eval_datum(e.arg, row, schema)
        if v is None:
            return None
        pat = "^" + "".join(
            ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
            for ch in e.pattern) + "$"
        hit = re.match(pat, str(v)) is not None
        return (not hit) if e.negate else hit
    raise NotImplementedError(f"row engine: {type(e).__name__}")


def _expr_cols(e: Expr, out: set) -> None:
    if isinstance(e, Col):
        out.add(e.name)
    for v in getattr(e, "__dict__", {}).values():
        if isinstance(v, Expr):
            _expr_cols(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, Expr):
                    _expr_cols(item, out)
                elif isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, Expr):
                            _expr_cols(sub, out)


# --------------------------------------------------------------- RowMapOp

_NP_OF = {torch.bool: np.dtype(np.bool_), torch.int32: np.dtype(np.int32),
          torch.int64: np.dtype(np.int64),
          torch.float32: np.dtype(np.float32)}


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays, read back in one device-to-host copy
    (their bytes packed into one uint8 tensor on the device first)."""
    if not tensors or tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    flat = torch.cat([(t.to(torch.uint8) if t.dtype == torch.bool
                       else t.contiguous().view(torch.uint8)).reshape(-1)
                      for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        dt = _NP_OF[t.dtype]
        nb = t.numel() * dt.itemsize
        raw = flat[off:off + nb]
        out.append(raw.astype(bool) if t.dtype == torch.bool
                   else raw.view(dt))
        off += nb
    return out


class RowMapOp:
    """Projection evaluated row-at-a-time with exact datum semantics.
    Drop-in for MapOp(project): same capacity/sel, new columns."""

    def __init__(self, child, outputs: Sequence[Tuple[str, Expr]]):
        self.child = child
        self.outputs = list(outputs)
        in_schema = child.schema
        fields = []
        # plain Col outputs pass the device column through untouched —
        # only computed expressions take the per-row datum path
        self._passthrough: Dict[str, str] = {}
        self._computed: List[Tuple[str, Expr]] = []
        # computed STRING outputs mint codes into a FRESH dictionary;
        # the schema's dict mapping is updated as batches flow
        self._minted: Dict[str, Dict[str, int]] = {}
        dicts = dict(in_schema.dicts)
        for name, e in self.outputs:
            ty = exact_type(e, in_schema)
            dict_ref = None
            if isinstance(e, Col):
                dict_ref = in_schema.field(e.name).dict_ref
                self._passthrough[name] = e.name
            else:
                if ty.kind is Kind.STRING:
                    dict_ref = f"__computed__:{id(self)}:{name}"
                    self._minted[name] = {}
                    dicts[dict_ref] = np.zeros(0, dtype=object)
                self._computed.append((name, e))
            fields.append(Field(name, ty, dict_ref=dict_ref))
        self.schema = Schema(fields, dicts)
        # decode only the columns the computed expressions reference
        needed: set = set()
        for _, e in self._computed:
            _expr_cols(e, needed)
        self._needed = [f for f in in_schema if f.name in needed]

    def batches(self, device: torch.device) -> Iterator[Batch]:
        in_schema = self.child.schema
        for b in self.child.batches(device):
            yield self._one(b, in_schema)

    def _one(self, b: Batch, in_schema: Schema) -> Batch:
        cap = b.capacity
        reads = [b.sel]
        for f in self._needed:
            c = b.col(f.name)
            reads.append(c.values)
            reads.append(c.valid_mask())
        host = _to_host(reads)
        idxs = np.nonzero(host[0])[0]
        with _stats.timed("host.rowmap", rows=len(idxs)):
            cols_np = {}
            for i, f in enumerate(self._needed):
                vals, valid = host[1 + 2 * i], host[2 + 2 * i]
                cols_np[f.name] = _decode(vals[idxs], valid[idxs], f.type,
                                          in_schema.dictionary(f.name))
            rows = [{n: cols_np[n][j] for n in cols_np}
                    for j in range(len(idxs))]

            out_cols: Dict[str, Column] = {}
            for name, src in self._passthrough.items():
                out_cols[name] = b.col(src)
            for name, e in self._computed:
                ty = self.schema.field(name).type
                vals = np.zeros(cap, dtype=ty.np_dtype)
                valid = np.zeros(cap, dtype=bool)
                minted = self._minted.get(name)
                for j, i in enumerate(idxs):
                    v = eval_datum(e, rows[j], in_schema)
                    if v is None:
                        continue
                    valid[i] = True
                    if minted is not None:
                        code = minted.setdefault(str(v), len(minted))
                        vals[i] = code
                        continue
                    if ty.kind is Kind.DECIMAL:
                        scaled = int(Decimal(str(v)).scaleb(ty.scale)
                                     .to_integral_value(ROUND_HALF_UP))
                        if not (-(1 << 63) <= scaled < (1 << 63)):
                            raise OverflowError(
                                f"{name}: exact decimal {v} exceeds the "
                                "int64 device encoding")
                        vals[i] = scaled
                    else:
                        vals[i] = v
                out_cols[name] = Column(
                    torch.from_numpy(vals).to(b.device),
                    torch.from_numpy(valid).to(b.device))
            # publish grown dictionaries for downstream decoding
            for name, minted in self._minted.items():
                ref = self.schema.field(name).dict_ref
                self.schema.dicts[ref] = np.asarray(
                    sorted(minted, key=minted.get), dtype=object)
        return Batch(out_cols, b.sel, b.length)

"""Streaming operator tree over device batches.

Counterpart of cockroach_tpu/exec/operators.py, for the operators on
TPC-H Q1's path: ScanOp -> MapOp (filter, projection) -> HashAggOp (the
dense route) -> SortOp (in memory). An operator yields Batches on the
device that `collect` names; PyTorch runs eagerly, so there is no jit
and no fused whole-flow program, and nothing reads a device value back
to the host until `collect` consumes the final batch.

Not ported yet (ROADMAP.md queue 1): the sort-based and range-dense
GROUP BY, joins, top-K/limit, the external sort, the fused runner, the
resident scan and stacked fold, and the degradation ladder.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cockroach_tpu_torch import resolve_device
from cockroach_tpu_torch.coldata.arrow import make_unpack, pack_into, pack_layout
from cockroach_tpu_torch.coldata.batch import (
    BOOL, Batch, ColType, Column, Field, FLOAT, INT, Kind, Schema,
    concat_batches,
)
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.ops.agg import (
    AggSpec, dense_aggregate, dense_key_sizes, dense_merge,
)
from cockroach_tpu_torch.ops.expr import (
    Col, decimal_unscale, eval_expr, filter_mask,
)
from cockroach_tpu_torch.ops.sort import SortKey, sort_batch
from cockroach_tpu_torch.util.settings import WORKMEM, Settings


class Operator:
    """Base: a node in the flow tree producing a stream of device Batches."""

    schema: Schema

    def batches(self, device: torch.device) -> Iterator[Batch]:
        raise NotImplementedError


# --------------------------------------------------------------------- scan

class ScanOp(Operator):
    """Source from host chunks (numpy column dicts).

    Each capacity-sized piece of a chunk is packed (narrow Field.wire
    dtypes) into ONE host buffer, pinned when the target is a CUDA device,
    and crosses to the device in one non-blocking copy; the unpack views
    each column's byte range and widens it there."""

    def __init__(self, schema: Schema,
                 chunks: Callable[[], Iterator[Dict[str, np.ndarray]]],
                 capacity: int, table: Optional[str] = None):
        self.schema = schema
        self._chunks = chunks
        self.capacity = capacity
        self.table = table
        self._unpack = make_unpack(schema, capacity)
        self._nbytes = pack_layout(schema, capacity)[1]

    def batches(self, device: torch.device) -> Iterator[Batch]:
        pin = device.type == "cuda"
        for chunk in self._chunks():
            n = len(next(iter(chunk.values())))
            for a in range(0, n, self.capacity):
                piece = {k: v[a:a + self.capacity] for k, v in chunk.items()}
                # a fresh pinned buffer per piece: the caching host
                # allocator does not hand it out again until the copy
                # that reads it has finished
                host = torch.empty(self._nbytes, dtype=torch.uint8,
                                   pin_memory=pin)
                with stats.timed("scan.pack", rows=min(n - a, self.capacity)):
                    m = pack_into(host.numpy(), piece, self.schema,
                                  self.capacity)
                with stats.timed("scan.transfer", bytes=self._nbytes):
                    buf = host.to(device, non_blocking=pin)
                yield self._unpack(buf, m)


# ---------------------------------------------------------------- map

class MapOp(Operator):
    """A chain of filters and projections.

    steps: ("filter", expr) | ("project", [(name, expr)]). A project step
    defines the COMPLETE output column list.
    """

    def __init__(self, child: Operator, steps: Sequence[Tuple[str, object]]):
        self.child = child
        self.steps = list(steps)
        self.schema = child.schema
        for kind, payload in self.steps:
            if kind == "project":
                self.schema = _project_schema(self.schema, payload)

    def _run(self, batch: Batch) -> Batch:
        schema = self.child.schema
        for kind, payload in self.steps:
            if kind == "filter":
                batch = batch.filter(filter_mask(payload, batch, schema))
            else:
                cols = {name: eval_expr(e, batch, schema)
                        for name, e in payload}
                batch = Batch(cols, batch.sel, batch.length)
                schema = _project_schema(schema, payload)
        return batch

    def batches(self, device: torch.device) -> Iterator[Batch]:
        for b in self.child.batches(device):
            yield self._run(b)


def _project_schema(schema: Schema, payload) -> Schema:
    fields = []
    for name, e in payload:
        ty = e.type(schema)
        dict_ref = None
        if isinstance(e, Col) and ty.kind is Kind.STRING:
            dict_ref = schema.field(e.name).dict_ref
        fields.append(Field(name, ty, dict_ref))
    return Schema(fields, schema.dicts)


# ----------------------------------------------------------------- hash agg

class HashAggOp(Operator):
    """Streaming GROUP BY: per-batch partial aggregation folded into one
    accumulator on the device.

    Only the dense route is ported: every GROUP BY column must have a
    small static domain (ops/agg.py dense_key_sizes), so each partial has
    the same D lanes and folds lane-wise with dense_merge, with no
    overflow and no restart. avg decomposes into sum + count so partials
    merge; a wide sum into its two int64 halves."""

    def __init__(self, child: Operator, group_by: Sequence[str],
                 aggs: Sequence[AggSpec]):
        self.child = child
        self.group_by = list(group_by)
        self.user_aggs = list(aggs)
        self.internal: List[AggSpec] = []
        self._avg_parts: Dict[str, Tuple[str, str]] = {}
        for a in aggs:
            if a.func == "avg":
                s_name, c_name = f"__avg_sum_{a.out}", f"__avg_cnt_{a.out}"
                self.internal += [AggSpec("sum", a.col, s_name),
                                  AggSpec("count", a.col, c_name)]
                self._avg_parts[a.out] = (s_name, c_name)
            elif a.func == "sum" and a.wide:
                self.internal += [
                    AggSpec("sum_hi32", a.col, f"{a.out}__hi"),
                    AggSpec("sum_lo32", a.col, f"{a.out}__lo")]
            else:
                self.internal.append(a)
        self.schema = self._infer_schema(child.schema)
        self.dense_sizes = (dense_key_sizes(child.schema, self.group_by)
                            if self.group_by else None)
        if self.dense_sizes is None:
            raise NotImplementedError(
                "HashAggOp: only the dense route (GROUP BY over small "
                "dictionary/bool domains) is ported; sort-based and scalar "
                "aggregation wait (ROADMAP.md queue 1)")

    def _agg_out_type(self, a: AggSpec, schema: Schema) -> ColType:
        if a.func in ("count", "count_star"):
            return INT
        if a.func == "avg":
            return FLOAT
        if a.func in ("bool_and", "bool_or"):
            return BOOL
        return schema.field(a.col).type

    def _infer_schema(self, schema: Schema) -> Schema:
        fields = [schema.field(n) for n in self.group_by]
        for a in self.user_aggs:
            if a.func == "sum" and a.wide:
                fields.append(Field(f"{a.out}__hi", INT))
                fields.append(Field(f"{a.out}__lo", INT))
            else:
                fields.append(Field(a.out, self._agg_out_type(a, schema)))
        return Schema(fields, schema.dicts)

    def _final_project(self, batch: Batch) -> Batch:
        cols = {n: batch.col(n) for n in self.group_by}
        for a in self.user_aggs:
            if a.func == "avg":
                s_name, c_name = self._avg_parts[a.out]
                s, c = batch.col(s_name), batch.col(c_name)
                # (sum / 10^scale) / max(cnt, 1) in float32, in this order,
                # the first division as the JAX package's compiled program
                # does it (ops/expr.py decimal_unscale), so both round alike
                sv = s.values.to(torch.float32)
                ty = self.child.schema.field(a.col).type
                if ty.kind is Kind.DECIMAL:
                    sv = sv * decimal_unscale(ty.scale, sv.device)
                cnt = c.values.clamp(min=1).to(torch.float32)
                cols[a.out] = Column(sv / cnt, s.validity)
            elif a.func == "sum" and a.wide:
                cols[f"{a.out}__hi"] = batch.col(f"{a.out}__hi")
                cols[f"{a.out}__lo"] = batch.col(f"{a.out}__lo")
            else:
                cols[a.out] = batch.col(a.out)
        return Batch(cols, batch.sel, batch.length)

    def batches(self, device: torch.device) -> Iterator[Batch]:
        gb, internal, sizes = self.group_by, self.internal, self.dense_sizes
        acc = None
        for b in self.child.batches(device):
            with stats.timed("agg.fold"):
                part = dense_aggregate(b, gb, internal, sizes)
                acc = part if acc is None else dense_merge(acc, part, gb,
                                                           internal)
        if acc is not None:
            yield self._final_project(acc.compact())


# --------------------------------------------------------------------- sort

class SortOp(Operator):
    """ORDER BY, in memory: compact every batch, concatenate, sort once.
    Input beyond `workmem` needs the external sort, which is not ported
    yet and raises."""

    def __init__(self, child: Operator, keys: Sequence[SortKey],
                 workmem: Optional[int] = None):
        self.child = child
        self.keys = list(keys)
        self.schema = child.schema
        self.workmem = Settings().get(WORKMEM) if workmem is None else workmem

    def batches(self, device: torch.device) -> Iterator[Batch]:
        # device bytes per row, validity excluded (exec/spill.py
        # estimate_row_bytes in the JAX package)
        row_bytes = sum(f.type.np_dtype.itemsize for f in self.schema)
        budget_rows = max(1, self.workmem // max(row_bytes, 1))
        parts: List[Batch] = []
        rows = 0
        for b in self.child.batches(device):
            rows += b.capacity
            if rows > budget_rows:
                raise NotImplementedError(
                    "SortOp: input exceeds workmem and the external sort is "
                    "not ported yet (ROADMAP.md queue 1)")
            parts.append(b.compact())
        if not parts:
            return
        merged = parts[0] if len(parts) == 1 else concat_batches(parts)
        yield sort_batch(merged, self.keys, self.child.schema)


# ------------------------------------------------------------------ walking

def child_operators(op: Operator) -> List[Operator]:
    """Direct children of an operator node."""
    child = getattr(op, "child", None)
    return [child] if child is not None else []


def walk_operators(op: Operator):
    """Pre-order traversal (deduplicated by identity)."""
    seen = set()

    def rec(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        yield node
        for c in child_operators(node):
            yield from rec(c)

    yield from rec(op)


# ------------------------------------------------------------------- sinks

def run_flow(op: Operator, reset: Callable[[], None],
             consume: Callable[[Batch], None], device: torch.device) -> None:
    """Drive the flow to completion on `device`, streaming each output
    batch to `consume`. One tier: an exception propagates."""
    reset()
    for b in op.batches(device):
        consume(b)


def assemble_wide_sums(result: Dict[str, np.ndarray]) -> None:
    """Recombine wide-sum halves in place: for every `<x>__hi`/`<x>__lo`
    pair, add `<x>` as an object array of exact Python ints
    (hi * 2**32 + lo). The halves stay available."""
    for name in [n for n in result
                 if n.endswith("__hi") and not n.endswith("__valid")]:
        base = name[:-4]
        lo = result.get(base + "__lo")
        if lo is None:
            continue
        hi = result[name]
        result[base] = np.array(
            [(int(h) << 32) + int(l) for h, l in zip(hi, lo)], dtype=object)
        result[base + "__valid"] = result[name + "__valid"]


def collect(op: Operator, device=None) -> Dict[str, np.ndarray]:
    """Run the flow on `device` (CUDA unless the caller passes one; raises
    without CUDA) and return host numpy columns, compacted, each with a
    `<col>__valid` sidecar. Wide-sum column pairs are recombined into
    exact Python-int columns."""
    dev = resolve_device(device)
    outs: Dict[str, List[np.ndarray]] = {}
    valids: Dict[str, List[np.ndarray]] = {}

    def reset():
        for f in op.schema:
            outs[f.name] = []
            valids[f.name] = []

    def consume(b: Batch):
        sel = b.sel.cpu().numpy()
        for f in op.schema:
            c = b.col(f.name)
            outs[f.name].append(c.values.cpu().numpy()[sel])
            v = (np.ones(int(sel.sum()), bool) if c.validity is None
                 else c.validity.cpu().numpy()[sel])
            valids[f.name].append(v)

    run_flow(op, reset, consume, dev)
    result = {}
    for f in op.schema:
        result[f.name] = (np.concatenate(outs[f.name])
                          if outs[f.name] else np.zeros(0))
        result[f.name + "__valid"] = (np.concatenate(valids[f.name])
                                      if valids[f.name] else np.zeros(0, bool))
    assemble_wide_sums(result)
    return result

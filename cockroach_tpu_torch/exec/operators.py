"""Streaming operator tree over device batches.

Counterpart of cockroach_tpu/exec/operators.py, for the operators on the
paths of the fifteen TPC-H queries and the SQL front end: ScanOp ->
MapOp (filter, projection) -> HashAggOp (the dense route, the
range-dense route, the sort route with its scalar case, and the grace
GROUP BY), OrderedAggOp, JoinOp (with the grace join), ShrinkOp,
DistinctOp, SortOp (in memory or external), WindowOp, TopKOp, LimitOp
and VectorANNOp (the row engine's RowMapOp is in exec/rowexec.py). An operator
yields Batches on the device that `collect` names. `run_flow` drives a
flow down the degradation ladder: the fused whole-query program of
exec/fused.py (one CUDA graph per query on a card) when the tree fits
its grammar, then these streaming operators, then the same operators
with every workmem clamped to the spill rung's budget.

No operator reads a device value back to the host inside its batch loop.
A deferred capacity or correctness check (aggregate overflow, hash
collision, duplicate build key, ShrinkOp overflow) is a 0-d device flag
OR-ed across batches and read once at the end of the stream; a raised
flag ends the stream with FlowRestart, and `run_flow` widens the
operator and reruns the flow.

A resident ScanOp stacks its packed chunks into one device image after
its first complete pass, shared across plan builds through
exec/scan_cache.py. A HashAggOp over such a scan folds its chunks as it
folds a stream (`agg.fold_stacked`); a JoinOp builds from a whole image
of several chunks in one pass (`join.build_stacked`).

Past `workmem` the blocking operators go out of core (exec/spill.py):
HashAggOp spills its per-batch partials into Grace partitions and
merge-aggregates each, JoinOp partitions both sides and joins partition
pairs, SortOp sorts runs on the device and merges them on the host.
"""

from __future__ import annotations

import contextlib
from typing import (
    Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from cockroach_tpu_torch import resolve_device
from cockroach_tpu_torch.coldata.arrow import (
    make_flat_unpack, make_unpack, pack_into, pack_layout,
)
from cockroach_tpu_torch.coldata.batch import (
    BOOL, Batch, ColType, Column, Field, FLOAT, INT, Kind, Schema,
    concat_batches, mask_padding,
)
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.ops.agg import (
    AggSpec, dense_aggregate, dense_key_sizes, dense_merge, hash_aggregate,
    ordered_aggregate,
)
from cockroach_tpu_torch.ops.expr import (
    Col, decimal_unscale, eval_expr, filter_mask,
)
from cockroach_tpu_torch.ops.sort import SortKey, sort_batch, top_k_batch
from cockroach_tpu_torch.util import cancel as _cancel
from cockroach_tpu_torch.util import retry as _retry
from cockroach_tpu_torch.util import tracing as _tracing
from cockroach_tpu_torch.util.fault import maybe_fail
from cockroach_tpu_torch.util.settings import (
    HBM_CACHE_BUDGET, WORKMEM, Settings,
)


class FlowRestart(Exception):
    """Raised at the end of a stream when a deferred check failed
    (aggregate overflow, hash collision, duplicate build key). The flow
    driver discards the results, widens the failed operator and reruns."""

    def __init__(self, op: "Operator"):
        self.op = op
        super().__init__("flow restart: operator capacity overflow")


def _pow2_at_least(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


def _grow_to(b: Batch, cap: int) -> Batch:
    """A compact batch widened to capacity `cap` (>= its own): the extra
    lanes are dead and zero, and every column carries an explicit
    validity."""
    pad = cap - b.capacity
    sel = torch.arange(cap, device=b.device) < b.length
    cols = {}
    for n, c in b.columns.items():
        zeros = c.values.new_zeros((pad,) + c.values.shape[1:])
        cols[n] = Column(torch.cat([c.values, zeros]),
                         torch.cat([c.valid_mask(), sel.new_zeros(pad)]))
    return Batch(mask_padding(cols, sel), sel, b.length)


def _repack_build(merged: Batch, cap_sum: int) -> Batch:
    """A join's compacted build side (batches whose capacities sum to
    cap_sum) at capacity pow2(cap_sum): the capacity comes from the batch
    capacities (a sync-free bound on the live rows); the lengths stay on
    the device."""
    cap = _pow2_at_least(max(cap_sum, 1))
    return _grow_to(merged, cap) if cap > merged.capacity else merged


class Operator:
    """Base: a node in the flow tree producing a stream of device Batches."""

    schema: Schema

    def batches(self, device: torch.device) -> Iterator[Batch]:
        raise NotImplementedError


# ----------------------------------------------------------------- prefetch

def _prefetch(it: Iterator, device: torch.device, depth: int = 4
              ) -> Iterator:
    """Producer-thread prefetch: the host packs the next pieces and starts
    their copies to the device on a background thread while the consumer
    enqueues its kernels.

    - Closing this generator early (LIMIT, an empty build side) stops the
      producer and closes the source iterator before the close returns.
    - The producer's exception is raised in the consumer.
    - A stopped flow_stopper() refuses the work: the consumer raises
      StopperStopped instead of seeing an empty stream.
    - On CUDA the producer targets `device` explicitly and issues its
      copies on the consumer's current stream, so every copy is ordered
      before the kernels that read it; each piece's pinned host buffer is
      fresh, and the caching host allocator keeps it until its copy has
      run.
    - The producer reports its stages into the consumer's per-query
      stats collection, and continues the consumer's trace: its work is
      a `scan.prefetch` span under the consumer's active span
      (util/tracing.py from_carrier).
    - The consumer polls the queue every 0.1 s and checkpoints the
      statement's cancel context between polls (util/cancel.py), so a
      cancel reaches a consumer waiting on a slow producer; the
      `finally` then stops and joins the producer before the exception
      leaves this generator."""
    import queue as _queue
    import threading

    from cockroach_tpu_torch.util.stop import StopperStopped

    q: "_queue.Queue" = _queue.Queue(maxsize=depth)
    _END = object()
    err: list = []
    stop = threading.Event()
    col = stats.query_active()
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    # the producer's thread-local span stack is empty: hand it the
    # active trace so its retries reach the recording
    carrier = _tracing.tracer().carrier()

    def halted():
        return stop.is_set() or flow_stopper().should_stop

    def produce():
        try:
            for item in it:
                while not halted():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except _queue.Full:
                        continue
                if halted():
                    break
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            if halted():
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            while True:
                try:
                    q.put(_END, timeout=0.1)
                    break
                except _queue.Full:
                    if halted():
                        break

    def produce_tracked():
        try:
            with flow_stopper().task("scan-prefetch"), \
                    stats.query_stats(col) if col is not None \
                    else contextlib.nullcontext(), \
                    _tracing.tracer().from_carrier(carrier, "scan.prefetch") \
                    if carrier is not None else contextlib.nullcontext():
                if stream is None:
                    produce()
                    return
                with torch.cuda.device(device), torch.cuda.stream(stream):
                    assert torch.cuda.current_stream(device) == stream
                    produce()
        except StopperStopped as e:
            # refused after stop(): deliver the error and the end of the
            # stream, so the consumer raises instead of blocking
            err.append(e)
            q.put(_END)

    t = threading.Thread(target=produce_tracked, daemon=True)
    t.start()
    try:
        while True:
            # timeout-poll instead of a bare blocking get: a cancel must
            # reach a consumer stuck behind a stalled producer (the
            # checkpoint is a no-op when no statement is active here)
            try:
                item = q.get(timeout=0.1)
            except _queue.Empty:
                _cancel.checkpoint()
                continue
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # stop the producer and wait for it: a put blocked on the full
        # queue is freed by draining it, and the source iterator is
        # closed before the consumer goes on
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.01)
            except _queue.Empty:
                pass


def _read_ahead(it: Iterator, depth: int = 2) -> Iterator:
    """Double-buffered pull: keep `depth` items taken ahead of the
    consumer. An item whose production starts a non-blocking copy from
    pinned memory (exec/spill.py BlockSource) then copies while the
    consumer's kernels for the item before it run. Same thread, no
    queue; closing this generator closes the source."""
    from collections import deque

    buf: "deque" = deque()
    it = iter(it)
    try:
        while True:
            while len(buf) < depth:
                try:
                    buf.append(next(it))
                except StopIteration:
                    while buf:
                        yield buf.popleft()
                    return
            yield buf.popleft()
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


_flow_stopper = None


def flow_stopper():
    """Process stopper owning the flow runtime's background threads
    (prefetch producers); `flow_stopper().stop()` drains them."""
    global _flow_stopper
    if _flow_stopper is None:
        from cockroach_tpu_torch.util.stop import Stopper

        _flow_stopper = Stopper()
    return _flow_stopper


# --------------------------------------------------------------------- scan

_hbm_cache_monitor = None


def hbm_cache_monitor():
    """Process-wide monitor of the device memory resident scans hold,
    budgeted by `storage.hbm_cache_bytes` (the analog of the reference's
    block cache sizing, util/mon/bytes_usage.go:174)."""
    global _hbm_cache_monitor
    if _hbm_cache_monitor is None:
        from cockroach_tpu_torch.util.mon import BytesMonitor

        _hbm_cache_monitor = BytesMonitor(
            "hbm-table-cache", budget=Settings().get(HBM_CACHE_BUDGET))
    return _hbm_cache_monitor


def _device_key(device: torch.device) -> tuple:
    """The device an image lives on, with its index resolved."""
    index = device.index
    if index is None and device.type == "cuda":
        index = torch.cuda.current_device()
    return (device.type, index)


class ScanImage(NamedTuple):
    """A scan's chunks stacked on one device: `bufs` (N, nbytes) uint8,
    `ms` (N,) int32 live rows per chunk on the device, and the same
    counts as host ints (`ms_host`)."""

    bufs: torch.Tensor
    ms: torch.Tensor
    ms_host: Tuple[int, ...]


class ScanOp(Operator):
    """Source from host chunks (numpy column dicts).

    Each capacity-sized piece of a chunk is packed (narrow Field.wire
    dtypes) into ONE host buffer, pinned when the target is a CUDA device,
    and crosses to the device in one non-blocking copy, on a prefetch
    thread (_prefetch); the unpack views each column's byte range and
    widens it there.

    With `resident=True` the first COMPLETE pass stacks its device
    buffers into one ScanImage, accounted against `monitor` (by default
    hbm_cache_monitor()), and later passes read its chunks, so warm runs
    never pack or copy; a consumer that stops early (LIMIT) pins
    nothing. When the budget runs out the scan stays streaming-only, on
    the same device. With `cache_key` set (Catalog.scan_cache_key) the
    image is shared through the process-wide ScanImageCache
    (exec/scan_cache.py), which then owns its accounting: a fresh plan
    build over the same data borrows it with no pack and no copy. The
    port's ScanOp learns its device in batches(), so it appends the
    device to the key; an image is never borrowed on another device, and
    a run on another device drops this op's image and streams again.

    The unpacked columns are views of the image where the wire dtype is
    the device dtype: nothing downstream writes a column in place."""

    def __init__(self, schema: Schema,
                 chunks: Callable[[], Iterator[Dict[str, np.ndarray]]],
                 capacity: int, resident: bool = False, monitor=None,
                 cache_key: Optional[tuple] = None,
                 table: Optional[str] = None):
        self.schema = schema
        self._chunks = chunks
        self.capacity = capacity
        self.resident = resident
        self.cache_key = cache_key
        self.table = table
        self._monitor = monitor
        self._device: Optional[torch.device] = None  # where the image is
        self._stacked: Optional[ScanImage] = None
        self._stacked_account = None
        self._unpack = make_unpack(schema, capacity)
        self._flat_unpack = make_flat_unpack(schema, capacity)
        self._nbytes = pack_layout(schema, capacity)[1]

    def _image_key(self, device: torch.device) -> tuple:
        return tuple(self.cache_key) + (_device_key(device),)

    def _own_device(self, device: torch.device) -> None:
        """A run on another device than the image's drops the image."""
        if self._device is not None \
                and _device_key(self._device) != _device_key(device):
            self.evict()

    def has_image(self, device: torch.device) -> bool:
        """Whether this scan's image is on `device` (pinned here, or in
        the ScanImageCache), without borrowing it."""
        from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

        if self._stacked is not None and self._device is not None \
                and _device_key(self._device) == _device_key(device):
            return True
        return (self.cache_key is not None
                and scan_image_cache().contains(self._image_key(device)))

    def stacked_image(self, device: torch.device) -> Optional[ScanImage]:
        """This scan's image on `device`, pinned or borrowed from the
        ScanImageCache; None when there is none (a scan that is not
        resident, or has made no complete pass, or outran its budget)."""
        self._own_device(device)
        if self._stacked is None and self.cache_key is not None:
            self._borrow_cached(device)
        return self._stacked

    def prime_image(self, device: torch.device) -> Optional[ScanImage]:
        """This scan's image on `device` for one fused run (exec/fused.py):
        the pinned or borrowed image, else one complete pass, which pins
        the image when the scan is resident and within its budget, and is
        otherwise stacked for this call only (the JAX package's
        ScanOp.stacked_image, which pays the copies on every call of a
        non-resident scan). None for an empty scan."""
        image = self.stacked_image(device)
        if image is not None:
            return image
        pieces = list(self._raw_stream(device))
        image = self.stacked_image(device)
        if image is not None or not pieces:
            return image
        return self._stack(device, pieces)

    def _raw_stream(self, device: torch.device) -> Iterator:
        """The scan's pieces on `device` as (uint8 buffer, live rows):
        the image's chunks, else a pass that packs and copies (and pins
        its pieces as the image when resident and complete). The
        accounting and the stacking run here, in the consumer's
        thread."""
        from cockroach_tpu_torch.util.mon import BudgetExceededError

        image = self.stacked_image(device)
        if image is not None:
            for i, m in enumerate(image.ms_host):
                yield image.bufs[i], m
            return
        acct = None
        if self.resident:
            acct = (self._monitor or hbm_cache_monitor()).make_account()
        pieces: list = []
        complete = False
        stream = _prefetch(self._pack_stream(device), device)
        try:
            for item in stream:
                if acct is not None:
                    try:
                        acct.grow(self._nbytes)
                        pieces.append(item)
                    except BudgetExceededError:
                        acct.close()
                        acct, pieces = None, []
                yield item
            complete = True
        finally:
            stream.close()  # an early exit stops the producer here
            if acct is not None:
                if complete and pieces:
                    # only a COMPLETE pass becomes the resident image
                    self._pin(device, pieces, acct)
                else:
                    acct.close()

    def _pack_stream(self, device: torch.device) -> Iterator:
        """Pack each piece into a fresh host buffer and start its copy."""
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

                def transfer(host=host):
                    maybe_fail("scan.transfer")
                    return host.to(device, non_blocking=pin)

                with stats.timed("scan.transfer", bytes=self._nbytes):
                    buf = _retry.with_retry(transfer, name="scan.transfer")
                yield buf, m

    def _pin(self, device: torch.device, pieces: list, acct) -> None:
        """Stack a complete pass's pieces into the image, which takes
        over the pass's account (grown by the `ms` array): one copy is
        pinned, not two. With a cache key the ScanImageCache owns the
        image and its accounting, unless it refuses it."""
        from cockroach_tpu_torch.util.mon import BudgetExceededError

        try:
            acct.grow(4 * len(pieces))
        except BudgetExceededError:
            acct.close()
            return
        try:
            image = self._stack(device, pieces)
        except BaseException:
            acct.close()
            raise
        if self.cache_key is not None:
            from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

            if scan_image_cache().put(self._image_key(device), image,
                                      acct.used):
                acct.close()
                acct = None
        self._stacked, self._stacked_account = image, acct
        self._device = device

    def _stack(self, device: torch.device, pieces: list) -> ScanImage:
        """One ScanImage of a pass's (buffer, live rows) pieces."""
        ms_host = tuple(m for _, m in pieces)
        pin = device.type == "cuda"

        def stack():
            maybe_fail("scan.stack")
            bufs = torch.stack([b for b, _ in pieces])
            # a pinned source keeps the copy from waiting on the queue
            ms = torch.tensor(ms_host, dtype=torch.int32)
            ms = (ms.pin_memory() if pin else ms).to(device,
                                                     non_blocking=pin)
            return bufs, ms

        with _tracing.child_span("scan.stack", chunks=len(pieces)), \
                stats.timed("scan.stack", bytes=len(pieces) * self._nbytes):
            bufs, ms = _retry.with_retry(stack, name="scan.stack")
        return ScanImage(bufs, ms, ms_host)

    def evict(self):
        """Drop the resident image and release its accounting (a borrowed
        image is only un-referenced; the shared copy stays until the
        cache evicts or invalidates it)."""
        self._stacked = None
        if self._stacked_account is not None:
            self._stacked_account.close()
            self._stacked_account = None
        self._device = None

    def _borrow_cached(self, device: torch.device) -> Optional[ScanImage]:
        """Adopt the shared image for this scan's key on `device`."""
        from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

        hit = scan_image_cache().get(self._image_key(device))
        if hit is None:
            return None
        self._stacked, self._device = hit, device
        return hit

    def batches(self, device: torch.device) -> Iterator[Batch]:
        for buf, m in self._raw_stream(device):
            yield self._unpack(buf, m)


def _source_scan(op: Operator):
    """(the MapOps from `op` down, the ScanOp under them) when `op`'s
    chain is MapOp* -> ScanOp; None otherwise."""
    maps: List[MapOp] = []
    while isinstance(op, MapOp):
        maps.append(op)
        op = op.child
    return (maps, op) if isinstance(op, ScanOp) else None


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
        # the expressions' dictionary tables, built once per device
        # (ops/expr.py Tables)
        self._tables: Dict[tuple, object] = {}

    def _run(self, batch: Batch) -> Batch:
        schema = self.child.schema
        for kind, payload in self.steps:
            if kind == "filter":
                batch = batch.filter(filter_mask(payload, batch, schema,
                                                 self._tables))
            else:
                cols = {name: eval_expr(e, batch, schema, self._tables)
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

_MERGE_FUNC = {"sum": "sum", "count": "sum", "count_star": "sum",
               "sum_hi32": "sum", "sum_lo32": "sum",
               "min": "min", "max": "max", "bool_and": "bool_and",
               "bool_or": "bool_or", "any_not_null": "any_not_null"}


def _fold_step(acc: Batch, part: Batch, acc_cap: int, group_by, merge_aggs,
               seed: int = 0):
    """(acc, part) -> (acc', overflow): merge-aggregate the concatenated
    pair and keep the first acc_cap lanes. Live groups are a prefix, so
    nothing is lost unless the groups outnumber acc_cap — reported by the
    0-d overflow flag, which also carries the hash-collision bit (both
    are answered by the same widen-and-rerun)."""
    merged, coll = hash_aggregate(concat_batches([acc, part]), group_by,
                                  merge_aggs, seed=seed, method="hash",
                                  with_flag=True)
    overflow = (merged.length > acc_cap) | coll
    sel = torch.arange(acc_cap, device=merged.device) < merged.length
    length = torch.clamp(merged.length, max=acc_cap)
    cols = {n: Column(c.values[:acc_cap], c.valid_mask()[:acc_cap])
            for n, c in merged.columns.items()}
    return Batch(mask_padding(cols, sel), sel, length), overflow


class HashAggOp(Operator):
    """Streaming GROUP BY: per-batch partial aggregation folded into one
    accumulator on the device.

    Dense route: every GROUP BY column has a small static domain (ops/agg.py
    dense_key_sizes), so each partial has the same D lanes and folds
    lane-wise with dense_merge (K1 on CUDA), with no overflow and no
    restart.

    Range-dense route: given `dense_range=(lo, hi)` for a single integer
    key (span at most 2^22, aggregates of ops/agg.py RANGE_DENSE_FUNCS),
    each batch scatters into span lanes (range_dense_aggregate) and the
    partials merge lane-wise. A key outside the range raises the deferred
    flag, and widen() turns the route off.

    Sort route (every other GROUP BY, and the scalar aggregate): the
    partial is hash_aggregate(method="hash") of the batch; the fold
    re-aggregates (accumulator ++ partial) with the merge functions and
    keeps `acc_cap` = pow2(batch capacity x expansion) lanes. Group
    overflow and hash collisions OR into one device flag, read once after
    the final batch; a raised flag ends the stream with FlowRestart, and
    widen() doubles `expansion` and re-seeds the hash.

    Grace route: an accumulator past `workmem` is never allocated. The
    partials spill into DEFAULT_NUM_PARTITIONS x expansion host
    partitions by group-key hash (exec/spill.py), and each partition
    merge-aggregates on the device at a fold capacity sized to the
    budget; a partition that overflows reruns alone at twice the
    capacity, up to 4 attempts, before the flow restarts.

    avg decomposes into sum + count so partials merge; a wide sum into its
    two int64 halves."""

    def __init__(self, child: Operator, group_by: Sequence[str],
                 aggs: Sequence[AggSpec], expansion: int = 1,
                 workmem: Optional[int] = None,
                 dense_range: Optional[Tuple[int, int]] = None):
        from cockroach_tpu_torch.ops.agg import RANGE_DENSE_FUNCS

        self.child = child
        self.group_by = list(group_by)
        self.user_aggs = list(aggs)
        self.expansion = expansion  # acc capacity multiplier (restart doubles)
        self.seed = 0       # hash-grouping seed (restart re-seeds)
        self.workmem = Settings().get(WORKMEM) if workmem is None else workmem
        # the single integer key's value range [lo, hi]: the
        # direct-address route; a stale range raises the deferred flag
        # and widen() turns the route off
        self.dense_range = dense_range
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
        # the rows the fold accumulator holds and the grace path spills
        self._internal_schema = Schema(
            [child.schema.field(n) for n in self.group_by]
            + [Field(a.out, self._agg_out_type(a, child.schema))
               for a in self.internal],
            child.schema.dicts)
        self._merge_aggs = tuple(AggSpec(_MERGE_FUNC[a.func], a.out, a.out)
                                 for a in self.internal)
        self.dense_sizes = (dense_key_sizes(child.schema, self.group_by)
                            if self.group_by else None)
        self._range_dense: Optional[Tuple[int, int]] = None
        if (self.dense_sizes is None and dense_range is not None
                and len(self.group_by) == 1):
            lo, hi = dense_range
            span = hi - lo + 1
            kdt = child.schema.field(self.group_by[0]).type.dtype
            if (all(a.func in RANGE_DENSE_FUNCS for a in self.internal)
                    and 0 < span <= (1 << 22)
                    and not kdt.is_floating_point and kdt != torch.bool):
                self._range_dense = (int(lo), int(span))
        # the fused tracer's fast-path ladders (exec/fused.py): the
        # group-join collapse's key width step, and the int-key GROUP
        # BY's wide keys and its switch; they ride the fused config key
        self._gj_bump = 0
        self._ia_ok = True
        self._ia_wide = False

    def widen(self):
        """FlowRestart remedy: a tripped range-dense flag (stale range)
        turns that route off; otherwise double the accumulator expansion
        (group overflow) and re-seed the key hash (collision)."""
        if self._range_dense is not None:
            self._range_dense = None
            self.dense_range = None
            return
        self.expansion *= 2
        self.seed += 1

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

    def _partial(self, batch: Batch):
        """(partial aggregate of one batch, its 0-d collision flag)."""
        return hash_aggregate(batch, self.group_by, self.internal,
                              seed=self.seed, method="hash", with_flag=True)

    def _merge_partial(self, batch: Batch):
        """A batch of partials re-aggregated with the merge functions,
        with its 0-d collision flag (the grace path's per-partition
        partial)."""
        return hash_aggregate(batch, self.group_by, self._merge_aggs,
                              seed=self.seed, method="hash", with_flag=True)

    def _dense_batches(self, device: torch.device) -> Iterator[Batch]:
        gb, internal, sizes = self.group_by, self.internal, self.dense_sizes
        acc = None
        for b in self.child.batches(device):
            with stats.timed("agg.fold"):
                part = dense_aggregate(b, gb, internal, sizes)
                acc = part if acc is None else dense_merge(acc, part, gb,
                                                           internal)
        if acc is not None:
            yield self._final_project(acc.compact())

    def _range_dense_batches(self, device: torch.device) -> Iterator[Batch]:
        from cockroach_tpu_torch.ops.agg import range_dense_aggregate

        gb, internal = self.group_by, self.internal
        lo, span = self._range_dense
        acc, flag = None, None
        for b in self.child.batches(device):
            with stats.timed("agg.fold"):
                part, fl = range_dense_aggregate(b, gb[0], lo, span,
                                                 internal)
                acc = part if acc is None else dense_merge(acc, part, gb,
                                                           internal)
                flag = fl if flag is None else flag | fl
        if acc is not None:
            yield self._final_project(acc)
            # the deferred check: ONE readback; a stale range reruns the
            # flow with the route off
            if bool(flag):
                raise FlowRestart(self)

    def _empty_scalar(self, device: torch.device) -> Batch:
        """The scalar aggregate over no rows: one row (count 0, NULL
        sums)."""
        cols = {f.name: Column(torch.zeros(1, dtype=f.type.dtype,
                                           device=device))
                for f in self.child.schema}
        empty = Batch(cols, torch.zeros(1, dtype=torch.bool, device=device),
                      torch.zeros((), dtype=torch.int32, device=device))
        return hash_aggregate(empty, self.group_by, self.internal)

    def batches(self, device: torch.device) -> Iterator[Batch]:
        from cockroach_tpu_torch.exec.spill import estimate_row_bytes

        row_bytes = estimate_row_bytes(self._internal_schema)
        # over MapOp* -> a resident ScanOp the stream below reads the
        # scan's image chunk by chunk: the JAX package's stacked fold,
        # which it compiles as one program (and declines for the
        # range-dense route and past workmem), is this same loop eagerly
        src = _source_scan(self.child)
        stacked = src is not None and src[1].has_image(device)
        if stacked and self.dense_sizes is None:
            acc_cap = _pow2_at_least(src[1].capacity * self.expansion)
            stacked = self._range_dense is None and not (
                self.group_by and acc_cap * row_bytes > self.workmem)
        if stacked:
            stats.add("agg.fold_stacked")
        if self.dense_sizes is not None:
            yield from self._dense_batches(device)
            return
        if self._range_dense is not None:
            yield from self._range_dense_batches(device)
            return
        acc: Optional[Batch] = None
        overflow = None
        acc_cap = 0
        it = self.child.batches(device)
        for b in it:
            with stats.timed("agg.fold"):
                part, coll = self._partial(b)
                if acc is None:
                    acc_cap = _pow2_at_least(part.capacity * self.expansion)
                    if self.group_by and acc_cap * row_bytes > self.workmem:
                        # the accumulator would pass the budget: go out
                        # of core before allocating it
                        yield from self._grace_batches(part, it, device)
                        return
                    overflow = (part.length > acc_cap) | coll
                    acc = _grow_to(part, acc_cap)
                else:
                    acc, ovf = _fold_step(acc, part, acc_cap, self.group_by,
                                          self._merge_aggs, seed=self.seed)
                    overflow = overflow | ovf | coll
        if acc is None:
            if not self.group_by:
                yield self._final_project(self._empty_scalar(device))
            return  # GROUP BY over no rows: no groups
        yield self._final_project(acc)
        # the deferred check: ONE readback, after the consumer has taken
        # the final batch
        if self.group_by and bool(overflow):
            raise FlowRestart(self)

    def _grace_batches(self, first_part: Batch, rest: Iterator[Batch],
                       device: torch.device) -> Iterator[Batch]:
        """Out-of-core GROUP BY: spill the per-batch partials (already
        key-compressed) into host partitions by group-key hash, then
        merge-aggregate each partition on the device. Partitions share no
        keys, so the union of the per-partition results is exact (the
        reference's external hash aggregator, colexecdisk, via
        hashBasedPartitioner)."""
        from cockroach_tpu_torch.exec import spill as _spill

        stats.add("agg.grace_spill")
        row_bytes = _spill.estimate_row_bytes(self._internal_schema)
        # the per-partition fold capacity, sized to the budget
        cap = 1 << 10
        while cap * 2 * row_bytes <= self.workmem and cap < (1 << 22):
            cap *= 2
        P = _spill.DEFAULT_NUM_PARTITIONS * self.expansion
        gp = _spill.GracePartitioner(self.group_by, num_partitions=P)
        try:
            gp.consume(first_part)
            for b in rest:
                gp.consume(self._partial(b)[0])
            for p in range(P):
                if gp.partitions[p].n_rows == 0:
                    continue
                # a partition whose groups pass its fold capacity reruns
                # ALONE at twice the capacity: spilled blocks replay, so
                # the rest of the flow does not restart
                local_cap = cap
                for attempt in range(4):
                    src = _spill.BlockSource(gp.partitions[p],
                                             self._internal_schema, cap)
                    acc = None
                    overflow = None
                    for b in src.batches(device):
                        with stats.timed("agg.fold"):
                            part, coll = self._merge_partial(b)
                            if acc is None:
                                overflow = (part.length > local_cap) | coll
                                acc = _grow_to(part, local_cap)
                            else:
                                acc, ovf = _fold_step(
                                    acc, part, local_cap, self.group_by,
                                    self._merge_aggs, seed=self.seed)
                                overflow = overflow | ovf | coll
                    if acc is None:
                        break
                    if bool(overflow):
                        # bounded growth (at most 8 x the budgeted fold
                        # capacity); past that the flow restarts with
                        # more partitions
                        if attempt == 3:
                            raise FlowRestart(self)
                        local_cap *= 2
                        stats.add("agg.grace_partition_retry")
                        continue
                    yield self._final_project(acc)
                    break
        finally:
            gp.close()


class OrderedAggOp(HashAggOp):
    """Streaming GROUP BY over input whose equal keys arrive in contiguous
    runs (SortOp output): the per-batch partial skips the sort
    (ops/agg.py method="ordered"). Runs that straddle batches re-merge in
    the shared fold. The planner picks this when the child's ordering
    covers the group keys. Dense keys still take the dense route, as in
    the JAX package."""

    def _partial(self, batch: Batch):
        return (ordered_aggregate(batch, self.group_by, self.internal),
                torch.zeros((), dtype=torch.bool, device=batch.device))


# -------------------------------------------------------------------- join

class JoinOp(Operator):
    """Streaming equi-join: materialize the build side (right child) on the
    device, stream the probe side.

    The build is held in memory: each build batch is compacted, and the
    parts are repacked once into one batch of capacity pow2(sum of the
    batch capacities). It starts in mode "unique", the payload-carry sort
    join for unique build keys (ops/sortjoin.py), which the streaming
    probe runs as "unique-mat", the row-matrix sort join, as the JAX
    package's JoinOp does (the fused tier runs the carry). widen() walks
    unique -> unique-mat -> expand -> doubled output expansion when the
    deferred flag (duplicate build key, out-of-range key, a carry payload
    past 62 bits, expansion overflow) is raised at the end of the probe
    stream. Right/full-outer joins emit the unmatched build rows after
    the stream.

    Out of core: when the build passes `workmem` while it materializes,
    the join switches to Grace partitioning mid-build (exec/spill.py):
    what is buffered and the rest of both streams go into host
    partitions by join-key hash, and each partition pair joins on the
    device in a sub-JoinOp one `grace_level` deeper (the reference's
    diskSpiller + hashBasedPartitioner, disk_spiller.go:208,
    hash_based_partitioner.go:115). At MAX_GRACE_LEVELS the build stays
    in memory."""

    def __init__(self, probe: Operator, build: Operator,
                 probe_on: Sequence[str], build_on: Sequence[str],
                 how: str = "inner", expansion: int = 1,
                 workmem: Optional[int] = None, grace_level: int = 0,
                 build_mode: str = "unique"):
        self.probe, self.build = probe, build
        self.probe_on, self.build_on = list(probe_on), list(build_on)
        self.how = how
        self.expansion = expansion      # output capacity multiplier
        self.build_mode = build_mode    # widen() walks the ladder from here
        self.workmem = Settings().get(WORKMEM) if workmem is None else workmem
        self.grace_level = grace_level
        if how in ("semi", "anti"):
            self.schema = probe.schema
        else:
            overlap = set(probe.schema.names()) & set(build.schema.names())
            if overlap:
                raise ValueError(f"join column collision: {overlap}")
            dicts = dict(build.schema.dicts)
            dicts.update(probe.schema.dicts)
            self.schema = Schema(
                list(probe.schema.fields) + list(build.schema.fields), dicts)

    def _budget_rows(self) -> int:
        from cockroach_tpu_torch.exec.spill import estimate_row_bytes

        return max(1, self.workmem
                   // max(estimate_row_bytes(self.build.schema), 1))

    def _try_stacked_build(self, device: torch.device) -> Optional[Batch]:
        """The build side from a resident image in one pass, when the
        build chain is MapOp* -> ScanOp and the scan's image is on the
        device: flat-unpack the whole stack (coldata/arrow.py
        make_flat_unpack), run the map chain once, compact, and repack to
        exactly the batch the chunked build gives, row for row. None when
        the scan has no image or one chunk, and when the build could pass
        `workmem` (the chunked path then streams into the grace join).
        Counts `join.build_stacked`."""
        from cockroach_tpu_torch.exec.spill import MAX_GRACE_LEVELS

        src = _source_scan(self.build)
        if src is None:
            return None
        maps, scan = src
        image = scan.stacked_image(device)
        if image is None or len(image.ms_host) < 2:
            # one chunk: the chunked build takes it as it is, with no
            # concatenation to save
            return None
        cap_sum = len(image.ms_host) * scan.capacity
        if (self.grace_level < MAX_GRACE_LEVELS
                and cap_sum > self._budget_rows()):
            return None
        runs = [m._run for m in reversed(maps)]
        with stats.timed("join.build"):
            b = scan._flat_unpack(image.bufs, image.ms)
            for run in runs:
                b = run(b)
            built = _repack_build(b.compact(), cap_sum)
        stats.add("join.build_stacked")
        return built

    def _materialize_build(self, device: torch.device):
        """-> ("mem", the whole build side as one compact batch on the
        device, or None when it has no batches) or ("grace", a
        GracePartitioner holding the whole build stream)."""
        from cockroach_tpu_torch.exec import spill as _spill

        built = self._try_stacked_build(device)
        if built is not None:
            return "mem", built
        budget_rows = self._budget_rows()
        # at the deepest level the partition stays in memory, best effort
        # (the reference likewise stops repartitioning on skew)
        spilling_allowed = self.grace_level < _spill.MAX_GRACE_LEVELS
        parts: List[Batch] = []
        cap_sum = 0
        # join.build times this operator's own work only: the child
        # stream's production bills its own stages. The read-ahead pulls
        # the next batch (a replayed partition's copy) early
        it = _read_ahead(self.build.batches(device))
        for b in it:
            with stats.timed("join.build"):
                part = b.compact()
            # the budget decision reads capacities (a sync-free bound on
            # the live rows), before the build grows past it
            if spilling_allowed and cap_sum + part.capacity > budget_rows:
                gp = _spill.GracePartitioner(
                    self.build_on,
                    num_partitions=_spill.DEFAULT_NUM_PARTITIONS,
                    level=self.grace_level)
                try:
                    with stats.timed("join.build"):
                        for p in parts:
                            gp.consume(p)
                        gp.consume(part)
                    parts = []
                    for rest in it:
                        with stats.timed("join.build"):
                            gp.consume(rest)
                except BaseException:
                    # a FlowRestart (or fault) from the build stream
                    # mid-partitioning: release the spill accounting
                    # before the flow unwinds
                    gp.close()
                    raise
                return "grace", gp
            parts.append(part)
            cap_sum += part.capacity
        if not parts:
            return "mem", None
        if len(parts) == 1:
            return "mem", _repack_build(parts[0], cap_sum)
        with stats.timed("join.build"):
            return "mem", _repack_build(concat_batches(parts).compact(),
                                        cap_sum)

    def _grace_batches(self, build_gp, device: torch.device
                       ) -> Iterator[Batch]:
        """Partition the probe stream the same way, then join partition
        pairs on the device: rows can only match within their shared
        hash partition, so this is correct for every join type."""
        from cockroach_tpu_torch.exec import spill as _spill

        # the try starts BEFORE the probe partitioning: a FlowRestart (or
        # fault) from the probe stream must not leak either partitioner's
        # host-spill accounting
        probe_gp = _spill.GracePartitioner(
            self.probe_on, num_partitions=build_gp.P, level=self.grace_level)
        try:
            # the partition sort puts the live rows first in their own
            # order, as compacting first would
            for b in self.probe.batches(device):
                probe_gp.consume(b)
            # replay partitions in batches that each fit the budget, so
            # every recursion level makes progress toward an in-memory
            # join
            budget_rows = self._budget_rows()
            parent_cap = getattr(self.probe, "capacity", None) or 1 << 16
            capacity = 256
            while capacity * 2 <= budget_rows and capacity < parent_cap:
                capacity *= 2
            for p in range(build_gp.P):
                probe_src = _spill.BlockSource(
                    probe_gp.partitions[p], self.probe.schema, capacity)
                build_src = _spill.BlockSource(
                    build_gp.partitions[p], self.build.schema, capacity)
                sub = JoinOp(probe_src, build_src, self.probe_on,
                             self.build_on, how=self.how,
                             expansion=self.expansion, workmem=self.workmem,
                             grace_level=self.grace_level + 1,
                             build_mode=self.build_mode)
                # the partition's output is buffered, so a FlowRestart
                # reruns just this partition
                for attempt in range(9):
                    try:
                        out = list(sub.batches(device))
                        break
                    except FlowRestart:
                        if attempt == 8:
                            raise
                        sub.widen()
                yield from out
        finally:
            probe_gp.close()
            build_gp.close()

    def widen(self):
        """FlowRestart remedy — descend the mode ladder: payload-carry
        unique ("unique", flags when the packed payload passes 62 bits)
        -> row-matrix unique ("unique-mat", flags on duplicate build keys)
        -> expand -> doubled output expansion. It reads the EFFECTIVE
        mode: a join statically downgraded (a wide build side) already
        runs expand, so its first restart widens."""
        from cockroach_tpu_torch.ops.join import effective_build_mode

        eff = effective_build_mode(self.build_mode, self.build.schema.names(),
                                   self.build_on)
        if eff == "unique":
            self.build_mode = "unique-mat"
        elif eff == "unique-mat":
            self.build_mode = "expand"
        else:
            self.build_mode = "expand"
            self.expansion *= 2

    def batches(self, device: torch.device) -> Iterator[Batch]:
        from cockroach_tpu_torch.ops.join import (
            _null_columns, effective_build_mode, hash_join_prepared,
            prepare_build,
        )

        kind, build = self._materialize_build(device)
        if kind == "grace":
            stats.add("join.grace_spill")
            yield from self._grace_batches(build, device)
            return
        per_batch_how = {"outer": "left", "right": "inner"}.get(self.how,
                                                                 self.how)
        if build is None:
            if self.how in ("inner", "semi", "right"):
                return
            for b in self.probe.batches(device):
                if self.how == "anti":
                    yield b
                else:  # left/outer: every probe row unmatched
                    cols = dict(b.columns)
                    for f in self.build.schema:
                        cols[f.name] = Column(
                            torch.zeros(b.capacity, dtype=f.type.dtype,
                                        device=device),
                            torch.zeros(b.capacity, dtype=torch.bool,
                                        device=device))
                    yield Batch(cols, b.sel, b.length)
            return

        mode = effective_build_mode(self.build_mode, self.build.schema.names(),
                                    self.build_on)
        if mode == "unique":
            # the streaming probe takes the row-matrix join, as the JAX
            # package's does: a carry payload-width restart would rerun
            # the whole flow (the fused tier keeps the carry)
            mode = "unique-mat"
        with stats.timed("join.build"):
            bt = prepare_build(build, self.build_on, mode=mode)
        track_r = self.how in ("right", "outer")
        matched_r = torch.zeros(build.capacity, dtype=torch.bool,
                                device=device)
        overflow = torch.zeros((), dtype=torch.bool, device=device)
        for b in self.probe.batches(device):
            res = hash_join_prepared(b, bt, self.probe_on, self.build_on,
                                     how=per_batch_how,
                                     out_capacity=b.capacity * self.expansion,
                                     track_build=track_r)
            overflow = overflow | res.overflow
            if track_r:
                matched_r = matched_r | res.matched_build
            yield res.batch
        # the deferred check: ONE readback at the end of the stream
        if bool(overflow):
            raise FlowRestart(self)
        if track_r:
            unmatched = build.sel & ~matched_r
            rows = torch.arange(build.capacity, device=device)
            cols = {f.name: Column(
                torch.zeros(build.capacity, dtype=f.type.dtype, device=device),
                torch.zeros(build.capacity, dtype=torch.bool, device=device))
                for f in self.probe.schema}
            cols.update(_null_columns(build, rows, unmatched))
            yield Batch(cols, unmatched, unmatched.sum(dtype=torch.int32))


# --------------------------------------------------------------------- sort

class SortOp(Operator):
    """ORDER BY. In memory when the input fits `workmem` (compact every
    batch, concatenate, sort once); otherwise an EXTERNAL sort: each
    batch is sorted on the device and read back with its sorted integer
    sort keys (ops/sort.py lex_keys) into host RAM, and the host merges
    the sorted runs with a binary tree of linear two-way merges over a
    packed 64-bit key (`_merge_sorted_runs`), then emits ordered
    capacity-sized batches (the reference's external sort shape,
    colexecdisk/external_sort.go): the device does the O(n log n) work,
    the host the O(n log R) merge."""

    def __init__(self, child: Operator, keys: Sequence[SortKey],
                 workmem: Optional[int] = None):
        self.child = child
        self.keys = list(keys)
        self.schema = child.schema
        self.workmem = Settings().get(WORKMEM) if workmem is None else workmem

    def batches(self, device: torch.device) -> Iterator[Batch]:
        from cockroach_tpu_torch.exec.spill import estimate_row_bytes

        budget_rows = max(1, self.workmem
                          // max(estimate_row_bytes(self.schema), 1))
        parts: List[Batch] = []
        cap_sum = 0
        it = self.child.batches(device)
        for b in it:
            part = b.compact()
            if cap_sum + part.capacity > budget_rows:
                yield from self._external_batches(parts, part, it, device)
                return
            parts.append(part)
            cap_sum += part.capacity
        if not parts:
            return
        merged = parts[0] if len(parts) == 1 else concat_batches(parts)
        yield sort_batch(merged, self.keys, self.child.schema)

    def _external_batches(self, buffered: List[Batch], first: Batch,
                          it: Iterator[Batch], device: torch.device
                          ) -> Iterator[Batch]:
        """The external sort: every run sorted on the device before it
        spills (its batch and its sorted integer keys, one readback
        each: `sort.device_run` times both), the runs merged on the host
        (`sort.host_merge`), and the result replayed in capacity-sized
        batches (`spill.replay`)."""
        from cockroach_tpu_torch.exec import spill as _spill
        from cockroach_tpu_torch.ops.sort import lex_keys

        stats.add("sort.external_spill")
        keys, schema = self.keys, self.child.schema
        acct = _spill.host_spill_monitor().make_account()
        runs: List[Tuple[_spill.SpilledBlock, List[np.ndarray]]] = []
        try:
            def spill_one(b: Batch):
                with stats.timed("sort.device_run"):
                    s = sort_batch(b, keys, schema)
                    lk = lex_keys(s, keys, schema)
                    block = _spill.batch_to_block(s)
                    n = block.n_rows
                    host_keys = [k[:n].cpu().numpy() for k in lk]
                acct.grow(block.nbytes + sum(k.nbytes for k in host_keys))
                stats.add("spill.write", rows=n, bytes=block.nbytes)
                runs.append((block, host_keys))

            for b in buffered:
                spill_one(b)
            spill_one(first)
            for rest in it:
                spill_one(rest)

            with stats.timed("sort.host_merge"):
                order = _merge_sorted_runs(runs)
                total = order.shape[0]
                cols: Dict[str, np.ndarray] = {}
                for f in self.schema:
                    cols[f.name] = np.concatenate(
                        [r[0].values[f.name] for r in runs])[order]
                    vs = [r[0].validity[f.name] for r in runs]
                    if any(v is not None for v in vs):
                        cols["__valid_" + f.name] = np.concatenate([
                            v if v is not None
                            else np.ones(r[0].n_rows, bool)
                            for r, v in zip(runs, vs)])[order]
            cap = getattr(self.child, "capacity", None) or 1 << 16
            for a in range(0, total, cap):
                n = min(cap, total - a)
                chunk = {k: v[a:a + n] for k, v in cols.items()}
                with stats.timed("spill.replay", rows=n, bytes=sum(
                        v.nbytes for v in chunk.values())):
                    out = _spill.upload_chunk(chunk, n, self.schema, cap,
                                              device)
                yield out
        finally:
            acct.close()


def _merge_sorted_runs(runs) -> np.ndarray:
    """Global order over the concatenation of sorted runs.

    runs: [(SpilledBlock, [lexsort key arrays, least-significant first])]
    where each run's rows are ALREADY in key order. Packs all key columns
    into one uint64 per row using their measured ranges, then merges runs
    pairwise with linear searchsorted interleaves (a binary merging
    tree). When the combined key bits exceed 64, one np.lexsort over the
    concatenation — still correct, no longer merge-shaped."""
    n_keys = len(runs[0][1])
    all_keys = [np.concatenate([r[1][i] for r in runs])
                for i in range(n_keys)]
    lengths = [r[0].n_rows for r in runs]
    if sum(lengths) == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum([0] + lengths[:-1])

    bits, los = [], []
    for k in all_keys:  # least-significant first
        lo, hi = int(k.min()), int(k.max())
        span = hi - lo + 1
        bits.append(max(1, int(span - 1).bit_length()))
        los.append(lo)
    if sum(bits) > 64:
        return np.lexsort(all_keys)

    packed = np.zeros(sum(lengths), dtype=np.uint64)
    shift = 0
    for k, b, lo in zip(all_keys, bits, los):
        packed |= (k.astype(np.int64) - lo).astype(np.uint64) << np.uint64(
            shift)
        shift += b

    merged = [(packed[s:s + n], np.arange(s, s + n, dtype=np.int64))
              for s, n in zip(starts, lengths)]
    while len(merged) > 1:
        nxt = []
        for i in range(0, len(merged) - 1, 2):
            (ka, ia), (kb, ib) = merged[i], merged[i + 1]
            # stable two-way merge: a's elements before equal b elements
            pos_a = np.arange(len(ka)) + np.searchsorted(kb, ka, "left")
            pos_b = np.arange(len(kb)) + np.searchsorted(ka, kb, "right")
            k = np.empty(len(ka) + len(kb), dtype=np.uint64)
            idx = np.empty(len(ka) + len(kb), dtype=np.int64)
            k[pos_a], k[pos_b] = ka, kb
            idx[pos_a], idx[pos_b] = ia, ib
            nxt.append((k, idx))
        if len(merged) % 2:
            nxt.append(merged[-1])
        merged = nxt
    return merged[0][1]


class WindowOp(Operator):
    """Window functions over (PARTITION BY, ORDER BY) — the
    colexecwindow analog. Sorts the input by the partition and order keys
    through a SortOp (so the external sort serves it too), then computes
    every window column with ops/window.py over the concatenated,
    compacted sorted result. Output is sorted by (partition, order) — a
    stronger guarantee than SQL requires."""

    def __init__(self, child: Operator, partition_by: Sequence[str],
                 order_by: Sequence[SortKey], specs):
        self.child = child
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.specs = list(specs)
        sort_keys = ([SortKey(c) for c in self.partition_by]
                     + self.order_by)
        self._sorted = SortOp(child, sort_keys) if sort_keys else child
        self.schema = child.schema.extend(
            [Field(s.out, s.out_type(child.schema)) for s in self.specs])

    def _run(self, parts: List[Batch]) -> Batch:
        """The window columns over the sorted batches (the fused tracer
        runs this body over its materialized sorted input)."""
        from cockroach_tpu_torch.ops.window import compute_windows

        whole = (parts[0] if len(parts) == 1
                 else concat_batches(parts)).compact()
        new_cols = compute_windows(whole, self.partition_by, self.order_by,
                                   self.specs, self.child.schema)
        cols = dict(whole.columns)
        cols.update(mask_padding(new_cols, whole.sel))
        return Batch(cols, whole.sel, whole.length)

    def batches(self, device: torch.device) -> Iterator[Batch]:
        parts = list(self._sorted.batches(device))
        if parts:
            yield self._run(parts)


class TopKOp(Operator):
    """ORDER BY + LIMIT k: per-batch top-k, then the top-k of the
    winners."""

    def __init__(self, child: Operator, keys: Sequence[SortKey], k: int):
        self.child = child
        self.keys = list(keys)
        self.k = k
        self.schema = child.schema

    def batches(self, device: torch.device) -> Iterator[Batch]:
        schema = self.child.schema
        winners = [top_k_batch(b, self.keys, self.k, schema)
                   for b in self.child.batches(device)]
        if not winners:
            return
        if len(winners) == 1:
            yield winners[0]
            return
        yield top_k_batch(concat_batches(winners), self.keys, self.k, schema)


class LimitOp(Operator):
    """LIMIT n OFFSET m over the stream in arrival order."""

    def __init__(self, child: Operator, limit: int, offset: int = 0):
        self.child = child
        self.limit = limit
        self.offset = offset
        self.schema = child.schema

    def _take(self, batch: Batch, carry: torch.Tensor):
        # global rank among selected rows across the whole stream
        rank = torch.cumsum(batch.sel, 0, dtype=torch.int32) - 1 + carry
        keep = batch.sel & (rank >= self.offset) & (
            rank < self.offset + self.limit)
        return batch.with_sel(keep), carry + batch.sel.sum(dtype=torch.int32)

    def batches(self, device: torch.device) -> Iterator[Batch]:
        # the selected-rows count rides on the device; the stop check
        # reads the previous batch's count, one batch late, so the value
        # has been computed by the time the host asks for it
        bound = self.offset + self.limit
        carry = torch.zeros((), dtype=torch.int32, device=device)
        prev_carry = None
        for b in self.child.batches(device):
            out, carry = self._take(b, carry)
            yield out
            if prev_carry is not None and int(prev_carry) >= bound:
                return
            prev_carry = carry


class ShrinkOp(Operator):
    """Capacity compaction: the child's whole output, concatenated, packed
    into a small static capacity C. Downstream operators then work on C
    lanes instead of the child's (Q9's semi join against green parts
    keeps about 5% of 6 x 2^20 lineitem lanes; Q18's HAVING keeps a few
    dozen rows of its aggregate's 2^21 lanes).

    It keeps the first C selected lanes in order: a stable argsort of the
    dead-lane mask, then a gather of C rows. More than C selected rows
    set a 0-d overflow flag, read once after the child's stream; a set
    flag raises FlowRestart, and widen() multiplies C by GROWTH."""

    GROWTH = 16

    def __init__(self, child: Operator, capacity: int):
        self.child = child
        self.capacity = capacity
        self.schema = child.schema

    def widen(self):
        self.capacity *= self.GROWTH

    def shrink(self, m: Batch) -> Tuple[Batch, torch.Tensor]:
        """-> (m's first C selected rows as a batch of capacity C, the
        0-d overflow flag). Only the C winning rows are gathered."""
        c = self.capacity
        dev = m.device
        order = torch.argsort((~m.sel).to(torch.uint8), stable=True)
        if m.capacity >= c:
            kidx = order[:c]
        else:
            kidx = torch.cat([order, order.new_zeros(c - m.capacity)])
        length = torch.clamp(m.length, max=c).to(torch.int32)
        sel = torch.arange(c, device=dev) < length
        out = m.gather(kidx, sel=sel, length=length)
        return (Batch(mask_padding(out.columns, sel), sel, length),
                m.length > c)

    def batches(self, device: torch.device) -> Iterator[Batch]:
        parts = list(self.child.batches(device))
        if not parts:
            return
        with stats.timed("shrink"):
            merged = concat_batches(parts) if len(parts) > 1 else parts[0]
            out, overflow = self.shrink(merged)
        # the deferred check: ONE readback, after the child's stream
        if bool(overflow):
            raise FlowRestart(self)
        yield out


class DistinctOp(Operator):
    """Cross-batch DISTINCT: a GROUP BY of the keys (all columns when
    none are given) with no aggregates."""

    def __init__(self, child: Operator, keys: Optional[Sequence[str]] = None):
        keys = list(keys) if keys else child.schema.names()
        self._agg = HashAggOp(child, keys, [])
        self.schema = self._agg.schema

    def batches(self, device: torch.device) -> Iterator[Batch]:
        return self._agg.batches(device)


# ------------------------------------------------------------------ walking

class VectorANNOp(Operator):
    """Clustered-ANN vector top-K over a bare scan (the approximate arm
    of the VectorTopK plan node). Builds an IVF-flat VectorIndex
    (ops/vector.py) on the device from the scan's rows and probes it once
    per query; the index, with the host copies of the scanned columns,
    is cached in the scan-image cache under the scan's content identity
    (`cache_key + ("vecindex", column, metric)`, then the device), so a
    write's version rotation invalidates it exactly like a scan image.

    Live maintenance: a version rotation caused by append-only writes
    (the previous vector image is a bit-identical prefix of the new one)
    does not rebuild: the new rows join their nearest centroids through
    VectorIndex.append, and only past DRIFT_REBUILD appended fraction
    does the index re-cluster from scratch. The fused tracer declines
    this operator; it runs on the streaming tier."""

    # live-maintenance tier: the last built (vectors, index) pair per
    # table/column, keyed by the write-stable cache-key prefix ("mvcc",
    # engine, tid) so an INSERT finds it after the versioned key rotates
    _live: Dict[tuple, tuple] = {}
    DRIFT_REBUILD = 0.25  # appended fraction past which we re-cluster

    def __init__(self, child: Operator, column: str,
                 query: Sequence[float], metric: str, k: int,
                 nprobe: int = 4):
        self.child = child
        self.column = column
        self.query = tuple(float(x) for x in query)
        self.metric = metric
        self.k = int(k)
        self.nprobe = int(nprobe)
        self.schema = child.schema
        self.n_clusters: Optional[int] = None  # stamped after build

    def _scan(self) -> Optional[ScanOp]:
        base = self.child
        while not isinstance(base, ScanOp):
            nxt = getattr(base, "child", None)
            if nxt is None:
                return None
            base = nxt
        return base

    def _materialize(self, device: torch.device):
        """-> (VectorIndex, {name: np values}, {name: np validity|None},
        n_rows), cached across statements under the scan's content key."""
        from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
        from cockroach_tpu_torch.ops.vector import VectorIndex

        scan = self._scan()
        key = None
        if scan is not None and scan.cache_key is not None:
            key = tuple(scan.cache_key) + ("vecindex", self.column,
                                           self.metric,
                                           _device_key(device))
            hit = scan_image_cache().get(key)
            if hit is not None:
                stats.add("vector.index_hit")
                return hit
        names = self.schema.names()
        vals: Dict[str, list] = {n: [] for n in names}
        valids: Dict[str, list] = {n: [] for n in names}
        for b in self.child.batches(device):
            sel = b.sel
            vc = b.columns[self.column]
            if vc.validity is not None:
                # NULL embeddings are unsearchable: keep them out of the
                # index (and of the gathered result rows)
                sel = sel & vc.validity
            for name in names:
                c = b.columns[name]
                vals[name].append(c.values[sel])
                valids[name].append(
                    None if c.validity is None else c.validity[sel])
        # one readback of the scanned rows
        host_vals = {}
        host_valid = {}
        for name in names:
            parts = vals[name]
            host_vals[name] = (torch.cat(parts).cpu().numpy() if parts
                               else np.empty((0,)))
            vparts = valids[name]
            host_valid[name] = (
                None if not vparts or any(v is None for v in vparts)
                else torch.cat(vparts).cpu().numpy())
        n_rows = len(host_vals[self.column])
        index = None
        live_key = (None if key is None
                    else tuple(key[:3]) + ("veclive", self.column,
                                           self.metric,
                                           _device_key(device)))
        if n_rows:
            new_vecs = host_vals[self.column]
            index = self._maintain(live_key, new_vecs, n_rows)
            if index is None:
                with _tracing.child_span("vector.index_build",
                                         rows=n_rows):
                    index = VectorIndex.build(new_vecs, metric=self.metric,
                                              device=device)
                stats.add("vector.index_build", rows=n_rows, events=1)
            if live_key is not None:
                if len(self._live) > 64:  # bound host-side vec copies
                    self._live.clear()
                self._live[live_key] = (new_vecs, index)
        value = (index, host_vals, host_valid, n_rows)
        if key is not None and index is not None:
            nbytes = index.nbytes() + sum(
                int(a.nbytes) for a in host_vals.values())
            scan_image_cache().put(key, value, nbytes)
        return value

    def _maintain(self, live_key, new_vecs: np.ndarray, n_rows: int):
        """INSERT path: when the previous build's vector image is a
        bit-identical prefix of the current one (append-only writes, no
        update/delete reordering the scan) and centroid drift stays
        under DRIFT_REBUILD, extend the existing index incrementally
        (members join their nearest centroid) instead of re-clustering.
        Returns the maintained index, or None to rebuild."""
        if live_key is None:
            return None
        hit = self._live.get(live_key)
        if hit is None:
            return None
        old_vecs, index = hit
        old_n = len(old_vecs)
        fresh = n_rows - old_n
        if (fresh < 0 or index.n != old_n
                or not np.array_equal(new_vecs[:old_n], old_vecs)):
            return None  # update/delete (or another feed) reshaped rows
        if fresh == 0:
            return index
        if (index.appended + fresh) / float(n_rows) > self.DRIFT_REBUILD:
            stats.add("vector.index_drift_rebuild", rows=n_rows,
                      events=1)
            return None
        with _tracing.child_span("vector.index_append", rows=fresh):
            index.append(new_vecs[old_n:], start_id=old_n)
        stats.add("vector.index_append", rows=fresh, events=1)
        return index

    def batches(self, device: torch.device) -> Iterator[Batch]:
        index, host_vals, host_valid, n_rows = self._materialize(device)
        if index is None or n_rows == 0:
            return
        self.n_clusters = index.n_clusters
        with _tracing.child_span("vector.ann.search", k=self.k,
                                 nprobe=self.nprobe,
                                 clusters=index.n_clusters):
            ids, _dists = index.search(np.asarray(self.query, np.float32),
                                       k=self.k, nprobe=self.nprobe)
        stats.add("vector.ann_search", rows=self.k, events=1)
        ok = ids >= 0
        safe = np.where(ok, ids, 0)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        cols = {}
        for name in self.schema.names():
            validity = host_valid[name]
            cols[name] = Column(
                dev(host_vals[name][safe]),
                None if validity is None else dev(validity[safe]))
        sel = dev(ok)
        yield Batch(mask_padding(cols, sel), sel,
                    torch.full((), int(ok.sum()), dtype=torch.int32,
                               device=device))


def child_operators(op: Operator) -> List[Operator]:
    """Direct children of an operator node."""
    if isinstance(op, JoinOp):
        return [op.probe, op.build]
    if isinstance(op, DistinctOp):
        return [op._agg]
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

MAX_RESTARTS = 8

SPILL_TIER_WORKMEM = Settings.register(
    "sql.resilience.spill_workmem_bytes",
    32 << 20,
    "per-operator workmem while running the forced-spill ladder tier "
    "(small enough that every blocking operator takes its Grace/external "
    "out-of-core path)",
)


def _clamp_workmem_for_spill(op: Operator) -> Callable[[], None]:
    """Clamp every operator's workmem to the spill rung's budget, so the
    blocking operators take their Grace and external paths (the ladder's
    analog of disk_spiller.go:208 swapping in the disk-backed operator).
    Returns the restore callable: the clamp must not outlive the rung."""
    limit = int(Settings().get(SPILL_TIER_WORKMEM))
    saved: List[Tuple[Operator, int]] = []
    for sub in walk_operators(op):
        wm = getattr(sub, "workmem", None)
        if wm is not None and wm > limit:
            saved.append((sub, wm))
            sub.workmem = limit

    def restore():
        for sub, wm in saved:
            sub.workmem = wm

    return restore


def _run_tier(driver, reset: Callable[[], None],
              consume: Callable[[Batch], None], device: torch.device,
              reg) -> None:
    """Drive one ladder tier to completion: the FlowRestart widening loop
    (at most MAX_RESTARTS restarts, each counted in the stats stage
    `flow.restart`, the counter `sql_flow_restarts_total`, a trace record
    and a SQL_EXEC log line), plus in-place retries of transient
    (RETRYABLE) faults under the sql.resilience backoff policy. The
    statement's cancel context is checkpointed before each attempt,
    before each batch and after the last (where the JAX driver has none:
    the port's device work is waited on in `consume`), and before each
    backoff. RESOURCE and TERMINAL
    errors propagate to the ladder, which decides whether a cheaper tier
    exists."""
    from cockroach_tpu_torch.util import log as _log

    opts = _retry.options_from_settings()
    backoffs = opts.backoffs()
    restarts = 0
    while True:
        _cancel.checkpoint()
        reset()
        try:
            for b in driver.batches(device):
                _cancel.checkpoint()
                consume(b)
            b = None  # the last batch's device memory ends with the run
            # the device work of a batch is waited on inside `consume`
            # (its readback), after the checkpoint before it: a flow
            # whose one output batch holds the whole run would
            # otherwise pass its last checkpoint before any of its
            # device time
            _cancel.checkpoint()
            return
        except FlowRestart as fr:
            if restarts == MAX_RESTARTS:
                raise
            restarts += 1
            stats.add("flow.restart")
            reg.counter("sql_flow_restarts_total",
                        "deferred-flag flow restarts").inc()
            _tracing.record("flow.restart", n=restarts,
                            op=type(fr.op).__name__)
            _log.get_logger().info(
                _log.Channel.SQL_EXEC,
                "flow restart {}: widening {}", restarts - 1,
                type(fr.op).__name__)
            fr.op.widen()
        except Exception as e:  # noqa: BLE001 — the classifier decides
            if _retry.classify(e) != _retry.RETRYABLE:
                raise
            pause = next(backoffs, None)
            if pause is None:
                raise  # retry budget exhausted: the ladder steps down
            _cancel.checkpoint()
            _retry.record_retry("flow", pause)
            opts.sleep(pause)


def run_flow(op: Operator, reset: Callable[[], None],
             consume: Callable[[Batch], None], device: torch.device,
             fuse: bool = True) -> None:
    """Drive the flow to completion on `device`, streaming each output
    batch to `consume`, down the degradation ladder: the fused whole-query
    program (exec/fused.py) when the tree fits its grammar and `fuse` is
    set, then the streaming operators, then the forced spill: the same
    operators with every workmem clamped to
    `sql.resilience.spill_workmem_bytes`, so each blocking operator goes
    out of core (exec/spill.py); the clamp is undone when the rung ends.
    Within a tier, on FlowRestart the failed operator widens and the
    whole flow reruns from the scans (`reset` discards the sink's partial
    output first). Each rung has a process-wide circuit breaker
    (util/circuit.py): a tier that keeps failing trips open, and later
    queries skip past it. A RESOURCE error (device memory, a memory
    budget) steps down one rung and counts `resilience.degrade.<tier>`
    and `sql_resilience_degradations_total`; on the last rung it
    propagates. A TERMINAL error (a cancelled statement, a CUDA fault, a
    logic error) propagates from any rung, and trips no breaker.

    With `sql.tpu.admission_slots` > 0 the flow first takes one slot of
    the flow queue (util/admission.py), before any lock of the fused
    runner. Each tier runs in a `flow.<tier>` trace span; the root span
    is tagged with the tier that finished the query."""
    from cockroach_tpu_torch.util.admission import flow_queue

    queue = flow_queue()
    if queue is not None:
        with queue.admit():
            return _run_flow_inner(op, reset, consume, device, fuse)
    return _run_flow_inner(op, reset, consume, device, fuse)


def _run_flow_inner(op: Operator, reset: Callable[[], None],
                    consume: Callable[[Batch], None], device: torch.device,
                    fuse: bool) -> None:
    import time

    from cockroach_tpu_torch.util import circuit as _circuit
    from cockroach_tpu_torch.util import log as _log
    from cockroach_tpu_torch.util.metric import default_registry

    reg = default_registry()
    reg.counter("sql_queries_total", "queries run by the flow driver").inc()
    q_hist = reg.histogram("sql_query_seconds",
                           "end-to-end query wall time")
    t_start = time.perf_counter()

    tiers: List[Tuple[str, object]] = []
    if fuse:
        from cockroach_tpu_torch.exec import fused as _fused

        # the runner is cached on the root: its captured graphs are what
        # make repeat runs of one flow replays
        runner = getattr(op, "_fused_runner", None)
        if runner is None:
            runner = _fused.try_compile(op)
            op._fused_runner = runner
        if runner is not None:
            tiers.append(("fused", runner))
    tiers.append(("streaming", op))
    tiers.append(("spill", op))

    for i, (tier, driver) in enumerate(tiers):
        # a cancelled statement must not start (or degrade into) another
        # tier — a deadline that fired mid-fused must not pay for spill
        _cancel.checkpoint()
        last_tier = i == len(tiers) - 1
        br = _circuit.breaker("flow." + tier)
        if not br.allow():
            if not last_tier:
                stats.add(f"resilience.skip.{tier}")
                _tracing.record("breaker.skip", tier=tier)
                continue
            # every rung is tripped but the query still has to run: the
            # final rung runs as a forced probe
            stats.add(f"resilience.forced.{tier}")
            _tracing.record("breaker.forced", tier=tier)
        restore = (_clamp_workmem_for_spill(op) if tier == "spill"
                   else None)
        try:
            try:
                with _tracing.child_span("flow." + tier):
                    _run_tier(driver, reset, consume, device, reg)
            finally:
                if restore is not None:
                    restore()
        except FlowRestart:
            # widening exhausted: every tier runs the same plan shapes
            raise
        except Exception as e:  # noqa: BLE001 — the classifier decides
            if _retry.classify(e) == _retry.TERMINAL:
                raise
            br.failure()
            if last_tier:
                raise
            reg.counter("sql_resilience_degradations_total",
                        "execution-ladder tier step-downs").inc()
            stats.add(f"resilience.degrade.{tier}")
            _tracing.record("degrade", from_tier=tier,
                            to_tier=tiers[i + 1][0],
                            error=type(e).__name__)
            _log.get_logger().info(
                _log.Channel.SQL_EXEC,
                "degrading {} -> {}: {}: {}", tier, tiers[i + 1][0],
                type(e).__name__, str(e)[:200])
            continue
        br.success()
        _tracing.tag_root(tier=tier)
        q_hist.observe(time.perf_counter() - t_start)
        return


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


def flow_backend(setting: str = "auto") -> str:
    """The backend a flow runs on: "cpu" (the host) when the setting asks
    for it, else "gpu", the caller's device. The JAX package's `auto`
    costs the flow and may place a small one on the host
    (sql/cost.py route_backend); the port leaves that placement out, so
    under `auto` a flow runs where the caller asked, and "gpu" is an alias
    of "auto"."""
    return "cpu" if setting == "cpu" else "gpu"


def collect(op: Operator, device=None, fuse: bool = True,
            backend: str = "auto") -> Dict[str, np.ndarray]:
    """Run the flow on `device` (CUDA unless the caller passes one; raises
    without CUDA) and return host numpy columns, compacted, each with a
    `<col>__valid` sidecar. `backend` is the session's `vectorize`
    (auto|gpu|cpu): "cpu" runs the flow on the host whatever `device`
    says (flow_backend), counted as `route.cpu`; otherwise `route.gpu`.
    With `fuse` (the JAX package's default) the flow runs as the fused
    whole-query program where its tree allows, else through the
    streaming operators (run_flow's ladder). Wide-sum column pairs are
    recombined into exact Python-int columns."""
    placed = flow_backend(backend)
    stats.add(f"route.{placed}")
    dev = (torch.device("cpu") if placed == "cpu"
           else resolve_device(device))
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

    run_flow(op, reset, consume, dev, fuse=fuse)
    result = {}
    for f in op.schema:
        result[f.name] = (np.concatenate(outs[f.name])
                          if outs[f.name] else np.zeros(0))
        result[f.name + "__valid"] = (np.concatenate(valids[f.name])
                                      if valids[f.name] else np.zeros(0, bool))
    assemble_wide_sums(result)
    return result

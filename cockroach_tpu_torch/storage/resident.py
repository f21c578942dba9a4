"""Device-resident MVCC version arrays: scan-at-timestamp is a pass over
the device, not a rebuild.

Counterpart of cockroach_tpu/storage/resident.py. The host MVCC walk
(engine.scan_to_cols) resolves visibility row by row and every cache
miss re-transfers a full scan image; following the near-data-processing
argument (Taurus, arXiv:2506.20010) the versioned columns themselves
live on the device here — pk, per-column value slots, base-relative
bit-packed (wall, logical) timestamps (ops/bitpack.py), a tombstone bit
and an append seq — kept sorted by (pk, ts, seq), and a read at
timestamp T is ops/mvcc_filter.py's visibility pass over them.

Write path: `MVCCStore.put/delete/ingest_table` enqueue host-side
deltas (note_* below, O(1) per write — no invalidation, no restack);
the pow2-bucketed fold merges the pending tail into the sorted arrays
on the next read. A version-counter cross-check against the engine's
per-table write counter catches any write that bypassed the store seam
(DDL drops, raw engine writes) and triggers a full resync instead of
serving stale lanes.

Budget/degradation: the resident lane set is pinned in the process-wide
ScanImageCache under the `storage.hbm_scan_image_cache_bytes` budget —
LRU pressure (or an over-budget table) evicts the pin and the table
detaches back to the host-walk tier, which stays the backstop for the
table's semantic limits (timestamp pack overflow, oversized pks) and for
device memory running out. A fault of the device or of a pass (a failed
launch, an illegal address) propagates to the caller.
Compaction: when the folded delta tail exceeds a settings-gated
fraction of the base, the table rebuilds from the engine's export,
dropping replaced duplicate lanes and re-biasing the timestamp base.

Cache identity: readers key on (generation, epoch/horizon, timestamp
bucket) — `generation` names one attach lifetime, `horizon` counts
folded+pending versions (rotates per write), and the timestamp bucket
collapses every read at-or-after the newest version into one memoized
image, so repeated "now" reads after a write burst cost one fold + one
visibility pass, not a rebuild per read.

Departures from the JAX module:
  - the device is the store's (`MVCCStore(device=...)`, resolved with
    `resolve_device` when a table first attaches);
  - its trace records (util/tracing.py: the `scan.resident_fold` span,
    the `scan.resident_resync` and `scan.resident_compact` records) are
    also exec/stats events and timers with the same names, and the
    compaction is a timer where the JAX module counts an event;
  - an image's host copy (`_Image.vals`) takes its `count` live lanes,
    not the whole padded capacity (`scan.resident_transfer` counts
    those bytes, and times the copy); the feed still goes device ->
    host -> ScanOp's packed copy back (ROADMAP.md queue 4);
  - a fault in the fold or the visibility pass other than running out
    of device memory propagates (util/retry.py classifies it TERMINAL);
    the JAX module turns every such error into ResidentUnavailable and
    serves the read from the host walk;
  - the rebuild reads the engine's export as one buffer of records
    with numpy (the record offsets found a window at a time, then one
    gather per record width) instead of one Python tuple per version.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cockroach_tpu_torch.ops import bitpack as _bp
from cockroach_tpu_torch.ops import mvcc_filter as _mf
from cockroach_tpu_torch.util.hlc import Timestamp
from cockroach_tpu_torch.util.settings import Settings

RESIDENT_SCAN = Settings.register(
    "storage.resident_scan",
    False,
    "keep MVCC version arrays device-resident and resolve scan "
    "visibility on the device (auto-attaches tables on first scan); "
    "off = host-walk scans only",
)
RESIDENT_COMPACT_FRACTION = Settings.register(
    "storage.resident_compact_fraction",
    0.5,
    "rebuild a resident table's version arrays from the engine when the "
    "incrementally folded delta tail exceeds this fraction of the base "
    "lane count (drops replaced duplicate lanes, re-biases the ts pack)",
)

_COMPACT_MIN_DELTAS = 256  # don't thrash tiny tables


class ResidentUnavailable(Exception):
    """This table cannot (or can no longer) serve from device-resident
    arrays; the caller degrades to the host-walk tier."""


class _Image:
    """One memoized visibility result: the rows visible at a (horizon,
    timestamp bucket) pair, device-side with lazy host views."""

    __slots__ = ("pk_dev", "vals_dev", "count", "cap", "epoch",
                 "_pks_np", "_vals_np")

    def __init__(self, pk_dev, vals_dev, count: int, cap: int,
                 epoch: int):
        self.pk_dev = pk_dev
        self.vals_dev = vals_dev
        self.count = int(count)
        self.cap = int(cap)
        self.epoch = int(epoch)
        self._pks_np: Optional[np.ndarray] = None
        self._vals_np: Optional[np.ndarray] = None

    def pks(self) -> np.ndarray:
        if self._pks_np is None:
            self._pks_np = self.pk_dev[:self.count].cpu().numpy()
        return self._pks_np

    def vals(self) -> np.ndarray:
        if self._vals_np is None:
            from cockroach_tpu_torch.exec import stats

            nbytes = 8 * int(self.vals_dev.shape[0]) * self.count
            with stats.timed("scan.resident_transfer", bytes=nbytes):
                self._vals_np = self.vals_dev[:, :self.count].cpu().numpy()
        return self._vals_np


# ------------------------------------------------ export -> host arrays

_HDR = 20  # u32 klen | u32 vlen | u64 wall | u32 logical
_KEY = 10  # >HQ: table id, pk
_WINDOW = 4096


def _record_layout(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(offset, value length) of every record of an export buffer. Where
    the next record has the same size, a window of records of that size
    is checked at once (their headers at a fixed stride), and the first
    that differs starts the next step, so a table of one row width costs
    a few numpy passes however many tombstones break it; where sizes
    alternate (a row's versions on both sides of ALTER TABLE ADD COLUMN,
    tombstones between versions), records are read one header at a
    time, which costs far less than a window each."""
    n = len(buf)
    u8 = np.frombuffer(buf, np.uint8)
    head = struct.Struct("<II").unpack_from
    offs, vlens = [], []
    single_offs, single_vlens = [], []

    def flush_singles():
        if single_offs:
            offs.append(np.asarray(single_offs, np.int64))
            vlens.append(np.asarray(single_vlens, np.int64))
            single_offs.clear()
            single_vlens.clear()

    off = 0
    while off + _HDR <= n:
        klen, vlen = head(buf, off)
        if klen != _KEY:
            raise ResidentUnavailable("a key outside the table keyspace")
        size = _HDR + klen + vlen
        if off + size > n:
            break  # a short tail: not a whole record
        nxt = off + size
        if nxt + _HDR > n or head(buf, nxt) != (klen, vlen):
            single_offs.append(off)
            single_vlens.append(vlen)
            off = nxt
            continue
        flush_singles()
        w = min(_WINDOW, (n - off) // size)
        at = off + size * np.arange(w, dtype=np.int64)
        heads = u8[(at[:, None] + np.arange(8)).reshape(-1)].reshape(w, 8)
        heads = heads.copy().view("<u4")
        bad = np.flatnonzero((heads[:, 0] != klen) | (heads[:, 1] != vlen))
        take = int(bad[0]) if len(bad) else w
        offs.append(at[:take])
        vlens.append(np.full(take, vlen, np.int64))
        off += take * size
    flush_singles()
    if not offs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(offs), np.concatenate(vlens)


def _export_arrays(engine, start: bytes, end: bytes, ncols: int):
    """Every version in [start, end) as host arrays (pks, walls,
    logicals, tomb, vals (ncols, n)), in the engine's export order. The
    native engine hands over its export buffer; the Python model's
    versions are written in the same record format first."""
    raw = getattr(engine, "export_span_buffer", None)
    if raw is not None:
        buf = raw(start, end)
    else:
        head = struct.Struct("<IIQI").pack
        buf = b"".join(head(len(k), len(v), ts.wall, ts.logical) + k + v
                       for k, ts, v in engine.export_span(start, end))
    offs, vlens = _record_layout(buf)
    n = len(offs)
    pks = np.empty(n, np.int64)
    walls = np.empty(n, np.int64)
    logicals = np.empty(n, np.int64)
    tomb = vlens == 0
    vals = np.zeros((ncols, n), np.int64)
    for vlen in np.unique(vlens).tolist():
        sel = np.flatnonzero(vlens == vlen)
        width = vlen // 8
        names = ["wall", "logical", "pk"]
        formats = ["<u8", "<u4", ">u8"]
        offsets = [8, 16, _HDR + 2]
        if width:
            names.append("vals")
            formats.append(("<i8", (width,)))
            offsets.append(_HDR + _KEY)
        size = _HDR + _KEY + vlen
        rec = np.dtype({"names": names, "formats": formats,
                        "offsets": offsets, "itemsize": size})
        # one record at every byte: the records sit at offs[sel]
        view = np.ndarray((len(buf) - size + 1,), rec, buffer=buf,
                          strides=(1,))
        got = view[offs[sel]]
        if (got["pk"] >= np.uint64(_mf.PK_SENTINEL)).any():
            raise ResidentUnavailable("a pk collides with the device "
                                      "sentinel")
        pks[sel] = got["pk"].astype(np.int64)
        walls[sel] = got["wall"].astype(np.int64)
        logicals[sel] = got["logical"]
        usable = min(ncols, width)
        if usable:
            vals[:usable, sel] = got["vals"][:, :usable].T
    return pks, walls, logicals, tomb, vals


class ResidentTable:
    """Per-(engine, table) device-resident version arrays + delta queue.
    All methods are thread-safe; every entry point that touches device
    state raises ResidentUnavailable when the table must fall back."""

    _generations = [0]
    _gen_mu = threading.Lock()

    def __init__(self, engine, table_id: int, ncols: int, device=None):
        from cockroach_tpu_torch import resolve_device

        self.engine = engine
        self.table_id = int(table_id)
        self.ncols = int(ncols)
        self.device = resolve_device(device)
        with ResidentTable._gen_mu:
            ResidentTable._generations[0] += 1
            self.generation = ResidentTable._generations[0]
        self._mu = threading.RLock()
        self._dead = False
        self.epoch = 0          # bumped on every fold/rebuild
        self.folds = 0
        self.rebuilds = 0
        self.delta_rows = 0     # lifetime rows through the delta path
        self._deltas: List[Tuple[int, int, int, bool, Tuple[int, ...]]] \
            = []
        self._pending_version = 0  # engine bumps mirrored via note_*
        self._images: Dict[Tuple[int, int], _Image] = {}
        # epoch transitions -> pk span touched: (epoch, (lo, hi)) for a
        # fold, (epoch, None) for a rebuild/resync ("everything moved").
        # Sharded readers (ROADMAP.md queue 1, item 7) diff against their
        # last epoch to refresh only the owning pk-range shards.
        self._change_log: List[Tuple[int, Optional[Tuple[int, int]]]] = []
        self._rebuild_locked()

    # ------------------------------------------------------------ build --

    def _span(self) -> Tuple[bytes, bytes]:
        return (struct.pack(">HQ", self.table_id, 0),
                struct.pack(">HQ", self.table_id + 1, 0))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _rebuild_locked(self) -> None:
        """(Re)build the sorted lane set from the engine — attach, resync
        after an out-of-band write, and compaction all land here."""
        start, end = self._span()
        pks, walls, logicals, tomb, vals = _export_arrays(
            self.engine, start, end, self.ncols)
        n = len(pks)
        self.base = _bp.ts_base(int(walls.min()) if n else 0)
        try:
            packed = _bp.pack_ts_arrays(walls, logicals, self.base)
        except _bp.TsOverflow as e:
            raise ResidentUnavailable(str(e))
        order = np.lexsort((packed, pks))
        cap = _mf.pow2_at_least(max(n, 1))
        lane = _mf.sentinel_arrays(cap, self.ncols)
        lane[0][:n] = pks[order]
        lane[1][:n] = packed[order]
        lane[2][:n] = np.arange(n, dtype=np.int64)
        lane[3][:n] = tomb[order]
        lane[4][:, :n] = vals[:, order]
        del vals
        self._pk = self._to_dev(lane[0])
        self._ts = self._to_dev(lane[1])
        self._seq = self._to_dev(lane[2])
        self._tomb = self._to_dev(lane[3])
        self._vals = self._to_dev(lane[4])
        self.n = n
        self.cap = cap
        self.base_n = max(n, 1)
        self.folded_tail = 0
        self._seq_next = n
        self._max_packed = int(packed.max()) if n else -1
        self._deltas.clear()
        self._max_pend = self._max_packed
        self._pending_version = int(self._engine_version())
        self.epoch += 1
        self.rebuilds += 1
        self._note_change_locked(None)
        self._images.clear()
        self._account_locked()

    def _engine_version(self) -> int:
        getter = getattr(self.engine, "table_version", None)
        return int(getter(self.table_id)) if getter is not None else 0

    # ------------------------------------------------ device accounting --

    def _pin_key(self) -> tuple:
        return ("mvcc", id(self.engine), self.table_id, "resident-pin")

    @property
    def nbytes(self) -> int:
        per_lane = 8 * 3 + 1 + 8 * self.ncols  # pk, ts, seq, tomb, vals
        return self.cap * per_lane

    def _account_locked(self) -> None:
        """Resident lanes (base + folded deltas) count against the
        scan-image budget; a refused or LRU-evicted pin detaches the
        table back to the host tier."""
        from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

        if not scan_image_cache().put(self._pin_key(), self.generation,
                                      self.nbytes):
            raise ResidentUnavailable(
                f"resident lanes ({self.nbytes}B) over the scan-image "
                f"budget")

    def _check_pin_locked(self) -> None:
        from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

        if not scan_image_cache().contains(self._pin_key()):
            raise ResidentUnavailable(
                "resident pin evicted under device budget pressure")

    # ------------------------------------------------------ delta queue --

    def note_put(self, pk: int, ts: Timestamp, fields) -> None:
        with self._mu:
            if self._dead:
                return
            self._deltas.append((int(pk), int(ts.wall), int(ts.logical),
                                 False, tuple(int(f) for f in fields)))
            self._note_ts_locked(ts)
            self._pending_version += 1

    def note_delete(self, pk: int, ts: Timestamp) -> None:
        with self._mu:
            if self._dead:
                return
            self._deltas.append((int(pk), int(ts.wall), int(ts.logical),
                                 True, ()))
            self._note_ts_locked(ts)
            self._pending_version += 1

    def note_ingest(self, pks, cols, ts: Timestamp) -> None:
        with self._mu:
            if self._dead:
                return
            mat = [np.asarray(c, dtype=np.int64) for c in cols]
            for i, pk in enumerate(np.asarray(pks, dtype=np.int64)):
                self._deltas.append(
                    (int(pk), int(ts.wall), int(ts.logical), False,
                     tuple(int(c[i]) for c in mat)))
            self._note_ts_locked(ts)
            self._pending_version += 1  # one engine bump per ingest call

    def _note_ts_locked(self, ts: Timestamp) -> None:
        # clamped pack never raises; an out-of-range wall clamps to the
        # 2^62 sentinel, which is a fine "newest" bucket until the next
        # fold re-biases the base
        self._max_pend = max(
            self._max_pend,
            _bp.pack_ts_read(ts.wall, ts.logical, self.base))

    def read_bucket(self, ts: Optional[Timestamp]) -> Tuple[int, int]:
        """(base, timestamp bucket) of a read at `ts` — the cache-key
        pair that collapses every read at-or-after the newest version
        (INCLUDING still-pending deltas) into one bucket. Base rides
        along because bucket values are base-relative ints: images from
        different attach/compaction lifetimes must never collide."""
        with self._mu:
            if ts is None:
                return (self.base, self._max_pend)
            return (self.base,
                    min(_bp.pack_ts_read(ts.wall, ts.logical, self.base),
                        self._max_pend))

    def horizon(self) -> Tuple[int, int]:
        """(generation, total versions incl. the pending tail): rotates
        on every write, stable between writes — the scan-image key
        component pairing with the timestamp bucket."""
        with self._mu:
            return (self.generation, self.n + len(self._deltas))

    _CHANGE_LOG_CAP = 64  # trimmed history reads as "everything changed"

    def _note_change_locked(self,
                            span: Optional[Tuple[int, int]]) -> None:
        self._change_log.append((self.epoch, span))
        if len(self._change_log) > self._CHANGE_LOG_CAP:
            del self._change_log[: -self._CHANGE_LOG_CAP]

    def changed_span(self, since_epoch: int
                     ) -> Optional[Tuple[int, int]]:
        """Union pk span [lo, hi] of every version folded after
        `since_epoch` — the shard-refresh contract: a reader holding a
        per-pk-range placement built at `since_epoch` only re-derives
        ranges intersecting this span. Returns (0, -1) (empty) when
        nothing changed, None when everything may have (a rebuild/resync
        happened, or the log no longer reaches back that far)."""
        with self._mu:
            if since_epoch >= self.epoch:
                return (0, -1)
            eps = [ep for ep, _ in self._change_log]
            if not eps or since_epoch + 1 < min(eps):
                return None  # transitions older than the log: assume all
            lo = hi = None
            for ep, span in self._change_log:
                if ep <= since_epoch:
                    continue
                if span is None:
                    return None
                lo = span[0] if lo is None else min(lo, span[0])
                hi = span[1] if hi is None else max(hi, span[1])
            return (lo, hi) if lo is not None else (0, -1)

    # ------------------------------------------------------------- fold --

    def _fold_locked(self) -> None:
        from cockroach_tpu_torch.exec import stats
        from cockroach_tpu_torch.util import tracing as _tracing

        if self._engine_version() != self._pending_version:
            # a write bypassed the store seam (DDL backfill/drop, raw
            # engine writes): the delta queue is not the whole story —
            # resync from the engine rather than serve stale lanes
            stats.add("scan.resident_resync")
            _tracing.record("scan.resident_resync", table=self.table_id)
            self._rebuild_locked()
            return
        if not self._deltas:
            return
        d = len(self._deltas)
        frac = float(Settings().get(RESIDENT_COMPACT_FRACTION))
        if (self.folded_tail + d >= _COMPACT_MIN_DELTAS
                and self.folded_tail + d > frac * self.base_n):
            _tracing.record("scan.resident_compact", table=self.table_id)
            with stats.timed("scan.resident_compact",
                             rows=self.folded_tail + d):
                self._rebuild_locked()
            return
        dcap = _mf.pow2_at_least(d)
        lane = _mf.sentinel_arrays(dcap, self.ncols)
        walls = np.empty(d, np.int64)
        logicals = np.empty(d, np.int64)
        for i, (pk, wall, logical, tomb, fields) in \
                enumerate(self._deltas):
            if pk >= _mf.PK_SENTINEL:
                raise ResidentUnavailable(
                    f"pk {pk} collides with the device sentinel")
            lane[0][i] = pk
            walls[i] = wall
            logicals[i] = logical
            lane[3][i] = tomb
            usable = min(self.ncols, len(fields))
            if usable:
                lane[4][:usable, i] = fields[:usable]
        try:
            packed = _bp.pack_ts_arrays(walls, logicals, self.base)
        except _bp.TsOverflow:
            # timestamps drifted outside the base-relative range:
            # re-bias by rebuilding (export includes the new versions —
            # they are already in the engine)
            stats.add("scan.resident_resync")
            self._rebuild_locked()
            return
        lane[1][:d] = packed
        lane[2][:d] = np.arange(self._seq_next, self._seq_next + d,
                                dtype=np.int64)
        out_cap = _mf.pow2_at_least(self.n + d)
        with _tracing.child_span("scan.resident_fold", rows=d), \
                stats.timed("scan.resident_fold", rows=d):
            self._pk, self._ts, self._seq, self._tomb, self._vals = \
                _mf.fold_versions(
                    (self._pk, self._ts, self._seq, self._tomb,
                     self._vals),
                    tuple(self._to_dev(a) for a in lane), out_cap)
        self.n += d
        self.cap = out_cap
        self.folded_tail += d
        self._seq_next += d
        self.delta_rows += d
        self._max_packed = max(self._max_packed, int(packed.max()))
        self._deltas.clear()
        self.folds += 1
        self.epoch += 1
        self._note_change_locked(
            (int(lane[0][:d].min()), int(lane[0][:d].max())))
        self._images.clear()
        self._account_locked()

    # ------------------------------------------------------------ reads --

    def image_at(self, ts: Optional[Timestamp]) -> _Image:
        """The visibility image at `ts` (None = newest), memoized per
        (epoch, timestamp bucket): any read at-or-after the newest
        version shares the newest bucket, so post-write warm reads cost
        one fold + one visibility pass, not one per read timestamp."""
        from cockroach_tpu_torch.exec import stats

        with self._mu:
            if self._dead:
                raise ResidentUnavailable("detached")
            self._check_pin_locked()
            try:
                self._fold_locked()
            except torch.cuda.OutOfMemoryError as e:
                # no room for the merged lanes: the caller detaches the
                # table, which frees them; a fault of the device or of
                # the fold itself propagates unchanged
                raise ResidentUnavailable(f"fold failed: {e!r}")
            if ts is None:
                tread = self._max_packed
            else:
                tread = min(
                    _bp.pack_ts_read(ts.wall, ts.logical, self.base),
                    self._max_packed)
            img = self._images.get((self.epoch, tread))
            if img is not None:
                stats.add("scan.resident_image_hit")
                return img
            try:
                pk, vals, count = _mf.visible_image(
                    self._pk, self._ts, self._tomb, self._vals, self.n,
                    tread)
                img = _Image(pk, vals, int(count), self.cap, self.epoch)
            except torch.cuda.OutOfMemoryError as e:
                raise ResidentUnavailable(f"visibility pass: {e!r}")
            self._images[(self.epoch, tread)] = img
            # the memo is small (one per live bucket) but unbounded in
            # time-travel-heavy tests: keep the newest few
            while len(self._images) > 8:
                self._images.pop(next(iter(self._images)))
            return img

    def scan_columns(self, ts: Optional[Timestamp], start_pk: int = 0,
                     end_pk: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Host (pks, vals (C, k)) of the rows visible at `ts` within
        [start_pk, end_pk) — the resident feed for scan_chunks."""
        img = self.image_at(ts)
        pks = img.pks()
        lo = int(np.searchsorted(pks, start_pk))
        hi = (int(np.searchsorted(pks, end_pk)) if end_pk is not None
              else img.count)
        return pks[lo:hi], img.vals()[:, lo:hi]

    def detach(self) -> None:
        from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

        with self._mu:
            self._dead = True
            self._images.clear()
        scan_image_cache().invalidate(self._pin_key())


# --------------------------------------------------------------- registry

_tables: Dict[Tuple[int, int], ResidentTable] = {}
_failed: Dict[Tuple[int, int], int] = {}  # -> engine version at failure
_reg_mu = threading.Lock()


def _key(engine, table_id: int) -> Tuple[int, int]:
    return (id(engine), int(table_id))


def lookup(store, table_id: int) -> Optional[ResidentTable]:
    """The attached ResidentTable for (store.engine, table_id), if any."""
    with _reg_mu:
        rt = _tables.get(_key(store.engine, table_id))
    return rt if rt is not None and not rt._dead else None


def enabled() -> bool:
    return bool(Settings().get(RESIDENT_SCAN))


def attach(store, table_id: int, ncols: int
           ) -> Optional[ResidentTable]:
    """Build + register the resident arrays for one table on the store's
    device; None when the table cannot go resident (negative-cached
    until the table changes again, so a hot scan path doesn't re-attempt
    a doomed build)."""
    from cockroach_tpu_torch.exec import stats

    key = _key(store.engine, table_id)
    with _reg_mu:
        rt = _tables.get(key)
        if rt is not None and not rt._dead:
            if rt.ncols >= ncols:
                return rt
            rt.detach()  # wider projection than built: rebuild below
            _tables.pop(key, None)
        ver = _failed.get(key)
    if ver is not None and ver == int(store.table_version(table_id)):
        return None
    try:
        with stats.timed("scan.resident_attach"):
            rt = ResidentTable(store.engine, table_id, ncols,
                               getattr(store, "device", None))
    except ResidentUnavailable:
        stats.add("scan.resident_attach_fail")
        with _reg_mu:
            _failed[key] = int(store.table_version(table_id))
        return None
    with _reg_mu:
        _failed.pop(key, None)
        _tables[key] = rt
    return rt


def maybe_attach(store, table_id: int, ncols: int
                 ) -> Optional[ResidentTable]:
    """lookup(), auto-attaching when storage.resident_scan is on."""
    rt = lookup(store, table_id)
    if rt is not None:
        if rt.ncols >= ncols:
            return rt
        return attach(store, table_id, ncols)
    if not enabled():
        return None
    return attach(store, table_id, ncols)


def detach(store, table_id: int) -> None:
    with _reg_mu:
        rt = _tables.pop(_key(store.engine, table_id), None)
    if rt is not None:
        rt.detach()


def reset() -> None:
    """Drop every resident table + failure marker (test hygiene)."""
    with _reg_mu:
        tables = list(_tables.values())
        _tables.clear()
        _failed.clear()
    for rt in tables:
        rt.detach()


# ------------------------------------------------- store write-path hooks

def on_put(store, table_id: int, pk: int, ts: Timestamp,
           fields) -> None:
    rt = lookup(store, table_id)
    if rt is not None:
        rt.note_put(pk, ts, fields)


def on_delete(store, table_id: int, pk: int, ts: Timestamp) -> None:
    rt = lookup(store, table_id)
    if rt is not None:
        rt.note_delete(pk, ts)


def on_ingest(store, table_id: int, pks, cols, ts: Timestamp) -> None:
    rt = lookup(store, table_id)
    if rt is not None:
        rt.note_ingest(pks, cols, ts)

"""Out-of-core execution: host-RAM spill blocks, a disk tier and Grace
hash partitioning.

Counterpart of cockroach_tpu/exec/spill.py, with its names, settings and
disk format. Reference: pkg/sql/colexec/colexecdisk — `diskSpillerBase`
(disk_spiller.go:208) swaps an in-memory operator for its out-of-core
variant when the memory monitor trips; `hashBasedPartitioner`
(hash_based_partitioner.go:115) recursively Grace-partitions inputs with
a fresh hash seed per level (:369).

The memory hierarchy is device memory -> host RAM -> disk. A spilled
partition is a queue of compacted numpy column blocks; blocks live in
host RAM while the host-spill budget lasts and overflow to an
append-only file per partition past it (length-framed raw column buffers
behind a small JSON header). Partitioning a device stream costs one
device sort and one readback per batch: rows are sorted by destination
partition on the device, read back column by column once, and the host
splits the block by slicing. Each partition then replays through the
ordinary in-memory operator; partitions never share keys, so the
per-partition results union to the exact answer.

Replay (BlockSource) copies each chunk into a fresh pinned host tensor
per column and starts a non-blocking copy on the consumer's stream: the
caching host allocator does not hand the buffer out again until the copy
that reads it has run, and pulling the next chunk early
(exec/operators.py _read_ahead) overlaps its copy with the consumer's
kernels.

A block's append passes the fault seam `spill.block_write` and its
replay upload `spill.block_read`, each before any state changes and
under `with_retry`, so a transient fault re-enters a clean append or
re-uploads the same block. A partitioned batch records `spill.grace`
and a replayed chunk `spill.replay` on the active trace span.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import struct
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column, Schema
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.exec.operators import Operator
from cockroach_tpu_torch.ops.bitpack import srl
from cockroach_tpu_torch.ops.hash import hash_columns
from cockroach_tpu_torch.util import retry as _retry
from cockroach_tpu_torch.util import tracing as _tracing
from cockroach_tpu_torch.util.fault import maybe_fail
from cockroach_tpu_torch.util.mon import (
    BoundAccount, BudgetExceededError, BytesMonitor,
)
from cockroach_tpu_torch.util.settings import Settings

# reference: ExternalSorterMinPartitions = 3 (colexecop/constants.go:11);
# the Grace partitioner sizes buckets to a power of two
# (hash_based_partitioner.go:294-296)
DEFAULT_NUM_PARTITIONS = 8
MAX_GRACE_LEVELS = 4  # the reference bails to sort-merge past this depth

HOST_SPILL_BUDGET = Settings.register(
    "sql.distsql.temp_storage.host_bytes",
    64 << 30,
    "host-RAM budget for spilled partitions; overflow goes to the disk "
    "tier (temp files under temp_storage.path)",
)

TEMP_PATH = Settings.register(
    "sql.distsql.temp_storage.path",
    "",
    "directory for disk-spill files (default: a fresh tempdir)",
)

_temp_dir: Optional[str] = None


def _spill_dir() -> str:
    global _temp_dir
    if _temp_dir is None:
        configured = Settings().get(TEMP_PATH)
        if configured:
            os.makedirs(configured, exist_ok=True)
            _temp_dir = configured
        else:
            _temp_dir = tempfile.mkdtemp(prefix="cockroach-tpu-spill-")
            atexit.register(shutil.rmtree, _temp_dir, ignore_errors=True)
    return _temp_dir


class DiskQueueFile:
    """Append-only spill file of framed blocks (diskqueue.go:87's
    file-rotation format reduced to one file per partition): each frame
    is [u32 header_len][JSON header][raw column buffers...]."""

    _seq = 0

    def __init__(self):
        DiskQueueFile._seq += 1
        self.path = os.path.join(
            _spill_dir(), f"part-{os.getpid()}-{DiskQueueFile._seq}.bin")
        self._f = open(self.path, "wb")
        self.n_blocks = 0
        self.nbytes = 0

    def append(self, block: "SpilledBlock") -> None:
        header = {
            "n": block.n_rows,
            "cols": [(k, v.dtype.str, int(v.nbytes))
                     for k, v in block.values.items()],
            "valid": [k for k, v in block.validity.items()
                      if v is not None],
        }
        hb = json.dumps(header).encode()
        self._f.write(struct.pack("<I", len(hb)))
        self._f.write(hb)
        for v in block.values.values():
            self._f.write(v.tobytes())
        for k, v in block.validity.items():
            if v is not None:
                self._f.write(np.asarray(v, np.uint8).tobytes())
        self.n_blocks += 1
        self.nbytes += len(hb) + 4 + block.nbytes
        stats.add("spill.disk_write", rows=block.n_rows,
                  bytes=block.nbytes)

    def replay(self) -> Iterator["SpilledBlock"]:
        self._f.flush()
        with open(self.path, "rb") as f:
            for _ in range(self.n_blocks):
                (hlen,) = struct.unpack("<I", f.read(4))
                header = json.loads(f.read(hlen).decode())
                n = header["n"]
                values: Dict[str, np.ndarray] = {}
                validity: Dict[str, Optional[np.ndarray]] = {}
                for k, dt, nb in header["cols"]:
                    values[k] = np.frombuffer(f.read(nb), dtype=dt)
                    validity[k] = None
                for k in header["valid"]:
                    validity[k] = np.frombuffer(
                        f.read(n), dtype=np.uint8).astype(bool)
                stats.add("spill.disk_read", rows=n)
                yield SpilledBlock(n, values, validity)

    def close(self) -> None:
        try:
            self._f.close()
            os.unlink(self.path)
        except OSError:
            pass


_host_spill_monitor: Optional[BytesMonitor] = None


def host_spill_monitor() -> BytesMonitor:
    """Root monitor for host-RAM spill blocks (the temp-disk analog)."""
    global _host_spill_monitor
    if _host_spill_monitor is None:
        _host_spill_monitor = BytesMonitor(
            "host-spill", budget=Settings().get(HOST_SPILL_BUDGET))
    return _host_spill_monitor


@dataclass
class SpilledBlock:
    """One compacted batch in host RAM: column arrays + validity."""

    n_rows: int
    values: Dict[str, np.ndarray]
    validity: Dict[str, Optional[np.ndarray]]

    @property
    def nbytes(self) -> int:
        total = 0
        for v in self.values.values():
            total += v.nbytes
        for v in self.validity.values():
            if v is not None:
                total += v.nbytes
        return total


class HostPartition:
    """An append-only queue of spilled blocks for one Grace partition
    (reference: colcontainer.PartitionedDiskQueue partition). Blocks stay
    in host RAM within the host-spill budget; once the BytesMonitor
    trips, the partition's existing blocks flush to its disk file and all
    further appends stream straight to disk, so host RAM stays at the
    budget while the data size is bounded by the disk."""

    def __init__(self, account: BoundAccount):
        self.blocks: List[SpilledBlock] = []
        self.n_rows = 0
        self._account = account
        self._disk: Optional[DiskQueueFile] = None

    def append(self, block: SpilledBlock) -> None:
        # the fault fires BEFORE any state mutates so with_retry at the
        # call site re-enters a clean append
        maybe_fail("spill.block_write")
        self.n_rows += block.n_rows
        stats.add("spill.write", rows=block.n_rows, bytes=block.nbytes)
        if self._disk is None:
            try:
                self._account.grow(block.nbytes)
                self.blocks.append(block)
                return
            except BudgetExceededError:
                # host budget exhausted: demote this partition to disk
                self._disk = DiskQueueFile()
                for b in self.blocks:
                    self._disk.append(b)
                self._account.shrink(sum(b.nbytes for b in self.blocks))
                self.blocks = []
        self._disk.append(block)

    def _all_blocks(self) -> Iterator[SpilledBlock]:
        if self._disk is not None:
            yield from self._disk.replay()
        yield from self.blocks

    def replay(self, capacity: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield column-dict chunks of <= capacity rows (ScanOp format),
        re-slicing blocks so every chunk is full-capacity except the last
        (fewer, larger copies beat many small ones)."""
        pending: List[SpilledBlock] = []
        pending_rows = 0

        def flush(blocks: List[SpilledBlock]):
            cols: Dict[str, np.ndarray] = {}
            first = blocks[0]
            for name in first.values:
                cols[name] = np.concatenate([b.values[name] for b in blocks])
                vs = [b.validity[name] for b in blocks]
                if any(v is not None for v in vs):
                    cols["__valid_" + name] = np.concatenate([
                        v if v is not None else np.ones(b.n_rows, bool)
                        for b, v in zip(blocks, vs)])
            return cols

        for b in self._all_blocks():
            pending.append(b)
            pending_rows += b.n_rows
            if pending_rows >= capacity:
                cols = flush(pending)
                value_names = [k for k in cols if not k.startswith("__valid_")]
                n = len(cols[value_names[0]])
                for a in range(0, n - capacity + 1, capacity):
                    yield {k: v[a:a + capacity] for k, v in cols.items()}
                rem = n % capacity
                if rem:
                    pending = [SpilledBlock(
                        rem,
                        {k: cols[k][n - rem:] for k in value_names},
                        {k: (cols["__valid_" + k][n - rem:]
                             if "__valid_" + k in cols else None)
                         for k in value_names},
                    )]
                    pending_rows = rem
                else:
                    pending, pending_rows = [], 0
        if pending_rows:
            yield flush(pending)

    def close(self) -> None:
        freed = sum(b.nbytes for b in self.blocks)
        self.blocks = []
        self._account.shrink(freed)
        if self._disk is not None:
            self._disk.close()
            self._disk = None


def batch_to_block(b: Batch) -> SpilledBlock:
    """Read a device batch whose live rows are the prefix [0, length)
    back to a host block: one read of the length, then one copy of each
    column's live prefix."""
    n = int(b.length)
    values: Dict[str, np.ndarray] = {}
    validity: Dict[str, Optional[np.ndarray]] = {}
    for name, c in b.columns.items():
        values[name] = c.values[:n].cpu().numpy()
        validity[name] = (None if c.validity is None
                          else c.validity[:n].cpu().numpy())
    return SpilledBlock(n, values, validity)


def _partition_sort(b: Batch, part_of_row: torch.Tensor):
    """Device: stable-sort rows by partition id (dead lanes last, under
    key 2^30); -> (the gathered batch, the sorted partition ids)."""
    key = torch.where(b.sel, part_of_row, 1 << 30)
    order = torch.argsort(key, stable=True)
    sorted_part = key[order]
    out = b.gather(order, sel=b.sel[order], length=b.length)
    return out, sorted_part


class GracePartitioner:
    """Partition a device-batch stream into P host partitions by key hash.

    One device sort and one readback per input batch: rows are sorted by
    `(hash(keys) >> shift) % P` on the device, and the host slices the
    sorted block at the partition bounds. `level` picks fresh hash bits
    per recursion (the reference re-seeds per level,
    hash_based_partitioner.go:369). The hash is uint64 bits in int64
    lanes: the shift is logical, and after a shift of at least one bit
    the value is non-negative, so torch's `%` is the unsigned one."""

    def __init__(self, keys: Sequence[str],
                 num_partitions: int = DEFAULT_NUM_PARTITIONS,
                 level: int = 0, monitor: Optional[BytesMonitor] = None):
        self.keys = tuple(keys)
        self.P = num_partitions
        self.level = level
        acct = (monitor or host_spill_monitor()).make_account()
        self._account = acct
        self.partitions = [HostPartition(acct) for _ in range(self.P)]

    def _route(self, b: Batch):
        h = hash_columns(b, self.keys, seed=7 + self.level)
        # level 0 uses bits [21, 42); repartition levels walk down. Bits
        # [42, 64) stay reserved for the mesh router, the low bits for
        # local hash tables: independent levels from one hash
        shift = max(1, 21 - 7 * self.level)
        part = (srl(h, shift) % self.P).to(torch.int32)
        return _partition_sort(b, part)

    def consume(self, b: Batch) -> None:
        t0 = time.perf_counter()
        out, sorted_part = self._route(b)
        block = batch_to_block(out)            # the one readback
        parts = sorted_part[:block.n_rows].cpu().numpy()
        stats.add("spill.partition", seconds=time.perf_counter() - t0,
                  rows=block.n_rows)
        _tracing.record("spill.grace", rows=block.n_rows,
                        level=self.level)
        bounds = np.searchsorted(parts, np.arange(self.P + 1))
        for p in range(self.P):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            if lo == hi:
                continue
            piece = SpilledBlock(
                hi - lo,
                {k: v[lo:hi] for k, v in block.values.items()},
                {k: (None if v is None else v[lo:hi])
                 for k, v in block.validity.items()},
            )
            _retry.with_retry(
                lambda p=p, piece=piece: self.partitions[p].append(piece),
                name="spill.block_write")

    def consume_stream(self, stream: Iterator[Batch]) -> None:
        for b in stream:
            self.consume(b)

    def close(self) -> None:
        for p in self.partitions:
            p.close()


def upload_chunk(chunk: Dict[str, np.ndarray], n: int, schema: Schema,
                 capacity: int, device: torch.device) -> Batch:
    """A host chunk of n rows (ScanOp format: `__valid_<name>` arrays
    beside the values) as a device batch of `capacity` lanes. Each column
    goes through a fresh host tensor, pinned for a CUDA device, and a
    non-blocking copy on the current stream. Idempotent, so a transient
    fault re-uploads the same chunk."""
    pin = device.type == "cuda"

    def up(vals: np.ndarray) -> torch.Tensor:
        host = torch.zeros(capacity, dtype=torch.from_numpy(vals[:0]).dtype,
                           pin_memory=pin)
        host.numpy()[:n] = vals
        return host.to(device, non_blocking=pin)

    cols = {}
    for f in schema:
        validity = chunk.get("__valid_" + f.name)
        cols[f.name] = Column(up(chunk[f.name]),
                              None if validity is None else up(validity))
    sel = torch.arange(capacity, device=device) < n
    return Batch(cols, sel, torch.full((), n, dtype=torch.int32,
                                       device=device))


class BlockSource(Operator):
    """Operator yielding device batches from a spilled partition, validity
    included (the replay half of the disk queue,
    colcontainer/diskqueue.go Dequeue)."""

    def __init__(self, partition: HostPartition, schema: Schema,
                 capacity: int):
        self.partition = partition
        self.schema = schema
        self.capacity = capacity

    def batches(self, device: torch.device) -> Iterator[Batch]:
        # spill.replay times the host's part: the disk read, the re-slice
        # and the start of the copies
        chunks = self.partition.replay(self.capacity)
        while True:
            t0 = time.perf_counter()
            chunk = next(chunks, None)
            if chunk is None:
                return
            n = len(next(iter(
                v for k, v in chunk.items() if not k.startswith("__valid_"))))

            def upload(chunk=chunk, n=n):
                # idempotent, so a transient read/transfer fault
                # re-uploads the same block
                maybe_fail("spill.block_read")
                return upload_chunk(chunk, n, self.schema, self.capacity,
                                    device)

            b = _retry.with_retry(upload, name="spill.block_read")
            stats.add("spill.replay", seconds=time.perf_counter() - t0,
                      rows=n, bytes=sum(v.nbytes for v in chunk.values()))
            _tracing.record("spill.replay", rows=n)
            yield b


def estimate_row_bytes(schema: Schema) -> int:
    """Device bytes per row (validity excluded) for budget decisions."""
    return sum(f.type.np_dtype.itemsize for f in schema)

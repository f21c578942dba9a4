"""Carry state from the JAX package into the port, as plain numpy arrays.

The port never imports the JAX types: a caller turns a JAX Schema into a
field spec and a JAX Batch into numpy arrays (np.asarray on each leaf) and
hands those in, so both packages compute on the same state. An MVCC store
crosses whole (`carry_store`): the port rebuilds it from the JAX
engine's export of every version. A JAX session's tables cross as their
spans (`carry_session_store`): the descriptor keyspace, each live
table's rows, its secondary indexes and its statistics. A materialized
view's group state (`carry_group_state`) and a clustered vector index
(`carry_vector_index`) cross as their device arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import (
    Batch, ColType, Column, Field, Kind, Schema,
)

# (name, kind, scale, dict_ref, wire, nullable); kind is a Kind or its
# string value ("int", "decimal", ...)
FieldSpec = Tuple[str, object, int, Optional[str], Optional[str], bool]


def schema_from_spec(fields: Sequence[FieldSpec],
                     dicts: Optional[Dict[str, np.ndarray]] = None) -> Schema:
    out = []
    for name, kind, scale, dict_ref, wire, nullable in fields:
        k = kind if isinstance(kind, Kind) else Kind(kind)
        out.append(Field(name, ColType(k, int(scale)), dict_ref, wire,
                         bool(nullable)))
    return Schema(out, {k: np.asarray(v, dtype=object)
                        for k, v in (dicts or {}).items()})


def batch_from_arrays(columns: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]],
                      sel: np.ndarray, length, device) -> Batch:
    """columns: {name: (values, validity or None)} as numpy arrays."""
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    cols = {n: Column(t(v), None if m is None else t(np.asarray(m, bool)))
            for n, (v, m) in columns.items()}
    return Batch(cols, t(np.asarray(sel, bool)),
                 torch.full((), int(length), dtype=torch.int32, device=dev))


def carry_store(jax_store, device=None, clock=None):
    """A port MVCCStore holding the same history as the JAX package's
    `jax_store`: every version of the whole keyspace (tombstones
    included), read with its engine's `export_span` and written with the
    port engine's `ingest_span`. Only `jax_store.engine.export_span` is
    read, as (key bytes, timestamp with .wall/.logical, value bytes)
    tuples, so the JAX package is never imported. The new store gets
    `clock` (by default an HLC over a ManualClock one past the newest
    version's wall, so a read at "now" sees every version) and `device`
    for its resident tier."""
    from cockroach_tpu_torch.storage.engine import open_engine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore
    from cockroach_tpu_torch.util.hlc import HLC, ManualClock, Timestamp

    entries = [(bytes(k), Timestamp(int(ts.wall), int(ts.logical)),
                bytes(v))
               for k, ts, v in jax_store.engine.export_span(b"", b"")]
    engine = open_engine()
    engine.ingest_span(entries)
    if clock is None:
        wall = max((ts.wall for _k, ts, _v in entries), default=0)
        clock = HLC(ManualClock(wall + 1))
    return MVCCStore(engine=engine, clock=clock, device=device)


def carry_session_store(jax_store, device=None, clock=None):
    """A port MVCCStore holding the tables of the JAX package's
    SessionCatalog over `jax_store`: every version of its descriptor
    keyspace and, for each table a live descriptor names, every version
    of the table's span, of its secondary indexes' spans and of its
    statistics key (ANALYZE's). The port's SessionCatalog over the new
    store reads each table as the JAX one does: descriptors are the same
    JSON, rows the same int64 slots. As `carry_store`, only
    `jax_store.engine.export_span` is read, and the new store gets
    `clock` (by default one past the newest version's wall) and
    `device`."""
    import json
    import struct

    from cockroach_tpu_torch.sql.session import DESC_TABLE
    from cockroach_tpu_torch.sql.stats import stats_key
    from cockroach_tpu_torch.storage.engine import open_engine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore
    from cockroach_tpu_torch.util.hlc import HLC, ManualClock, Timestamp

    def span(start: bytes, end: bytes):
        return [(bytes(k), Timestamp(int(ts.wall), int(ts.logical)),
                 bytes(v))
                for k, ts, v in jax_store.engine.export_span(start, end)]

    def prefix(tid: int, end: bool = False) -> bytes:
        return struct.pack(">HQ", tid + int(end), 0)

    entries = span(prefix(DESC_TABLE), prefix(DESC_TABLE, True))
    newest = {}
    for k, _ts, v in entries:  # key-ascending, newest version first
        newest.setdefault(k, v)
    for v in newest.values():
        if not v:
            continue  # a dropped table
        desc = json.loads(v.decode())
        for tid in [desc["table_id"]] + list(desc.get("indexes",
                                                      {}).values()):
            entries += span(prefix(tid), prefix(tid, True))
        key = stats_key(desc["table_id"])
        entries += span(key, key + b"\x00")
    engine = open_engine()
    engine.ingest_span(sorted(entries, key=lambda e: (
        e[0], -e[1].wall, -e[1].logical)))
    if clock is None:
        wall = max((ts.wall for _k, ts, _v in entries), default=0)
        clock = HLC(ManualClock(wall + 1))
    return MVCCStore(engine=engine, clock=clock, device=device)


def carry_group_state(jax_state, device):
    """The port's ops/view_fold.py GroupState holding a JAX GroupState's
    state: its sorted packed keys, capacity, fold counters and the five
    int64 lanes (counts (G,), acnt/asum/amin/amax (A, G)), read with
    np.asarray and placed on `device` with their shapes and dtypes."""
    from cockroach_tpu_torch.ops.view_fold import GroupState

    st = GroupState(int(jax_state.n_inputs), device)
    st.keys = np.array(jax_state.keys, dtype=np.int64, copy=True)
    st.gcap = int(jax_state.gcap)
    st.folds = int(jax_state.folds)
    st.generation = int(jax_state.generation)

    def lane(a):
        arr = np.array(a, copy=True)
        if arr.dtype != np.int64:
            raise TypeError(f"group state lane of dtype {arr.dtype}")
        return torch.from_numpy(arr).to(st.device)

    (st.counts, st.acnt, st.asum, st.amin, st.amax) = (
        lane(jax_state.counts), lane(jax_state.acnt),
        lane(jax_state.asum), lane(jax_state.amin), lane(jax_state.amax))
    return st


def carry_vector_index(jax_index, device):
    """The port's ops/vector.py VectorIndex holding a JAX VectorIndex:
    centroids (C, d) float32, member ids (C, m) int32, member vectors
    (C, m, d) float32 and validity (C, m) bool, read with np.asarray and
    placed on `device` with their shapes and dtypes, plus its metric, row
    count and appended-row count."""
    from cockroach_tpu_torch.ops.vector import VectorIndex

    dev = torch.device(device)

    def t(a, dtype):
        arr = np.array(a, copy=True)
        if arr.dtype != dtype:
            raise TypeError(f"index array of dtype {arr.dtype}, "
                            f"expected {np.dtype(dtype)}")
        return torch.from_numpy(arr).to(dev)

    idx = VectorIndex(t(jax_index.centroids, np.float32),
                      t(jax_index.member_ids, np.int32),
                      t(jax_index.member_vecs, np.float32),
                      t(jax_index.member_valid, np.bool_),
                      jax_index.metric, int(jax_index.n))
    idx.appended = int(jax_index.appended)
    return idx

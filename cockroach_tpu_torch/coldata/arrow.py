"""Host columns -> device batches: the packed ingest format.

Counterpart of the numpy side of cockroach_tpu/coldata/arrow.py. Every
column of a chunk is copied (cast to its narrow wire dtype, zero-padded
to the capacity) into ONE uint8 buffer at an 8-byte aligned offset, so a
chunk crosses to the device in one copy; the device unpack views each
byte range as its wire dtype and widens it to the device dtype.

The Arrow conversions (arrow_to_batch, batch_to_arrow) are not ported
yet; when they are, they import pyarrow inside the function, so this
module imports without it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cockroach_tpu_torch import resolve_device
from cockroach_tpu_torch.coldata.batch import Batch, Column, Kind, Schema

_TORCH_OF_NP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def _pad(arr: np.ndarray, capacity: int) -> np.ndarray:
    n = arr.shape[0]
    if n == capacity:
        return arr
    out = np.zeros((capacity,) + arr.shape[1:], dtype=arr.dtype)
    out[:n] = arr
    return out


def numpy_to_batch(data: Dict[str, np.ndarray], schema: Schema,
                   capacity: Optional[int] = None, device=None) -> Batch:
    """Build a Batch from host numpy columns (test/workload convenience)."""
    dev = resolve_device(device)
    n = len(next(iter(data.values()))) if data else 0
    capacity = capacity or n
    cols = {}
    for f in schema:
        arr = np.asarray(data[f.name]).astype(f.type.np_dtype)
        cols[f.name] = Column(torch.from_numpy(_pad(arr, capacity)).to(dev))
    sel = torch.arange(capacity, device=dev) < n
    return Batch(cols, sel, torch.full((), n, dtype=torch.int32, device=dev))


def pack_layout(schema: Schema, capacity: int):
    """[(name, np_dtype, offset, nbytes)] with 8-byte aligned offsets, and
    the total size. Uses each field's narrow `wire` dtype when declared.
    Nullable fields get an extra uint8 validity lane "<name>__valid"."""
    layout = []
    off = 0
    for f in schema:
        dt = np.dtype(f.wire) if f.wire else f.type.np_dtype
        lanes = f.type.dim if f.type.kind is Kind.VECTOR else 1
        nbytes = capacity * lanes * dt.itemsize
        layout.append((f.name, dt, off, nbytes))
        off += (nbytes + 7) & ~7
        if f.nullable:
            layout.append((f.name + "__valid", np.dtype(np.uint8), off,
                           capacity))
            off += (capacity + 7) & ~7
    return layout, off


def pack_into(buf: np.ndarray, chunk: Dict[str, np.ndarray], schema: Schema,
              capacity: int) -> int:
    """Host-side: copy a chunk's columns into `buf` (uint8, at least the
    layout's total size, zeroed past the data). Validity lanes missing
    from the chunk default to all-valid. -> the chunk's row count."""
    layout, _total = pack_layout(schema, capacity)
    n = len(next(iter(chunk.values())))
    if n > capacity:
        raise ValueError(f"chunk of {n} rows exceeds capacity {capacity}")
    for name, dt, off, nbytes in layout:
        src = chunk.get(name)
        if src is None and name.endswith("__valid"):
            src = np.ones(n, dtype=np.uint8)
        flat = np.asarray(src).astype(dt, copy=False).reshape(-1)
        region = buf[off:off + nbytes].view(dt)
        region[:flat.shape[0]] = flat
        region[flat.shape[0]:] = 0
    return n


def pack_chunk(chunk: Dict[str, np.ndarray], schema: Schema,
               capacity: int) -> Tuple[np.ndarray, int]:
    """Host-side: columns (cast + zero-padded) in one uint8 buffer."""
    _layout, total = pack_layout(schema, capacity)
    buf = np.zeros(total, dtype=np.uint8)
    return buf, pack_into(buf, chunk, schema, capacity)


def make_unpack(schema: Schema, capacity: int
                ) -> Callable[[torch.Tensor, int], Batch]:
    """(buf: uint8 tensor on the device, n: host int) -> Batch. Each
    column is a view of its byte range as the wire dtype, widened to the
    device dtype."""
    layout, _total = pack_layout(schema, capacity)
    device_dt = {f.name: f.type.dtype for f in schema}

    def unpack(buf: torch.Tensor, n: int) -> Batch:
        cols = {}
        valids = {}
        for name, dt, off, nbytes in layout:
            raw = buf[off:off + nbytes]
            if name.endswith("__valid"):
                valids[name[:-len("__valid")]] = raw != 0
                continue
            tdt = _TORCH_OF_NP[dt]
            if tdt == torch.bool:
                vals = raw != 0
            else:
                vals = raw.view(tdt)
            lanes = nbytes // (capacity * dt.itemsize)
            if lanes > 1:  # VECTOR: (capacity, d)
                vals = vals.reshape(capacity, lanes)
            want = device_dt[name]
            if vals.dtype != want:
                vals = vals.to(want)
            cols[name] = Column(vals)
        sel = torch.arange(capacity, device=buf.device) < n
        for name, v in valids.items():
            cols[name] = Column(cols[name].values, v & sel)
        length = torch.full((), n, dtype=torch.int32, device=buf.device)
        return Batch(cols, sel, length)

    return unpack

"""Columnar batch format — the data currency of the execution engine.

Counterpart of cockroach_tpu/coldata/batch.py. A Batch is a dict of
fixed-capacity columns plus a boolean selection mask `sel` and the number
of selected rows `length`, a 0-d tensor on the batch's device: reading it
on the host would stall the stream, so nothing on the path does. Every
column is a (capacity,) tensor; nulls are a boolean validity tensor per
column (True = valid, None = no nulls). Strings are int32 dictionary
codes whose dictionaries live host-side in the Schema; decimals are int64
scaled by 10^scale; dates are int32 days since the epoch.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Kind(enum.Enum):
    """Canonical type families."""

    BOOL = "bool"
    INT = "int"          # int64
    FLOAT = "float"      # float32 on device
    DECIMAL = "decimal"  # int64 scaled by 10^scale
    DATE = "date"        # int32 days since unix epoch
    STRING = "string"    # int32 dictionary code
    TIMESTAMP = "timestamp"  # int64 nanos
    VECTOR = "vector"    # (capacity, d) float32 embedding


_DEVICE_DTYPES = {
    Kind.BOOL: torch.bool,
    Kind.INT: torch.int64,
    Kind.FLOAT: torch.float32,
    Kind.DECIMAL: torch.int64,
    Kind.DATE: torch.int32,
    Kind.STRING: torch.int32,
    Kind.TIMESTAMP: torch.int64,
    Kind.VECTOR: torch.float32,
}

# host (numpy) dtype of each kind: the packed wire format is built in numpy
_NP_DTYPES = {
    Kind.BOOL: np.dtype(np.bool_),
    Kind.INT: np.dtype(np.int64),
    Kind.FLOAT: np.dtype(np.float32),
    Kind.DECIMAL: np.dtype(np.int64),
    Kind.DATE: np.dtype(np.int32),
    Kind.STRING: np.dtype(np.int32),
    Kind.TIMESTAMP: np.dtype(np.int64),
    Kind.VECTOR: np.dtype(np.float32),
}


@dataclass(frozen=True)
class ColType:
    """A column's logical type."""

    kind: Kind
    # DECIMAL: digits after the point; VECTOR: the dimension d
    scale: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return _DEVICE_DTYPES[self.kind]

    @property
    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES[self.kind]

    @property
    def dim(self) -> int:
        """VECTOR dimension (the `d` of vector(d))."""
        return self.scale

    def lanes(self) -> int:
        """Device lanes per row: d for VECTOR columns, 1 otherwise."""
        return self.scale if self.kind is Kind.VECTOR else 1

    def __repr__(self):
        if self.kind is Kind.DECIMAL:
            return f"decimal(:{self.scale})"
        if self.kind is Kind.VECTOR:
            return f"vector({self.scale})"
        return self.kind.value


BOOL = ColType(Kind.BOOL)
INT = ColType(Kind.INT)
FLOAT = ColType(Kind.FLOAT)
DATE = ColType(Kind.DATE)
STRING = ColType(Kind.STRING)
TIMESTAMP = ColType(Kind.TIMESTAMP)


def DECIMAL(scale: int = 2) -> ColType:
    return ColType(Kind.DECIMAL, scale)


def VECTOR(dim: int) -> ColType:
    return ColType(Kind.VECTOR, dim)


@dataclass(frozen=True)
class Field:
    name: str
    type: ColType
    # STRING columns: identity token of the host-side dictionary; columns
    # with the same dict_ref have directly comparable codes
    dict_ref: Optional[str] = None
    # optional narrow transport dtype (numpy dtype string, e.g. "i2"): the
    # host->device wire format; the device unpack widens it
    wire: Optional[str] = None
    # nullable columns get a validity byte-lane "<name>__valid" in the
    # packed wire format and a validity mask on the device
    nullable: bool = False


class Schema:
    """Static host-side description of a Batch; owns the string
    dictionaries, keyed by dict_ref."""

    def __init__(self, fields: Sequence[Field], dicts: Optional[Dict[str, np.ndarray]] = None):
        self.fields: Tuple[Field, ...] = tuple(fields)
        self._by_name = {f.name: i for i, f in enumerate(self.fields)}
        # dict_ref -> numpy array of python str (the decode table)
        self.dicts: Dict[str, np.ndarray] = dicts or {}

    def __hash__(self):
        return hash(self.fields)

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)

    def field(self, name: str) -> Field:
        return self.fields[self._by_name[name]]

    def index(self, name: str) -> int:
        return self._by_name[name]

    def names(self):
        return [f.name for f in self.fields]

    def dictionary(self, name: str) -> Optional[np.ndarray]:
        ref = self.field(name).dict_ref
        return self.dicts.get(ref) if ref else None

    def project(self, names: Sequence[str]) -> "Schema":
        fields = [self.field(n) for n in names]
        dicts = {f.dict_ref: self.dicts[f.dict_ref]
                 for f in fields if f.dict_ref and f.dict_ref in self.dicts}
        return Schema(fields, dicts)

    def extend(self, fields: Sequence[Field], dicts: Optional[Dict[str, np.ndarray]] = None) -> "Schema":
        d = dict(self.dicts)
        if dicts:
            d.update(dicts)
        return Schema(list(self.fields) + list(fields), d)

    def __repr__(self):
        return "Schema(" + ", ".join(f"{f.name}:{f.type}" for f in self.fields) + ")"


class Column:
    """One typed device vector + validity (None when it has no NULLs)."""

    def __init__(self, values: torch.Tensor,
                 validity: Optional[torch.Tensor] = None):
        self.values = values
        self.validity = validity

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.values.shape[0], dtype=torch.bool,
                              device=self.values.device)
        return self.validity

    def gather(self, idx: torch.Tensor) -> "Column":
        v = None if self.validity is None else self.validity.index_select(0, idx)
        return Column(self.values.index_select(0, idx), v)

    def __repr__(self):
        n = "" if self.validity is None else ", nulls"
        return f"Column({self.values.dtype}[{self.values.shape[0]}]{n})"


def _count(sel: torch.Tensor) -> torch.Tensor:
    """Number of selected rows as a 0-d int32 tensor on sel's device."""
    return sel.sum(dtype=torch.int32)


class Batch:
    """Columns + a selection mask over [0, capacity) + `length`, the
    number of selected rows. Rows with sel False are absent."""

    def __init__(self, columns: Dict[str, Column], sel: torch.Tensor,
                 length: torch.Tensor):
        self.columns = dict(columns)
        self.sel = sel
        self.length = length  # 0-d int32 tensor on the batch's device

    @staticmethod
    def from_columns(columns: Dict[str, Column]) -> "Batch":
        cap = next(iter(columns.values())).capacity
        dev = next(iter(columns.values())).values.device
        return Batch(columns, torch.ones(cap, dtype=torch.bool, device=dev),
                     torch.full((), cap, dtype=torch.int32, device=dev))

    @property
    def capacity(self) -> int:
        if self.columns:
            return next(iter(self.columns.values())).capacity
        return self.sel.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def names(self):
        return list(self.columns.keys())

    def col(self, name: str) -> Column:
        return self.columns[name]

    def with_sel(self, sel: torch.Tensor, length=None) -> "Batch":
        if length is None:
            length = _count(sel)
        return Batch(self.columns, sel, length)

    def filter(self, mask: torch.Tensor) -> "Batch":
        """Narrow the selection by an additional boolean mask."""
        sel = self.sel & mask
        return Batch(self.columns, sel, _count(sel))

    def project(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.sel, self.length)

    def with_column(self, name: str, col: Column) -> "Batch":
        cols = dict(self.columns)
        cols[name] = col
        return Batch(cols, self.sel, self.length)

    def compact(self) -> "Batch":
        """Pack selected rows to the front (stable); rows past `length` are
        zero-filled and deselected."""
        order = torch.argsort((~self.sel).to(torch.uint8), stable=True)
        out = self.gather(order)
        new_sel = torch.arange(self.capacity, device=self.device) < self.length
        return Batch(mask_padding(out.columns, new_sel), new_sel, self.length)

    def gather(self, idx: torch.Tensor, sel=None, length=None) -> "Batch":
        """Move whole rows to `idx` order, column by column."""
        cols = {n: c.gather(idx) for n, c in self.columns.items()}
        if sel is None:
            sel = self.sel.index_select(0, idx)
        if length is None:
            length = _count(sel)
        return Batch(cols, sel, length)

    def __repr__(self):
        inner = ", ".join(f"{n}: {c!r}" for n, c in self.columns.items())
        return f"Batch[cap={self.capacity}]({inner})"


def full_sel(capacity: int, device) -> torch.Tensor:
    return torch.ones(capacity, dtype=torch.bool, device=device)


def mask_padding(columns: Dict[str, Column], sel: torch.Tensor) -> Dict[str, Column]:
    """Zero-fill values and clear validity on dead lanes, so padding never
    leaks into downstream work."""
    def _mask(c: Column) -> Column:
        s = sel if c.values.dim() == 1 else sel[:, None]
        zero = torch.zeros((), dtype=c.values.dtype, device=c.values.device)
        return Column(
            torch.where(s, c.values, zero),
            None if c.validity is None else c.validity & sel,
        )

    return {n: _mask(c) for n, c in columns.items()}


def concat_batches(batches: Sequence[Batch], schemas: Optional[Sequence[Schema]] = None) -> Batch:
    """Concatenate along rows.

    All batches must share column names/dtypes and, for STRING columns,
    the same dictionary: codes are merged verbatim. Pass `schemas` to have
    the dictionaries checked."""
    if schemas is not None:
        first = schemas[0]
        for s in schemas[1:]:
            for f0, f1 in zip(first.fields, s.fields):
                if f0.dict_ref != f1.dict_ref or (
                    f0.dict_ref and s.dicts.get(f1.dict_ref) is not first.dicts.get(f0.dict_ref)
                ):
                    raise ValueError(
                        f"concat_batches: column {f0.name!r} encoded against "
                        f"different dictionaries; re-encode before concat"
                    )
    cols = {}
    for n in batches[0].names():
        vals = torch.cat([b.columns[n].values for b in batches])
        if all(b.columns[n].validity is None for b in batches):
            validity = None
        else:
            validity = torch.cat([b.columns[n].valid_mask() for b in batches])
        cols[n] = Column(vals, validity)
    sel = torch.cat([b.sel for b in batches])
    length = torch.stack([b.length for b in batches]).sum(dtype=torch.int32)
    return Batch(cols, sel, length)

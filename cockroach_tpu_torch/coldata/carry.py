"""Carry state from the JAX package into the port, as plain numpy arrays.

The port never imports the JAX types: a caller turns a JAX Schema into a
field spec and a JAX Batch into numpy arrays (np.asarray on each leaf) and
hands those in, so both packages compute on the same state.
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

"""Batch invariants checker — test-build validation between operators.

Counterpart of cockroach_tpu/exec/invariants.py. Reference:
pkg/sql/colexec/invariants_checker.go — in test builds an
invariantsChecker is inserted between every operator pair, validating
batch invariants (selection-vector ordering, length bounds, null
consistency). Here `check_batch` validates the device-Batch contract
(shapes, dtypes, sel/length consistency, validity shape, dictionary
code ranges) and `CheckedOp` wraps an operator's stream; the plan
builder inserts one above every operator when `sql.tpu.invariants` (or
COCKROACH_TPU_SQL_TPU_INVARIANTS=1) is set.

Checking reads every batch back to the host, so it is a test-build tool,
like the reference's CrdbTestBuild gate. The fused tier declines a tree
that holds a CheckedOp, and the flow runs on the streaming operators.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import Batch, Kind, Schema
from cockroach_tpu_torch.exec.operators import Operator
from cockroach_tpu_torch.util.settings import Settings

INVARIANTS = Settings.register(
    "sql.tpu.invariants",
    False,
    "insert a batch-invariants checker above every operator (test builds)",
)


class InvariantViolation(AssertionError):
    pass


def check_batch(b: Batch, schema: Schema, where: str = "") -> None:
    """Host-side validation of the Batch contract (reads the batch
    back)."""

    def fail(msg):
        raise InvariantViolation(f"[{where}] {msg}")

    cap = b.capacity
    sel = b.sel.cpu().numpy()
    if sel.dtype != np.bool_ or sel.shape != (cap,):
        fail(f"sel must be bool (cap,): {sel.dtype} {sel.shape}")
    length = int(b.length)
    n_sel = int(sel.sum())
    if length != n_sel:
        fail(f"length {length} != sel.sum() {n_sel}")
    if set(b.columns) != set(schema.names()):
        fail(f"columns {sorted(b.columns)} != schema {schema.names()}")
    for f in schema:
        c = b.col(f.name)
        if tuple(c.values.shape) != (cap,):
            fail(f"column {f.name} shape {tuple(c.values.shape)} != "
                 f"({cap},)")
        if c.values.dtype != f.type.dtype:
            fail(f"column {f.name} dtype {c.values.dtype} != "
                 f"{f.type.dtype}")
        if c.validity is not None:
            if c.validity.dtype != torch.bool \
                    or tuple(c.validity.shape) != (cap,):
                fail(f"column {f.name} validity {c.validity.dtype} "
                     f"{tuple(c.validity.shape)}")
        if f.type.kind is Kind.STRING:
            d = schema.dictionary(f.name)
            if d is not None:
                vals = c.values.cpu().numpy()
                live = sel if c.validity is None else (
                    sel & c.validity.cpu().numpy())
                codes = vals[live]
                if codes.size and (codes.min() < 0
                                   or codes.max() >= len(d)):
                    fail(f"column {f.name} dictionary codes out of "
                         f"range [0, {len(d)}): "
                         f"[{codes.min()}, {codes.max()}]")


def enabled() -> bool:
    return bool(Settings().get(INVARIANTS))


class CheckedOp(Operator):
    """Wraps an operator and validates every batch it emits. The
    operator walks (exec/operators.py child_operators) see through it."""

    def __init__(self, child: Operator):
        self.child = child
        self.schema = child.schema
        self._name = type(child).__name__

    def batches(self, device: torch.device) -> Iterator[Batch]:
        for b in self.child.batches(device):
            check_batch(b, self.schema, where=self._name)
            yield b

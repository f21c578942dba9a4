"""Storage layer: native C++ MVCC engine + columnar scan seam.

Counterpart of cockroach_tpu/storage/. Reference: pkg/storage (MVCC over
Pebble; mvcc.go, col_mvcc.go, pebble_mvcc_scanner.go). MVCC semantics
stay on the host (C++), and the scanner emits column-major chunks so the
scan feeds device memory in one packed transfer per chunk.
"""

from cockroach_tpu_torch.storage.engine import (
    NativeEngine, PyEngine, ScanResult, open_engine,
)
from cockroach_tpu_torch.storage.mvcc import (
    MVCCStore, decode_key, decode_row, encode_key, encode_row,
    run_datadriven,
)

__all__ = [
    "NativeEngine", "PyEngine", "ScanResult", "open_engine",
    "MVCCStore", "encode_key", "decode_key", "encode_row", "decode_row",
    "run_datadriven",
]

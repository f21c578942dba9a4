"""Hand-written CUDA kernels for Hopper, and their plain PyTorch versions.

Counterpart of cockroach_tpu/ops/pallas_kernels.py. Each kernel's source
lives in cockroach_tpu_torch/csrc/ and is compiled with nvcc for sm_90a
into build/torch_kernels/ at first use, keyed by a hash of the source and
the flags. The shared library has a plain C entry point and is loaded
with ctypes, so the build never includes PyTorch's headers.

A wrapper dispatches on the device of the tensors it is given: a CUDA
tensor goes to the kernel (or the call raises), a CPU tensor goes to the
plain version beside it. There is no fallback from one to the other.
Each kernel counts its launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    # /usr/local/cuda is the toolkit's default install location
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = os.path.join(root, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


class CudaKernel:
    """One kernel: its source, its shared library, its C entry point and
    its launch count (`launches`, raised by the wrapper on each launch)."""

    def __init__(self, source: str, entry: str, argtypes: List):
        self.source = _CSRC / source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless the library for this source exists already.
        The output goes to a temporary name and is renamed into place, so
        a reader never sees a half-written library."""
        lib = self.library()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp = tmp  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(proc.tmp, self.library())  # type: ignore[attr-defined]

    def fn(self):
        """The loaded C entry point, building the library first if needed."""
        if self._fn is None:
            proc = self.start_build()
            if proc is not None:
                self.finish_build(proc)
            lib = ctypes.CDLL(str(self.library()))
            f = getattr(lib, self.entry)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn


_P = ctypes.c_void_p
DENSE_SUMS = CudaKernel(
    "dense_sums.cu", "dense_sums_launch",
    # packed, n, values[], live[], k, d, out, stream
    [_P, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P])

KERNELS = (DENSE_SUMS,)

MAX_LANES = 256  # DS_MAX_LANES in csrc/dense_sums.cu


def build_all() -> None:
    """Build every kernel, one nvcc per source, all started together, and
    load each library."""
    procs = [(k, k.start_build()) for k in KERNELS]
    for k, proc in procs:
        if proc is not None:
            k.finish_build(proc)
    for k in KERNELS:
        k.fn()


def _check_dense_sums(packed, values, live, n_lanes):
    if packed.dim() != 1 or packed.dtype != torch.int32:
        raise ValueError(f"packed must be 1-D int32, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if len(values) == 0 or len(values) != len(live):
        raise ValueError("values and live need one entry per column")
    if not 1 <= n_lanes <= MAX_LANES:
        raise ValueError(f"n_lanes {n_lanes} outside [1, {MAX_LANES}]")
    n = packed.shape[0]
    for ts, dtype in ((values, torch.int64), (live, torch.bool)):
        for t in ts:
            if t is None:
                continue
            if t.dtype != dtype or tuple(t.shape) != (n,):
                raise ValueError(f"expected {dtype} ({n},), got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != packed.device or not t.is_contiguous():
                raise ValueError("every column must be contiguous and on "
                                 f"{packed.device}")


def dense_sums(packed: torch.Tensor,
               values: Sequence[Optional[torch.Tensor]],
               live: Sequence[Optional[torch.Tensor]],
               n_lanes: int) -> torch.Tensor:
    """Grouped exact int64 sums of K columns over a dense key space.

    packed: (N,) int32 group codes; a code outside [0, n_lanes) is a dead
    row. values[c]: (N,) int64, or None for the constant 1 (a row count).
    live[c]: (N,) bool, or None when every row is live.
    -> (K, n_lanes) int64: per column and lane, the wrapping sum of the
    live values whose code is that lane."""
    _check_dense_sums(packed, values, live, n_lanes)
    if packed.device.type == "cpu":
        return dense_sums_plain(packed, values, live, n_lanes)
    if packed.device.type != "cuda":
        raise ValueError(f"dense_sums: no kernel for {packed.device}")
    k = len(values)
    out = torch.zeros((k, n_lanes), dtype=torch.int64, device=packed.device)
    vptrs = (ctypes.c_void_p * k)(
        *[None if v is None else v.data_ptr() for v in values])
    lptrs = (ctypes.c_void_p * k)(
        *[None if m is None else m.data_ptr() for m in live])
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = DENSE_SUMS.fn()(packed.data_ptr(), packed.shape[0],
                         ctypes.addressof(vptrs), ctypes.addressof(lptrs),
                         k, n_lanes, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dense_sums kernel launch failed: CUDA error {rc}")
    DENSE_SUMS.launches += 1
    return out


def dense_sums_plain(packed: torch.Tensor,
                     values: Sequence[Optional[torch.Tensor]],
                     live: Sequence[Optional[torch.Tensor]],
                     n_lanes: int) -> torch.Tensor:
    """The plain PyTorch version of dense_sums: one index_add_ of the
    stacked (N, K) columns into n_lanes + 1 rows, the last one taking the
    dead rows."""
    n = packed.shape[0]
    cols = []
    for v, m in zip(values, live):
        c = (torch.ones(n, dtype=torch.int64, device=packed.device)
             if v is None else v)
        if m is not None:
            c = torch.where(m, c, torch.zeros((), dtype=torch.int64,
                                              device=c.device))
        cols.append(c)
    stacked = torch.stack(cols, dim=1)
    in_range = (packed >= 0) & (packed < n_lanes)
    idx = torch.where(in_range, packed, n_lanes).to(torch.int64)
    sums = torch.zeros((n_lanes + 1, len(cols)), dtype=torch.int64,
                       device=packed.device).index_add_(0, idx, stacked)
    return sums[:n_lanes].T.contiguous()

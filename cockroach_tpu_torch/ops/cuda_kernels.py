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
through the kernel. A thread that captures a CUDA graph counts the
launches its capture records apart (`record_launches`), so a launch that
another thread makes meanwhile stays in the kernel's own count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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


# launches recorded by a stream capture on this thread (record_launches)
_RECORD = threading.local()
_COUNT_MU = threading.Lock()


def record_launches(into: Optional[dict]) -> None:
    """Count this thread's launches into `into` (kernel source stem ->
    launches) instead of each kernel's own count, until the next call
    (None stops): a capture records launches that only its replays make."""
    _RECORD.into = into


class CudaKernel:
    """One kernel: its source, its shared library, its C entry point, its
    launch count (`launches`, raised by the wrapper on each launch) and
    the route its last launch took, as the kernel reports it (`route`)."""

    def __init__(self, source: str, entry: str, argtypes: List):
        self.source = _CSRC / source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.route: tuple = ()
        self.build_log = ""
        self._lib = None
        self._fn = None

    def count_launch(self, n: int = 1) -> None:
        """Add `n` launches: to this thread's capture record while it
        records (record_launches), else to `launches`."""
        into = getattr(_RECORD, "into", None)
        if into is not None:
            into[self.source.stem] = into.get(self.source.stem, 0) + n
            return
        with _COUNT_MU:
            self.launches += n

    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless the library for this source exists already
        (then `build_log` is the log of the build that made it). The
        output goes to a temporary name and is renamed into place, so a
        reader never sees a half-written library."""
        lib = self.library()
        if lib.exists():
            log = lib.with_suffix(".log")
            self.build_log = log.read_text() if log.exists() else ""
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
        self.library().with_suffix(".log").write_text(out)
        os.replace(proc.tmp, self.library())  # type: ignore[attr-defined]

    def lib(self) -> ctypes.CDLL:
        """The loaded shared library, building it first if needed."""
        if self._lib is None:
            proc = self.start_build()
            if proc is not None:
                self.finish_build(proc)
            self._lib = ctypes.CDLL(str(self.library()))
        return self._lib

    def fn(self):
        """The loaded C entry point."""
        if self._fn is None:
            f = getattr(self.lib(), self.entry)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn


_P = ctypes.c_void_p
DENSE_SUMS = CudaKernel(
    "dense_sums.cu", "dense_sums_launch",
    # packed, n, values[], live[], k, d, out, stream, device, route*
    [_P, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
     ctypes.c_int, ctypes.POINTER(ctypes.c_int)])

KERNELS = (DENSE_SUMS,)

# mirrors of constants of csrc/dense_sums.cu
MAX_LANES = 256        # DS_MAX_LANES
MAX_COLS = 32          # DS_MAX_COLS: columns per launch
THREADS = 128          # DS_THREADS: threads per block
PRIVATE_BLOCKS = 2     # use_private: blocks' worth of private slots
# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
H100_SMEM_PER_BLOCK = 232_448
_ROUTE_BITS = ((1, "private"), (2, "warp"), (4, "vector"), (8, "scalar"))


def dense_sums_path(k: int, d: int,
                    smem_per_block: int = H100_SMEM_PER_BLOCK) -> str:
    """The path one launch of K1 takes for k columns (k <= MAX_COLS) and
    d lanes, the rule of csrc/dense_sums.cu use_private: "private" (a u64
    slot per thread, column and lane in shared memory) when those slots
    fit twice in a block's shared memory, else "warp" (warp-aggregated
    shared atomics)."""
    slots_bytes = k * d * THREADS * 8
    return ("private" if slots_bytes * PRIVATE_BLOCKS <= smem_per_block
            else "warp")


def dense_sums_loads(packed: torch.Tensor,
                     values: Sequence[Optional[torch.Tensor]],
                     live: Sequence[Optional[torch.Tensor]]) -> str:
    """"vector" when the codes and every value column are 16-byte aligned
    and every live mask 4-byte aligned (csrc/dense_sums.cu vector_ok),
    else "scalar" (a view at an 8-byte offset, say)."""
    ok = packed.data_ptr() % 16 == 0
    ok = ok and all(v is None or v.data_ptr() % 16 == 0 for v in values)
    ok = ok and all(m is None or m.data_ptr() % 4 == 0 for m in live)
    return "vector" if ok else "scalar"


def dense_sums_routes(packed, values, live, n_lanes,
                      smem_per_block: int = H100_SMEM_PER_BLOCK):
    """[(path, loads)] for each launch dense_sums makes on these inputs."""
    routes = []
    for c0 in range(0, len(values), MAX_COLS):
        vs, ms = values[c0:c0 + MAX_COLS], live[c0:c0 + MAX_COLS]
        routes.append((dense_sums_path(len(vs), n_lanes, smem_per_block),
                       dense_sums_loads(packed, vs, ms)))
    return routes


def smem_per_block(device: torch.device) -> int:
    """The shared memory a block may use on a CUDA device, as K1's
    launcher reads it for its path rule."""
    f = DENSE_SUMS.lib().dense_sums_smem_per_block
    f.argtypes = [ctypes.c_int]
    f.restype = ctypes.c_int
    got = f(torch.device(device).index or 0)
    if got < 0:
        raise RuntimeError(f"dense_sums_smem_per_block: CUDA error {-got}")
    return got


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
    # the launcher zeroes out on the stream before the kernel adds into it
    out = torch.empty((k, n_lanes), dtype=torch.int64, device=packed.device)
    vptrs = (ctypes.c_void_p * k)(
        *[None if v is None else v.data_ptr() for v in values])
    lptrs = (ctypes.c_void_p * k)(
        *[None if m is None else m.data_ptr() for m in live])
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    route = ctypes.c_int(0)
    rc = DENSE_SUMS.fn()(packed.data_ptr(), packed.shape[0],
                         ctypes.addressof(vptrs), ctypes.addressof(lptrs),
                         k, n_lanes, out.data_ptr(), stream,
                         packed.device.index or 0, ctypes.byref(route))
    if rc != 0:
        raise RuntimeError(f"dense_sums kernel launch failed: CUDA error {rc}")
    DENSE_SUMS.count_launch()
    DENSE_SUMS.route = tuple(name for bit, name in _ROUTE_BITS
                             if route.value & bit)
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

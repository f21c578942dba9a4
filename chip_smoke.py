#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cockroach_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, each printed on lines of its own:
  1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  2. the build of every CUDA kernel (one nvcc per source, all at once);
  3. each kernel against its plain PyTorch version on the card, bit for
     bit, over a sweep of shapes (dense_sums: N x D with int64 extremes
     that wrap, dead codes -1 and D, live masks);
  4. TPC-H Q1 at SF 1, capacity 2^20, through the port's entry points
     (workload.tpch_queries.q1 -> exec.collect) on CUDA: the result must
     equal the port's numpy oracle (ints exact, avg float32 within 1e-6
     relative of the float64 oracle), and each kernel of the path must
     have launched (dense_sums: once per chunk, 6 times). Prints the cold
     time and the median warm time of 5 runs; data generation is off the
     clock;
  5. each kernel timed at the shape the main path gives it, beside its
     plain version, the one-call PyTorch yardstick and its bound; then
     the JSON line of kernels, the card line and, last, the result line.

Any mismatch or exception exits non-zero. With --profile DIR, one more
Q1 run is traced with torch.profiler and its kernel table is written to
DIR/q1_profile.txt.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SF = 1
CAPACITY = 1 << 20
WARM_RUNS = 5
# H100 SXM, NVIDIA's data sheet: HBM3 rate, and the float32 rate outside
# the tensor cores (the table has no int64 rate; int64 adds are counted
# against it)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def event_ms(torch, fn, reps: int = 30, flush=None) -> float:
    """Median device time of one call of fn, by CUDA events around each
    call, after a warm-up. `flush` (a large tensor) is overwritten before
    each call so the inputs come from device memory, not L2."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_busy_ms(trace_path: str):
    """(union of the device's kernel/copy/memset intervals in ms, their
    count) from a torch.profiler chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(spans)


# ------------------------------------------------------------ phase 3

def sweep_dense_sums(torch, ck, dev) -> int:
    """dense_sums vs dense_sums_plain on the card, bit for bit. Returns
    the largest absolute difference seen (must be 0)."""
    rng = np.random.default_rng(20261017)
    i64 = np.iinfo(np.int64)
    worst = 0
    for n in (1, 5000, 1 << 20, (1 << 22) + 3):
        for d in (1, 12, 37, 256):
            packed = rng.integers(-1, d + 1, n, dtype=np.int32)  # -1, d dead
            wide = rng.integers(i64.min, i64.max, n, dtype=np.int64,
                                endpoint=True)
            if n >= 4:
                wide[:4] = [i64.min, i64.max, i64.max, -1]
            small = rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64)
            mask = rng.random(n) > 0.3
            t = lambda a: torch.from_numpy(a).to(dev)
            values = [None, t(wide), t(small), None, t(-small)]
            live = [None, None, t(mask), t(mask), t(~mask)]
            got = ck.dense_sums(t(packed), values, live, d)
            want = ck.dense_sums_plain(t(packed), values, live, d)
            torch.cuda.synchronize()
            diff = int((got - want).abs().max().item())
            worst = max(worst, diff)
            ok = torch.equal(got, want)
            print(f"  dense_sums N={n} D={d} K={len(values)}: "
                  f"{'bit-exact' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise SystemExit(f"dense_sums disagrees with its plain "
                                 f"version at N={n} D={d}")
    return worst


# ------------------------------------------------------------ phase 4

def check_q1(res, oracle, rf_names, ls_names) -> None:
    n = len(res["count_order"])
    if n != len(oracle):
        raise SystemExit(f"Q1: {n} groups, oracle has {len(oracle)}")
    keys = [(int(a), int(b)) for a, b in zip(res["l_returnflag"],
                                             res["l_linestatus"])]
    order = sorted(keys, key=lambda k: (rf_names[k[0]], ls_names[k[1]]))
    if keys != order:
        raise SystemExit(f"Q1: rows out of order: {keys}")
    ints = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge")
    avgs = ("avg_qty", "avg_price", "avg_disc")
    for col in res:
        if col.endswith("__valid") and not res[col].all():
            raise SystemExit(f"Q1: {col} has nulls")
    for i, k in enumerate(keys):
        want = oracle[k]
        for j, col in enumerate(ints):
            if int(res[col][i]) != want[j]:
                raise SystemExit(f"Q1 {k} {col}: {res[col][i]} != {want[j]}")
        if int(res["count_order"][i]) != want[7]:
            raise SystemExit(f"Q1 {k} count_order mismatch")
        for j, col in enumerate(avgs):
            got, ref = float(res[col][i]), float(want[4 + j])
            if not np.isfinite(got) or abs(got - ref) > 1e-6 * abs(ref):
                raise SystemExit(f"Q1 {k} {col}: {got} vs {ref}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one more Q1 run and write its kernel table")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.exec.operators import ScanOp, collect
    from cockroach_tpu_torch.ops import agg
    from cockroach_tpu_torch.ops import cuda_kernels as ck
    from cockroach_tpu_torch.workload import tpch
    from cockroach_tpu_torch.workload.tpch_queries import q1, q1_oracle

    # ---- 1. device
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind} (count {torch.cuda.device_count()}); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    ck.build_all()
    print(f"[2] built {len(ck.KERNELS)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for k in ck.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {k.source.name}: {line.strip()}")

    # ---- 3. kernels vs plain versions
    print("[3] kernels against their plain versions", flush=True)
    worst = sweep_dense_sums(torch, ck, dev)

    # ---- 4. the main path: Q1 SF 1 through the port on CUDA
    t0 = time.perf_counter()
    gen = tpch.TPCH(sf=SF)
    table = gen.table("lineitem")
    flow = q1(gen, CAPACITY)
    scan = flow
    while not isinstance(scan, ScanOp):
        scan = scan.child
    cols = scan.schema.names()
    n_rows = gen.num_rows("lineitem")
    chunks = [{c: table[c][a:a + CAPACITY] for c in cols}
              for a in range(0, n_rows, CAPACITY)]
    scan._chunks = lambda: iter(chunks)  # data generation off the clock
    oracle = q1_oracle(gen)
    print(f"[4] Q1 SF {SF}: {n_rows} lineitem rows in {len(chunks)} chunks "
          f"of {CAPACITY} (datagen + oracle {time.perf_counter() - t0:.2f} s)",
          flush=True)

    for k in ck.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    res = collect(flow)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k.source.stem: k.launches for k in ck.KERNELS}
    rf_names = gen.schema("lineitem").dicts["l_returnflag"]
    ls_names = gen.schema("lineitem").dicts["l_linestatus"]
    check_q1(res, oracle, rf_names, ls_names)
    if launches["dense_sums"] != len(chunks):
        raise SystemExit(f"dense_sums launched {launches['dense_sums']} "
                         f"times on the main path, expected {len(chunks)}")
    warm = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        again = collect(flow)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        for c in res:
            if not np.array_equal(np.asarray(again[c]), np.asarray(res[c])):
                raise SystemExit(f"Q1 warm run differs in {c}")
    warm_s = statistics.median(warm)
    print(f"  result matches q1_oracle: {len(res['count_order'])} groups, "
          f"launches {launches}", flush=True)
    print(f"  cold {cold:.4f} s; warm median {warm_s:.4f} s of "
          f"{[round(w, 4) for w in warm]} ({n_rows / warm_s:,.0f} rows/s)",
          flush=True)
    # host-side stage times of one more run (device work: enqueue time)
    col = stats.enable()
    collect(flow)
    torch.cuda.synchronize()
    stats.disable()
    for line in col.report().splitlines():
        print("  " + line)

    # ---- 5. kernels at the main path's shapes
    agg_op = flow.child
    first = next(agg_op.child.batches(dev))
    packed, values, live, d = agg.dense_kernel_inputs(
        first, agg_op.group_by, agg_op.internal, agg_op.dense_sizes)
    n = packed.shape[0]
    got = ck.dense_sums(packed, values, live, d)
    want = ck.dense_sums_plain(packed, values, live, d)
    torch.cuda.synchronize()
    worst = max(worst, int((got - want).abs().max().item()))
    if not torch.equal(got, want):
        raise SystemExit("dense_sums disagrees with its plain version on Q1")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernel_ms = event_ms(torch, lambda: ck.dense_sums(packed, values, live, d),
                         flush=flush)
    plain_ms = event_ms(
        torch, lambda: ck.dense_sums_plain(packed, values, live, d),
        flush=flush)
    stacked = torch.stack(
        [torch.ones(n, dtype=torch.int64, device=dev) if v is None else v
         for v in values], dim=1)
    idx = torch.where((packed >= 0) & (packed < d), packed, d).long()
    library_ms = event_ms(
        torch, lambda: torch.zeros((d + 1, len(values)), dtype=torch.int64,
                                   device=dev).index_add_(0, idx, stacked),
        flush=flush)
    k_cols = len(values)
    n_value_cols = sum(v is not None for v in values)
    n_live_cols = sum(m is not None for m in live)
    nbytes = n * (4 + 8 * n_value_cols + n_live_cols) + 8 * k_cols * d
    in_range = int(((packed >= 0) & (packed < d)).sum().item())
    ops = in_range * k_cols
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[5] dense_sums at Q1's shape N={n} D={d} K={k_cols}: "
          f"kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, "
          f"library_ms {library_ms:.4f} (index_add_), bound_ms "
          f"{bound_ms:.4f} ({nbytes} bytes)", flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            collect(flow)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(args.profile, "q1_profile.txt")
        with open(path, "w") as f:
            f.write(prof.key_averages().table(sort_by="device_time_total",
                                              row_limit=60))
        trace = os.path.join(args.profile, "q1_trace.json")
        prof.export_chrome_trace(trace)
        busy_ms, n_dev = device_busy_ms(trace)
        print(f"  traced Q1 run: {n_dev} device kernels/copies, device busy "
              f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall; kernel table in "
              f"{path}")

    kernels = [{
        "name": "dense_sums",
        "route": "cuda",
        "source": "cockroach_tpu_torch/csrc/dense_sums.cu",
        "replaces": "cockroach_tpu/ops/pallas_kernels.py:89",
        "launches": launches["dense_sums"],
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }]
    print(json.dumps({"q1": {"sf": SF, "capacity": CAPACITY,
                             "cold_s": cold, "warm_s": warm_s,
                             "warm_runs_s": warm}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

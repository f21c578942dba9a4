#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cockroach_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile DIR] [--trace-runs N] [--seed S]

Phases, each printed on lines of its own:
  1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  2. the build of every CUDA kernel (one nvcc per source, all at once);
  3. each kernel against its plain PyTorch version on the card, bit for
     bit, over a sweep of shapes (dense_sums: N x D with int64 extremes
     that wrap, dead codes -1 and D, live masks; then views at 8-byte and
     smaller offsets, one hot code, every row dead, K = 1, 6, 32 and 33),
     each case with the route its launches took (private slots or
     warp-aggregated, vector or scalar loads), held against the rule of
     ops/cuda_kernels.py dense_sums_routes;
  4. TPC-H Q1 at SF 1, capacity 2^20, through the port's entry points
     (workload.tpch_queries.q1 -> exec.collect) on CUDA, its scan marked
     resident before the cold run (the JAX package's bench.py
     _make_resident): the result must equal the port's numpy oracle
     (ints exact, avg float32 within 1e-6 relative of the float64
     oracle), and each kernel of the path must have launched (dense_sums:
     once per chunk, 6 times, in every run). The 5 warm runs fold the
     resident image (agg.fold_stacked) with no scan.pack or
     scan.transfer, and leave the image's checksum as the cold run left
     it. Then a streaming flow (cache key off; a cold and 3 warm runs)
     and a fresh plan build, which must borrow the image from the
     scan-image cache. Prints the cold time, the resident and streaming
     warm medians, the synchronizing calls of a warm run, the host
     stages, the image's MiB and the device memory peak; data generation
     is off the clock;
  5. each kernel timed at the shape the main path gives it, beside its
     plain version, the one-call PyTorch yardstick, its bound and its
     first version's time, and again at 4 x the rows (the streaming rate
     and the fixed cost of a call);
  6. TPC-H Q6, Q3 and Q18 (threshold 300) at SF 1, capacity 2^20, through
     workload.tpch_queries -> exec.collect on CUDA, data generated off the
     clock, every scan resident as in phase 4: one cold run and 5 warm
     runs of each built flow (no warm run may pack or copy, the images'
     checksums must not change), a fresh plan build that must borrow
     every image, and a streaming flow (cache off, 2 runs), every run
     equal to the query's columnar oracle (q6_oracle,
     q3_oracle_columnar, q18_oracle_columnar), row for row. Prints the
     cold time, the median and every warm time, the FlowRestart count of
     each run (Q18's first aggregate, 1.5 M groups, overflows a 2^20
     accumulator: one restart on the cold run, none warm — anything else
     fails), the kernel launches of each run (set to 0 just before it and
     read just after), the host stage timers (scan.pack, scan.transfer,
     scan.stack, join.build, agg.fold, shrink) of the cold, a warm and
     the streaming warm run, the synchronizing CUDA calls of one warm
     run, the stacked events of the warm runs (agg.fold_stacked,
     join.build_stacked), the images' MiB, the phase's device memory
     peak and the scan-image cache's size; Q6 once more with
     storage.hbm_cache_bytes below one chunk, which must stay streaming
     and equal its oracle; and the device time of one call of each layer
     (Q3's join build and probe, Q18's aggregate partial and fold step,
     its top-K);
  7. TPC-H Q9, Q12 and Q14 at SF 1 in the same way, against
     q9_oracle_columnar, q12_oracle_columnar and q14_oracle_columnar: no
     run may restart (every ShrinkOp's start capacity exceeds its real
     row count at SF 1), and each Q12 run must launch dense_sums once per
     lineitem chunk (its GROUP BY on l_shipmode takes the dense route).
     The device time of one call of Q9's ShrinkOp over the semi join's
     6 x 2^20 lanes, Q9's composite-key join probe against partsupp and
     Q12's dense GROUP BY of one batch; dense_sums at Q12's shape against
     its plain version;
  8. TPC-H Q4, Q17, Q16, Q2, Q15, Q5, Q10 and Q19 at SF 1 in the same
     way, each run equal to its oracle (columnar where the row loop
     walks lineitem). Their plans run the decorrelated subqueries
     (EXISTS as a semi join, Q2's correlated MIN and Q15's uncorrelated
     MAX as LEFT joins against an aggregate), DISTINCT (Q16) and the
     anti join. The cold runs restart as COLD_RESTARTS says (Q2 once,
     Q16 twice: ShrinkOps whose start capacities are below SF 1's rows;
     Q4 once: its semi join's build keys repeat), the warm runs never;
     Q4 launches dense_sums once per orders chunk and Q5 once (the one
     batch of its ShrinkOp). The device time of one call of Q2's and
     Q15's LEFT join probes, Q17's per-part GROUP BY partial and fold
     step and Q16's DistinctOp; dense_sums at Q4's and Q5's shapes
     against its plain version, bit for bit, and timed beside its bound
     as in phase 5. Phases 4 and 6 to 8 run the streaming tier
     (`collect(flow, fuse=False)`);
  9. the fifteen queries through `collect(flow)`, whose default is the
     fused tier (exec/fused.py): each query one CUDA graph over its
     resident images. Per query a cold run (the images borrowed from the
     scan-image cache, the eager warm-up, the capture, a replay) and 5
     warm runs, each equal to its oracle and to its streaming result of
     phases 4 to 8, none leaving the fused tier (no
     `fused.fallback_*` or `resilience.*` event; the one exception
     allowed is the JAX tracer's own workmem rule, printed); every warm
     run exactly one graph replay with at most one synchronizing call
     inside collect, no restart (the cold run's as COLD_RESTARTS_FUSED
     says), the routes of FUSED_ROUTES and every image unchanged. One
     more warm run is traced with torch.profiler: it must be a replay,
     and the dense_sums kernels the trace shows it running must number
     FUSED_K1 (the launch counts the runner adds on each replay, from
     what its capture recorded, must agree). Then every graph is
     replayed once more after all the captures (the graphs share one
     memory pool) and held to its oracle, and dense_sums at the shapes
     of the fused Q1, Q4, Q5 and Q12 (one call over each dense GROUP BY's
     materialized input) held bit for bit and timed. Prints per query
     the fused warm median and every warm time, the cold time, the
     capture ms, the restarts per run, the syncs, the graph pool's
     growth, the routes, and the traced replay's device busy ms, kernel
     count, cummax total and three longest device ops, and the joins
     whose unique build took the payload carry;
 10. the out-of-core paths at SF 1, capacity 2^20, on streaming flows
     (data generated off the clock, the scan-image cache off), every run
     equal to its oracle and to its rows from phases 6-7, with the
     host-spill monitor back at 0 and no spill file left after it:
     (a) Q18 (threshold 300) with every operator at 32 MiB, the spill
     rung's budget (agg.grace_spill), (b) Q18 at 4 MiB (agg.grace_spill,
     join.grace_spill twice), (c) Q9 at 8 MiB (join.grace_spill), a cold
     run and 2 more each, printing the wall time, the spill rows and
     bytes written and replayed, the host ms of partitioning, device
     runs, the host merge and replay, and the device memory peak beside
     the same query's unbounded streaming run; Q9 at 8 MiB with the
     build replay's read-ahead on and off in alternating pairs; (d) an
     external sort of every lineitem row (ORDER BY l_shipdate,
     l_orderkey DESC, l_linenumber, l_quantity carried) at 32 MiB, equal
     to numpy's stable lexsort (one external spill, at least 2 device
     runs, one host merge); (e) Q3 whose streaming tier raises
     torch.cuda.OutOfMemoryError until the spill rung clamps its
     workmem: resilience.degrade.streaming, every workmem restored; (f)
     Q18 at 32 MiB through collect(flow): the fused tracer declines on
     its workmem rule, the streaming operators complete through the
     grace paths; (g) the range-dense GROUP BY against the sort route at
     Q17's per-part and Q18's first GROUP BY (10 alternating pairs),
     merge_join against hash_join at Q3's orders x lineitem join, and Q3
     built with sql.tpu.invariants on.
 11. the SQL front end at SF 1, capacity 2^20, through a Session over
     the TPC-H catalog (sql/session.py; its scans resident, data
     generated off the clock). The images phases 6-9 left in the
     scan-image cache are held aside on the card while phase 10 empties
     the cache (ScanImageCache.snapshot), and put back (restore). (a) The ten SQL texts
     (workload/tpch_queries.py SQL: Q1, Q3, Q5, Q6, Q9, Q10, Q12, Q14,
     Q16, Q18): a cold execute (no scan.pack where every scan's image is
     cached: a binder's scan lists its columns in table order, and a
     hand plan whose order differs has another image) and WARM_RUNS warm
     executes, each a prepared hit with no parse, exactly one graph
     replay and at most one synchronizing call; every run equal to its
     oracle and to phase 9's rows. Per query the parse + bind ms, the
     compile_plan ms, the cold ms, the warm median and phase 9's fused
     warm median. (b) Traced warm replays (--trace-runs, default 1) of
     the SQL Q1 and Q12 each run FUSED_K1 dense_sums kernels, and a warm
     run counts as many; every trace is read on both sides (device
     kernels, the host's graph launches), and one is taken again only
     when its host side shows the replay's graph launch and its device
     side holds no record at all (the profiler's loss: a graph launch
     runs every node); the readings go into the kernels line. (c) A
     window query (row_number, rank, sum, min and lag over (partition by
     l_orderkey order by l_linenumber), a string max over (partition by
     l_suppkey)) over all of lineitem at the default workmem: the fused
     tracer declines it by its workmem rule (its result, 5,999,464 rows,
     is past the packed window too) and the session's executes run the
     streaming operators; and over the orders up to key
     WINDOW_PART_ORDERKEY (about 960,000 rows, inside the packed window)
     under SET workmem = 1 GiB, each warm execute one replay (one
     traced). Each: a cold and WARM_RUNS warm executes and 3 streaming
     runs of the prepared tree, each equal to a numpy oracle (exact:
     every column is an integer), held to plain PyTorch (torch.sort per
     segment) for rank, min and max. (d) The row engine: upper(s_name) and an exact
     decimal division (SET exact_arithmetic = on) over supplier, each a
     RowMapOp over a CompiledSubtreeOp (one CUDA graph), equal to its
     oracle, with its tier table. (e) EXPLAIN and EXPLAIN ANALYZE of Q3,
     every tier fused. (f) The cost model's coefficients (sql/cost.py):
     the dispatch floor (a warm execute of select count(*) from region),
     the device rows/s (lineitem over phase 9's fused Q1 warm median),
     the host rows/s (the row engine's). (g) `python -m
     cockroach_tpu_torch sql --sf 0.01 -e <Q6>` in a subprocess: exit 0
     and the oracle's revenue.
 12. the MVCC storage layer (cockroach_tpu_torch/storage/), with the
     scan-image cache's earlier images held aside (snapshot, clear,
     restore after) so the resident pin fits its budget. (a) g++ builds
     the native engine from the checkout; a NativeEngine is opened (not
     open_engine's Python fallback). (b) TPC-H SF 1 loaded with
     `mvcc_load` (the eight tables, ingest seconds per table), the
     lineitem host walk's rows/s, and the fifteen queries through the
     MVCCCatalog on the fused tier, every scan resident: a cold run and
     MVCC_WARM_RUNS warm runs, each equal to phase 9's rows, every warm
     run one graph replay with at most one synchronizing call, K1 as
     FUSED_K1 says a replay (and in a traced replay of Q1); Q1 and Q18
     through fresh plan builds on the streaming tier (K1 once per
     lineitem chunk). (c) lineitem on the device-resident tier
     (storage.resident_scan on): the attach ms, the resident bytes, the
     CUDA-event ms of visible_image and of fold_versions at its shape
     beside their byte bounds (the live lanes read, the visible rows
     written); Q1 and Q6 read through a catalog pinned at a timestamp
     (`MVCCCatalog(ts=)`, no cache key, streaming tier), and, first
     at each data state, through the load's catalog on the fused tier
     (a cold run whose prefetch runs the visibility pass, and after the
     burst the fold, under the sync debug mode, then MVCC_WARM_RUNS
     replays, equal to the streaming read), before a burst of
     BURST_PUTS puts (new l_quantity,
     l_extendedprice, l_discount) and BURST_DELETES deletes, after it
     (one fold, no rebuild), before it again over the folded arrays
     (phase 9's rows), after a second burst under a lowered
     storage.resident_compact_fraction (a compaction), and at both
     burst timestamps on the host walk (table detached, setting off),
     which the resident reads must equal; each read's host stages
     (READ_STAGES) and scan.resident_transfer bytes; no fallback, no
     failed attach. (d) YCSB-E at YCSB_RECORDS records loaded with
     per-row puts: run_e's host ops/s and rows scanned, scan_topk_flow
     (k YCSB_TOPK) cold and warm against numpy's top, and YCSB_OPS
     micro-queries (k YCSB_MICRO_K) one call each and in batches of
     YCSB_BATCH, bit-identical and equal to a numpy oracle per op, with
     both rates and the occupancy.
 13. the storage-backed session (sql/session.py SessionCatalog) at SF 1
     on CUDA, the scan-image cache's images held aside as in phase 12:
     (a) lineitem (a hidden rowid), orders and customer loaded
     (`session_load`: the session's row codec straight into a native
     engine, descriptors with the generator's dictionaries), each read
     back by a host walk through `table_chunks` equal to the generator
     by digest; (b) the SQL Q1 and Q6 through a Session with the
     resident tier on: a cold execute and WARM_RUNS prepared hits (one
     replay, at most one sync each), a traced warm Q1 replay running
     FUSED_K1 dense_sums, every result equal to its oracle and to phase
     9's rows; (c) TPC-H RF1 (SF x RF1_ORDERS new orders with 1-7
     lineitems each, drawn from --seed) inserted in INSERT_ROWS-row
     statements in a transaction: a second session's Q1 meanwhile is a
     replay of the old rows; COMMIT; the next Q1 rebuilds over the
     folded resident image and the one after replays, both equal to the
     oracle over the union, with K1 once a traced replay; a second batch
     rolled back leaves Q1 unchanged; (d) CREATE INDEX on INDEX_ON
     (a jobs-registry backfill of every row), EXPLAIN naming the index
     scan, POINT_LOOKUPS point lookups (keys from --seed) each equal to
     numpy, and an insert found through the index; (e) UPDATE, DELETE
     and ALTER TABLE ADD COLUMN on customer and ANALYZE lineitem, timed,
     every read after them equal to numpy; (f) the 35 files of
     tests/testdata/logic through sessions on CUDA (capacity 128), each
     block as the file expects.
 14. the lifecycle seams (run_phase14) at SF 1 on CUDA, through Sessions
     over phase 11's TPC-H catalog (its images back in the cache; the
     sessions share one prepared cache): (a) SQL Q1 cold and WARM_RUNS
     prepared hits with `sql.trace.enabled` off, then on (its default):
     each hit one replay with at most one sync and one K1 launch, K1
     once in a traced replay, the session's own cost over collect
     beside phase 11's, the root span's tree printed; (b) EXPLAIN
     ANALYZE of Q1 and Q3 (span tree, digest at tier fused, operators)
     and EXPLAIN ANALYZE (DEBUG)'s statement bundle, read back; (c)
     statement_timeout 0.1 s over phase 11's window query of all of
     lineitem: 57014 and the time from the deadline to the raise, then
     the session's Q1 a replay with one sync and equal rows, no
     prefetch thread alive, device memory within 64 MiB of before; (d)
     the same statement in a thread, listed executing by a second
     session's SHOW QUERIES and cancelled by its CANCEL QUERY: 57014 in
     the first session, the cancel latency, SHOW QUERIES empty after;
     (e) `sql.admission.session_slots` 1 with the slot held: a work
     statement sheds with 53300, SET and SHOW pass; `admission_slots`
     2: 4 threads of Q1, every result equal to the oracle and the flow
     queue's used gauge never above 2; (g) chaos on the card, seeded:
     Q1 under scan.transfer, scan.stack, fused.compile, fused.exec and
     cache.insert, Q3 and Q18 under scan.transfer and fused.exec, at
     probability 0.3, each a cold run bit-equal to its fault-free run
     (a fired point shows a retry or a degradation); a forced fused
     out-of-memory completes on the streaming tier; a RuntimeError
     planted in the resident tier's visibility pass and fold propagates
     with the table attached, an out-of-memory falls back to the host
     walk and detaches; (f) crdb_internal.node_metrics shows the retry,
     degradation and restart counters the phase moved, and a Q6 slowed
     by an armed delay fault is flagged slow in
     cluster_execution_insights and logged by the slow-query log (a
     MemorySink on SQL_EXEC).
 15. streaming and vector search (run_phase15) on CUDA, on native-engine
     stores of their own (the scan-image cache's images held aside): (a)
     a session table cf (k, grp, v) written in CF_BURSTS bursts of
     CF_BURST_ROWS rows (INSERT_ROWS-row INSERTs), a ChangefeedStream
     with a MemorySink polled after each: envelopes/s and the p50/p99 of
     changefeed_frontier_lag_ns, one envelope per key equal to its row;
     (b) views `select grp, count(*), sum(v) ... group by grp` over
     bursts of FOLD_BURSTS rows: FOLD_RUNS refreshes by fold, then
     FOLD_RUNS by `_rescan`, no re-scan during the folds, every read
     equal to the session's GROUP BY; (c) TPC-H customer at SF 1
     (session_load) under the views V_SEG and V_MM and a continuous
     CREATE CHANGEFEED into a file sink (a poll every FEED_POLL_MS)
     adopted on a background thread:
     phase 13's UPDATE of nation UPDATE_NATION, PAUSE JOB, its DELETE
     above DELETE_ABOVE, RESUME JOB, VIEW_CUSTOMERS new customers; both
     views refreshed after each write and equal to the GROUP BY, V_SEG
     re-scanned only at its build, V_MM re-scanned at each write that
     retracts (MIN/MAX cannot fold a retraction) and folded at the
     INSERT; the job caught up, cancelled, and its acked segments
     replayed key by key onto the final table with no (key, ts) twice;
     (d) workload/vectorbench.py `run` at bench.py's shape (VEC_N x
     VEC_D, VEC_CLUSTERS clusters, nprobe VEC_NPROBE, VEC_QUERIES
     queries, k VEC_K, from --seed) and its searchers rebuilt on the same
     data: exact ids equal a float64 numpy oracle's up to ties, batched
     equal to per-query bit for bit, recall@k at least
     VEC_RECALL_FLOOR; (e) the same vectors as a session table docs (id,
     grp, emb vector(VEC_D)): ORDER BY emb <-> q LIMIT k cold and warm
     (a prepared hit, one replay, at most one sync), WHERE grp = 1, <=>,
     then with sql.vector.ann_topk on (nprobe VEC_NPROBE) cold (an index
     build) and warm (the cached index), and after an INSERT of
     VEC_INSERT rows (one index append, no build); every answer equal to
     the searchers' (ids up to float64 ties).
Then the whole run's seconds (`[16]`), one JSON line per query (Q1 and
phases 6 to 9), phase 10's JSON line, one `sql_<name>` JSON line per
phase 11 record, the JSON lines of phases 12 to 15, the
JSON line of
kernels (dense_sums' launches in the Q1 run, by path: Q1, Q12, Q4 and
Q5, in the traced fused replays of Q1, Q4, Q5 and Q12, in the traced SQL
replays of Q1 and Q12, with every trace's reading, in the MVCC runs of
phase 12, in the session's traced Q1 replays of phase 13, before and
after the committed write, and in phase 14's traced session replays,
`q1_traced_session`; its
times at Q1's, Q4's and Q5's shapes and at the fused queries' shapes),
the card line and, last, the result line.

Phase 2 fails if ptxas reports spills in dense_sums' Q1 instantiation,
or if its SASS (cuobjdump -sass) holds a shared-memory atomic (ATOMS).

Any mismatch or exception exits non-zero. With --profile DIR, one more
run of each query is traced with torch.profiler: the kernel tables go to
DIR/<query>_profile.txt, the traces to DIR/<query>_trace.json, and
phases 6, 7 and 8 print each query's device busy time, the join probes'
cummax total and call count, and its ten longest device ops. Phase 9's
traced replays go to DIR/<query>_fused_*, or without --profile to
build/phase9_traces/; phase 11's to DIR/sql_* or build/phase11_traces/;
phase 12's to DIR/q1_mvcc_fused_* or build/phase12_traces/; phase 13's
to DIR/q1_session* or build/phase13_traces/; phase 14's to
DIR/q1_trace_* or build/phase14_traces/.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from decimal import Decimal

import numpy as np

SF = 1
CAPACITY = 1 << 20
WARM_RUNS = 5
Q1_STREAMING_RUNS = 3
# H100 SXM, NVIDIA's data sheet: HBM3 rate, and the float32 rate outside
# the tensor cores (the table has no int64 rate; int64 adds are counted
# against it)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# dense_sums at Q1's shape in its first version, before the redesign for
# Hopper (PERF.md, Findings: NVIDIA H100 80GB HBM3, 700.00 W)
DENSE_SUMS_FIRST_MS = 0.2161
# the name of dense_sums' main kernel in a profiler trace; one call of
# the wrapper launches one for each 32 columns (ops/cuda_kernels.py
# MAX_COLS), and every fused query's dense GROUP BY has fewer
DS_KERNEL = "dense_sums_kernel"
# dense_sums_kernel<KC, EXACT, VEC, PRIV> as ptxas names it; Q1's
# instantiation is <6, true, true, true>
_DS_ENTRY = re.compile(r"dense_sums_kernelILi(\d+)ELb(\d)ELb(\d)ELb(\d)EE")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def event_ms(torch, fn, reps: int = 30, flush=None,
             clean: bool = False) -> float:
    """Median device time of one call of fn, by CUDA events around each
    call, after a warm-up. `flush` (a large tensor) is overwritten before
    each call so the inputs come from device memory, not L2; that leaves
    L2 full of dirty lines, which the call's reads write back. With
    `clean`, flush is summed instead, which leaves L2 full of clean
    lines."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None and clean:
            flush.sum(dtype=torch.int64)
        elif flush is not None:
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


# ------------------------------------------------------------ phase 2

def dense_sums_ptxas(log: str):
    """{(KC, exact, vector, private): (registers, spill store bytes,
    spill load bytes)} from dense_sums' `-Xptxas -v` log."""
    out = {}
    key = None
    for line in log.splitlines():
        m = _DS_ENTRY.search(line)
        if "Compiling entry" in line:
            key = tuple(int(g) for g in m.groups()) if m else None
            continue
        if key is None:
            continue
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        got = out.setdefault(key, [None, None, None])
        if regs:
            got[0] = int(regs.group(1))
        if spill:
            got[1], got[2] = int(spill.group(1)), int(spill.group(2))
    return {k: tuple(v) for k, v in out.items()}


def dense_sums_q1_sass(ck) -> dict:
    """Counts of shared-memory atomics (ATOMS) and of 16-byte evict-first
    loads (LDG.E.EF.128) in the SASS of dense_sums' Q1 instantiation."""
    cuobjdump = os.path.join(os.path.dirname(ck._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(ck.DENSE_SUMS.library())],
                          capture_output=True, text=True, check=True).stdout
    q1 = [f for f in sass.split("Function : ")
          if (m := _DS_ENTRY.search(f.split("\n", 1)[0]))
          and m.groups() == ("6", "1", "1", "1")]
    if len(q1) != 1:
        raise SystemExit(f"dense_sums' Q1 instantiation: {len(q1)} SASS "
                         f"functions found, expected 1")
    return {op: q1[0].count(op) for op in ("ATOMS", "LDG.E.EF.128")}


# ------------------------------------------------------------ phase 3

def check_dense_case(torch, ck, name, packed, values, live, d,
                     smem) -> int:
    """One dense_sums case against its plain version, bit for bit, and
    the route its launches took against the rule. Returns the largest
    absolute difference (0)."""
    got = ck.dense_sums(packed, values, live, d)
    route = ck.DENSE_SUMS.route
    want = ck.dense_sums_plain(packed, values, live, d)
    torch.cuda.synchronize()
    diff = int((got - want).abs().max().item())
    ok = torch.equal(got, want)
    rule = ck.dense_sums_routes(packed, values, live, d, smem)
    print(f"  dense_sums {name} N={packed.shape[0]} D={d} K={len(values)}: "
          f"{'bit-exact' if ok else 'MISMATCH'}, route "
          f"{'+'.join(route)} ({len(rule)} launch(es): "
          f"{', '.join('/'.join(r) for r in rule)})", flush=True)
    if not ok:
        raise SystemExit(f"dense_sums disagrees with its plain version: "
                         f"{name} N={packed.shape[0]} D={d}")
    if set(route) != {x for r in rule for x in r}:
        raise SystemExit(f"dense_sums took route {route}, its rule says "
                         f"{rule}: {name}")
    return diff


def dense_edge_cases(torch, ck, dev, smem) -> int:
    """The cases beside the sweep: offset views (scalar loads), one hot
    code, every row dead, and column counts 1, 6, 32 and 33 on both
    paths. Returns the largest absolute difference (0)."""
    rng = np.random.default_rng(20261018)
    n = (1 << 20) + 3
    t = lambda a: torch.from_numpy(a).to(dev)
    worst = 0

    def cols(k, masks=True):
        values, live = [], []
        for c in range(k):
            values.append(None if c % 3 == 2 else t(rng.integers(
                -(1 << 62), 1 << 62, n, dtype=np.int64)))
            live.append(t(rng.random(n) > 0.2) if masks and c % 2 else None)
        return values, live

    def shifted(x, by):
        # a contiguous view whose start is `by` elements into a larger
        # buffer: 8 bytes for int64, 4 for int32, 1 for bool
        if x is None:
            return None
        buf = torch.empty(x.shape[0] + by, dtype=x.dtype, device=dev)
        buf[by:].copy_(x)
        return buf[by:]

    for d in (12, 256):
        packed = t(rng.integers(-1, d + 1, n, dtype=np.int32))
        values, live = cols(6)
        for name, p, vs, ms in (
                ("values at +8 B", packed, [shifted(v, 1) for v in values],
                 live),
                ("values at +24 B", packed,
                 [shifted(v, 3) for v in values], live),
                ("codes at +4 B", shifted(packed, 1), values, live),
                ("live masks at +1 B", packed, values,
                 [shifted(m, 1) for m in live])):
            worst = max(worst, check_dense_case(torch, ck, name, p, vs, ms,
                                                d, smem))
        hot = torch.full((n,), d // 2, dtype=torch.int32, device=dev)
        worst = max(worst, check_dense_case(torch, ck, "one hot code", hot,
                                            values, live, d, smem))
        dead = t(np.where(rng.random(n) > 0.5, -1, d).astype(np.int32))
        worst = max(worst, check_dense_case(torch, ck, "every row dead",
                                            dead, values, live, d, smem))
        for k, masks in ((1, True), (6, False), (32, True), (33, True)):
            values, live = cols(k, masks)
            name = f"K={k}" + ("" if masks else " no live masks")
            worst = max(worst, check_dense_case(torch, ck, name, packed,
                                                values, live, d, smem))
    # the private path with more than 8 columns (chunks of 8) and two
    # private launches
    for k, d in ((32, 3), (33, 3)):
        packed = t(rng.integers(-1, d + 1, n, dtype=np.int32))
        values, live = cols(k)
        worst = max(worst, check_dense_case(torch, ck, f"K={k}", packed,
                                            values, live, d, smem))
    return worst


def sweep_dense_sums(torch, ck, dev) -> int:
    """dense_sums vs dense_sums_plain on the card, bit for bit. Returns
    the largest absolute difference seen (must be 0)."""
    rng = np.random.default_rng(20261017)
    i64 = np.iinfo(np.int64)
    smem = ck.smem_per_block(dev)
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
            worst = max(worst, check_dense_case(
                torch, ck, "sweep", t(packed), values, live, d, smem))
    return max(worst, dense_edge_cases(torch, ck, dev, smem))


def sector_bytes(torch, in_range, lane_bytes: int) -> int:
    """Bytes of the 32-byte sectors that hold a column's in-range lanes
    (the column starting on a sector): what a reader of only those lanes
    must fetch."""
    per = 32 // lane_bytes
    n = in_range.shape[0]
    m = torch.zeros(n + (-n) % per, dtype=torch.bool, device=in_range.device)
    m[:n] = in_range
    return 32 * int(m.view(-1, per).any(dim=1).sum().item())


def measure_dense_sums(torch, ck, packed, values, live, d, flush) -> dict:
    """dense_sums at one shape: its device ms, its plain version's and
    the one-call PyTorch yardstick's (index_add_), each the median of 30
    CUDA-event timings after an L2 flush that leaves dirty lines, the
    kernel's again after one that leaves clean lines, and its bound: the
    bytes it must move over PEAK_BYTES_PER_S, or its int64 adds over
    PEAK_OPS_PER_S where that is longer. The bytes are every code read
    once, the value columns and live masks read only at lanes whose code
    is in range (a dead lane's value adds nothing), rounded up to the
    32-byte sectors those lanes touch, and the D x K sums written once."""
    n, k_cols, dev = packed.shape[0], len(values), packed.device
    kernel_ms = event_ms(torch, lambda: ck.dense_sums(packed, values, live, d),
                         flush=flush)
    clean_ms = event_ms(torch, lambda: ck.dense_sums(packed, values, live, d),
                        flush=flush, clean=True)
    plain_ms = event_ms(
        torch, lambda: ck.dense_sums_plain(packed, values, live, d),
        flush=flush)
    stacked = torch.stack(
        [torch.ones(n, dtype=torch.int64, device=dev) if v is None else v
         for v in values], dim=1)
    in_mask = (packed >= 0) & (packed < d)
    idx = torch.where(in_mask, packed, d).long()
    library_ms = event_ms(
        torch, lambda: torch.zeros((d + 1, k_cols), dtype=torch.int64,
                                   device=dev).index_add_(0, idx, stacked),
        flush=flush)
    n_value_cols = sum(v is not None for v in values)
    n_live_cols = sum(m is not None for m in live)
    in_range = int(in_mask.sum().item())
    nbytes = (4 * n + n_value_cols * sector_bytes(torch, in_mask, 8)
              + n_live_cols * sector_bytes(torch, in_mask, 1)
              + 8 * k_cols * d)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = in_range * k_cols / PEAK_OPS_PER_S * 1e3
    return {"n": n, "d": d, "k": k_cols, "in_range": in_range,
            "bytes": nbytes, "ms": kernel_ms,
            "clean_l2_ms": clean_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


# ------------------------------------------------------------ phases 6, 7

PHASE6 = ("q6", "q3", "q18")
PHASE7 = ("q9", "q12", "q14")
PHASE8 = ("q4", "q17", "q16", "q2", "q15", "q5", "q10", "q19")
Q18_THRESHOLD = 300  # the spec's
# host stage timers printed per query (exec/stats.py)
STAGES = ("scan.pack", "scan.transfer", "scan.stack", "join.build",
          "agg.fold", "shrink")
# the events a warm run of a resident flow must not have, and those that
# show the stacked fold and build
STREAMING_EVENTS = ("scan.pack", "scan.transfer")
STACKED_EVENTS = ("agg.fold_stacked", "join.build_stacked")
# queries whose warm runs must fold a GROUP BY over a resident image:
# their aggregate reads MapOp -> ScanOp
MUST_FOLD_STACKED = ("q1", "q6")
Q_COLUMNS = {
    "q6": ("revenue",),
    "q3": ("l_orderkey", "revenue", "o_orderdate", "o_shippriority"),
    "q18": ("c_name", "c_custkey", "o_orderkey", "o_orderdate",
            "o_totalprice", "sum_qty"),
    "q9": ("n_name", "o_year", "sum_profit"),
    "q12": ("l_shipmode", "high_line_count", "low_line_count"),
    "q14": ("promo_revenue", "total_revenue"),
    "q2": ("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
           "ps_supplycost", "s_suppkey"),
    "q4": ("o_orderpriority", "order_count"),
    "q5": ("n_name", "revenue"),
    "q10": ("c_custkey", "c_name", "c_acctbal", "n_name", "revenue"),
    "q15": ("s_suppkey", "s_name", "total_revenue"),
    "q16": ("p_brand", "p_type", "p_size", "supplier_cnt"),
    "q17": ("sum_price",),
    "q19": ("revenue",),
}
# the tables each phase's queries scan, generated before the clock starts
PHASE_TABLES = {6: ("customer", "orders", "lineitem"),
                7: ("part", "supplier", "partsupp", "nation", "orders",
                    "lineitem"),
                8: ("region", "nation", "supplier", "part", "partsupp",
                    "customer", "orders", "lineitem")}
# FlowRestarts of the cold run (every warm run must have none), from the
# JAX plans' start capacities against the rows SF 1 gives them:
# - Q18's first aggregate (1.5 M groups) overflows a 2^20 accumulator;
# - Q2's ShrinkOp over partsupp x European suppliers starts at 2^14 and
#   sees about 160,000 rows: one restart, to 2^18;
# - Q16's ShrinkOp over partsupp x the parts kept starts at 2^12 and sees
#   about 120,000 rows: two restarts, to 2^16 and then 2^20;
# - Q4's semi join builds on late lineitems, whose l_orderkey repeats:
#   the build flags it twice, widening unique -> unique-mat -> expand;
# every other Shrink start capacity exceeds its real row count at SF 1
COLD_RESTARTS = {"q18": 1, "q2": 1, "q16": 2, "q4": 2}
# each query's rows from its streaming runs (phases 6 to 8), which phase
# 9's fused runs must equal
STREAMING_ROWS: dict = {}


def _chunks(table):
    """The number of capacity-sized chunks a table's scan yields."""
    return lambda gen: -(-gen.num_rows(table) // CAPACITY)


# the kernels each query's path runs, with the launches one pass of its
# flow makes: the dense GROUP BY launches dense_sums once per batch that
# reaches it
PATH_KERNELS = {
    # l_shipmode: one batch per lineitem chunk
    "q12": {"dense_sums": _chunks("lineitem")},
    # o_orderpriority (D = 6): one batch per orders chunk, through the
    # semi join
    "q4": {"dense_sums": _chunks("orders")},
    # n_name (D = 26): the one 2^22-lane batch of the ShrinkOp above the
    # lineitem join
    "q5": {"dense_sums": lambda gen: 1},
}
# the cummax of the join probe (ops/sortjoin.py _run_build_broadcast), as
# the profiler names its kernel
CUMMAX_KERNEL = "scan_innermost_dim_with_indices"


def feed_pregenerated(flow, gen, capacity: int) -> int:
    """Point every ScanOp of `flow` at chunks of tables generated before
    the clock starts. Returns the number of scans fed."""
    from cockroach_tpu_torch.exec.operators import ScanOp, walk_operators

    n_scans = 0
    for op in walk_operators(flow):
        if isinstance(op, ScanOp):
            table = gen.table(op.table)
            cols = op.schema.names()
            n = gen.num_rows(op.table)
            chunks = [{c: table[c][a:a + capacity] for c in cols}
                      for a in range(0, n, capacity)]
            op._chunks = lambda chunks=chunks: iter(chunks)
            n_scans += 1
    return n_scans


def scans_of(flow) -> list:
    from cockroach_tpu_torch.exec.operators import ScanOp, walk_operators

    return [op for op in walk_operators(flow) if isinstance(op, ScanOp)]


def make_resident(flow) -> None:
    """Mark every ScanOp of the flow resident (the JAX package's bench.py
    _make_resident): its first complete pass pins its image."""
    for op in scans_of(flow):
        op.resident = True


def make_streaming(flow) -> None:
    """Turn the scan-image cache off for every ScanOp of the flow, so it
    packs and copies each run."""
    for op in scans_of(flow):
        op.cache_key = None


def image_checksums(torch, flow) -> dict:
    """{scan id: (bytes, a position-weighted int64 sum of the image)} of
    every scan of the flow that holds an image (two device reductions
    and one read each, outside any timed run)."""
    out = {}
    for op in scans_of(flow):
        st = op._stacked
        if st is None:
            continue
        words = st.bufs.reshape(-1).view(torch.int64)
        pos = torch.arange(1, words.numel() + 1, device=words.device)
        out[id(op)] = (st.bufs.numel(), int((words * pos).sum()),
                       int(words.sum()))
    return out


def check_warm_events(name: str, run: int, events: dict) -> list:
    """A warm run of a resident flow packs and copies nothing. -> the
    stacked events it shows."""
    bad = {e: events[e] for e in STREAMING_EVENTS if events.get(e)}
    if bad:
        raise SystemExit(f"{name} warm run {run}: {bad}, expected no "
                         f"scan.pack or scan.transfer")
    shown = sorted(e for e in STACKED_EVENTS if events.get(e))
    if name in MUST_FOLD_STACKED and "agg.fold_stacked" not in shown:
        raise SystemExit(f"{name} warm run {run}: no agg.fold_stacked")
    return shown


def check_launches(name, gen, launches, restarts) -> None:
    """Each kernel launched as PATH_KERNELS says, a pass per restart."""
    want_launches = PATH_KERNELS.get(name, {})
    for k, n in launches.items():
        want = want_launches[k](gen) if k in want_launches else 0
        if n != want * (1 + restarts):
            raise SystemExit(f"{name}: {k} launched {n} times in a run "
                             f"with {restarts} restarts, expected {want} "
                             f"a pass")


def query_rows(name: str, res) -> list:
    """A result's rows as tuples of Python ints, after checking that no
    column holds a NULL."""
    for col in Q_COLUMNS[name]:
        if not res[col + "__valid"].all():
            raise SystemExit(f"{name}: {col} has NULLs")
    return list(zip(*(res[c].tolist() for c in Q_COLUMNS[name])))


def query_oracle(name: str, gen) -> list:
    """The query's rows, in its ORDER BY, from its columnar oracle."""
    from cockroach_tpu_torch.workload import tpch_queries as tq

    if name == "q6":
        return [(tq.q6_oracle(gen),)]
    if name == "q3":
        return tq.q3_oracle_columnar(gen)
    if name == "q18":
        return tq.q18_oracle_columnar(gen, Q18_THRESHOLD)
    if name == "q9":
        names = list(gen.schema("nation").dicts["n_name"])
        rows = [(names.index(n), y, v)
                for (n, y), v in tq.q9_oracle_columnar(gen).items()]
        return sorted(rows, key=lambda r: (names[r[0]], -r[1]))
    if name == "q12":
        modes = gen.schema("lineitem").dicts["l_shipmode"]
        return sorted(((m, h, lo) for m, (h, lo)
                       in tq.q12_oracle_columnar(gen).items()),
                      key=lambda r: modes[r[0]])
    if name == "q14":
        return [tq.q14_oracle_columnar(gen)]
    if name == "q2":
        return tq.q2_oracle(gen)
    if name == "q4":
        return sorted(tq.q4_oracle(gen).items())
    if name == "q5":
        # ORDER BY revenue DESC, n_name (in name order)
        rank = tq.name_rank(gen, "nation", "n_name")
        return sorted(tq.q5_oracle_columnar(gen).items(),
                      key=lambda r: (-r[1], rank[r[0]]))
    if name == "q10":
        return tq.q10_oracle_columnar(gen)
    if name == "q15":
        return tq.q15_oracle_columnar(gen)
    if name == "q16":
        brand = tq.name_rank(gen, "part", "p_brand")
        ptype = tq.name_rank(gen, "part", "p_type")
        return sorted(((b, t, z, n) for (b, t, z), n
                       in tq.q16_oracle(gen).items()),
                      key=lambda r: (-r[3], brand[r[0]], ptype[r[1]], r[2]))
    if name == "q17":
        return [(tq.q17_oracle_columnar(gen),)]
    return [(tq.q19_oracle(gen),)]


def query_flows(gen) -> dict:
    """Each query's flow at SF 1, capacity 2^20, through the port's entry
    points (workload.tpch_queries -> sql.plan.build)."""
    from cockroach_tpu_torch.workload import tpch_queries as tq

    return {"q6": lambda: tq.q6(gen, CAPACITY),
            "q3": lambda: tq.q3(gen, CAPACITY),
            "q18": lambda: tq.q18(gen, Q18_THRESHOLD, CAPACITY),
            "q9": lambda: tq.q9(gen, CAPACITY),
            "q12": lambda: tq.q12(gen, CAPACITY),
            "q14": lambda: tq.q14(gen, CAPACITY),
            **{n: (lambda n=n: getattr(tq, n)(gen, CAPACITY))
               for n in PHASE8}}


def timed_collect(torch, stats, collect, flow, count_syncs: bool = False):
    """One run of the flow: (result, seconds, restarts, host stage
    seconds, host syncs or None, kernel launches, every stage's event
    count). With count_syncs,
    every synchronizing CUDA call of the run is counted
    (torch.cuda.set_sync_debug_mode). Each kernel's launch count is set
    to 0 just before the run and read just after."""
    import warnings

    from cockroach_tpu_torch.ops import cuda_kernels as ck

    for k in ck.KERNELS:
        k.launches = 0
    with stats.query_stats() as col, warnings.catch_warnings(
            record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            res = collect(flow)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launches = {k.source.stem: k.launches for k in ck.KERNELS}
    syncs = (sum("synchroniz" in str(w.message) for w in caught)
             if count_syncs else None)
    restart = col.stages.get("flow.restart")
    stages = {s: col.stages[s].seconds for s in STAGES if s in col.stages}
    events = {n: st.events for n, st in col.stages.items()}
    return (res, dt, (restart.events if restart else 0), stages, syncs,
            launches, events)


def layer_times(torch, flows, dev) -> dict:
    """Device ms (CUDA events, median of 10) of one call of each layer at
    the shapes SF 1 gives it: Q3's join build (prepare_build of the
    orders side) and probe (one lineitem batch), one partial and one fold
    step of Q18's first aggregate (1.5 M groups), and Q18's top-K."""
    from itertools import islice

    from cockroach_tpu_torch.exec.operators import (
        HashAggOp, _fold_step, _grow_to, _pow2_at_least, walk_operators,
    )
    from cockroach_tpu_torch.ops.join import (
        hash_join_prepared, prepare_build,
    )
    from cockroach_tpu_torch.ops.sort import top_k_batch

    out = {}
    join = flows["q3"].child.child
    _kind, build = join._materialize_build(dev)
    bt = prepare_build(build, join.build_on, mode="unique-mat")
    probe = next(iter(join.probe.batches(dev)))
    out["q3.join.build"] = event_ms(
        torch, lambda: prepare_build(build, join.build_on, mode="unique-mat"),
        reps=10)
    out["q3.join.probe"] = event_ms(
        torch, lambda: hash_join_prepared(probe, bt, join.probe_on,
                                          join.build_on, how="inner"),
        reps=10)
    agg = [op for op in walk_operators(flows["q18"])
           if isinstance(op, HashAggOp) and op.group_by == ["l_orderkey"]][0]
    b1, b2 = islice(agg.child.batches(dev), 2)
    p1, _ = agg._partial(b1)
    p2, _ = agg._partial(b2)
    acc_cap = _pow2_at_least(p1.capacity * agg.expansion)
    acc = _grow_to(p1, acc_cap)
    out["q18.agg.partial"] = event_ms(torch, lambda: agg._partial(b2),
                                      reps=10)
    out["q18.agg.fold_step"] = event_ms(
        torch, lambda: _fold_step(acc, p2, acc_cap, agg.group_by,
                                  agg._merge_aggs, seed=agg.seed), reps=10)
    topk = flows["q18"]
    winners = list(topk.child.batches(dev))
    out["q18.top_k"] = event_ms(
        torch, lambda: [top_k_batch(w, topk.keys, topk.k, topk.child.schema)
                        for w in winners], reps=10)
    return out


def layer_times_phase7(torch, ck, flows, dev):
    """Device ms (CUDA events, median of 10) of one call of each layer at
    the shapes SF 1 gives it: Q9's ShrinkOp (concatenation and compaction
    of the semi join's 6 x 2^20 output lanes), its composite-key join
    against partsupp (one probe batch), and Q12's dense GROUP BY of one
    batch through K1. Returns (times, the largest difference of K1 at
    Q12's shape against its plain version)."""
    from cockroach_tpu_torch.coldata.batch import concat_batches
    from cockroach_tpu_torch.exec.operators import (
        JoinOp, ShrinkOp, walk_operators,
    )
    from cockroach_tpu_torch.ops import agg as agg_ops
    from cockroach_tpu_torch.ops.join import (
        hash_join_prepared, prepare_build,
    )

    out = {}
    q9 = list(walk_operators(flows["q9"]))
    shrink = [op for op in q9 if isinstance(op, ShrinkOp)][0]
    parts = list(shrink.child.batches(dev))
    out["q9.shrink"] = event_ms(
        torch, lambda: shrink.shrink(concat_batches(parts)), reps=10)
    join = [op for op in q9 if isinstance(op, JoinOp)
            and len(op.probe_on) == 2][0]
    _kind, build = join._materialize_build(dev)
    bt = prepare_build(build, join.build_on, mode="unique-mat")
    probe = next(iter(join.probe.batches(dev)))
    out["q9.join.probe"] = event_ms(
        torch, lambda: hash_join_prepared(probe, bt, join.probe_on,
                                          join.build_on, how="inner"),
        reps=10)
    agg = flows["q12"].child
    b = next(iter(agg.child.batches(dev)))
    out["q12.agg"] = event_ms(
        torch, lambda: agg_ops.dense_aggregate(b, agg.group_by, agg.internal,
                                               agg.dense_sizes), reps=10)
    packed, values, live, d = agg_ops.dense_kernel_inputs(
        b, agg.group_by, agg.internal, agg.dense_sizes)
    worst = check_dense_case(torch, ck, "Q12's first batch", packed, values,
                             live, d, ck.smem_per_block(dev))
    return out, worst


def trace_query(torch, collect, flow, path_stem: str):
    """One traced run: (device busy ms, wall ms, the ten longest device
    ops as (name, total ms, count), the cummax kernels' total ms and
    their launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect(flow)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = path_stem + "_trace.json"
    prof.export_chrome_trace(trace)
    with open(path_stem + "_profile.txt", "w") as f:
        f.write(prof.key_averages().table(sort_by="device_time_total",
                                          row_limit=60))
    busy_ms, _n = device_busy_ms(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    per_op = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            tot, cnt = per_op.get(e["name"], (0.0, 0))
            per_op[e["name"]] = (tot + e["dur"] / 1e3, cnt + 1)
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:10]
    cummax = [(t, c) for n, (t, c) in per_op.items() if CUMMAX_KERNEL in n]
    return (busy_ms, wall_ms, [(n, t, c) for n, (t, c) in top],
            sum(t for t, _c in cummax), sum(c for _t, c in cummax))


def run_query_phase(torch, gen, phase: int, names):
    """Queries at SF 1 through the port on CUDA: every ScanOp of each
    built flow marked resident, then a cold and WARM_RUNS warm runs, every
    run equal to the query's columnar oracle, the restarts and kernel
    launches of every run held to COLD_RESTARTS and PATH_KERNELS, no warm
    run packing or copying, and the resident images' checksums the same
    after the warm runs as after the cold run. Then one fresh plan build
    from the entry point (not marked resident), which must borrow every
    image from the scan-image cache, and one streaming flow (cache off),
    a cold and a warm run. -> ({name: JSON record}, flows)."""
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

    collect = streaming_collect()
    t0 = time.perf_counter()
    for t in PHASE_TABLES[phase]:
        gen.table(t)
    builders = query_flows(gen)
    flows = {n: builders[n]() for n in names}
    oracles = {n: query_oracle(n, gen) for n in names}
    fed = {n: feed_pregenerated(flows[n], gen, CAPACITY) for n in names}
    print(f"[{phase}] {', '.join(n.upper() for n in names)} at SF {SF}, "
          f"capacity {CAPACITY}, every scan resident (datagen + columnar "
          f"oracles {time.perf_counter() - t0:.2f} s; scans fed {fed})",
          flush=True)
    torch.cuda.reset_peak_memory_stats()

    def checked_run(name, flow, label, count_syncs=False):
        out = timed_collect(torch, stats, collect, flow,
                            count_syncs=count_syncs)
        rows = query_rows(name, out[0])
        if rows != oracles[name]:
            raise SystemExit(f"{name} {label}: {rows[:3]}... differs from "
                             f"its columnar oracle {oracles[name][:3]}...")
        check_launches(name, gen, out[5], out[2])
        STREAMING_ROWS[name] = rows
        return out

    records = {}
    for name in names:
        flow = flows[name]
        make_resident(flow)
        runs, restarts, stage_runs, launch_runs, stacked = [], [], [], [], []
        for i in range(1 + WARM_RUNS):
            _res, dt, n_restarts, stages, _, launches, events = checked_run(
                name, flow, f"run {i}")
            if i == 0:
                sums = image_checksums(torch, flow)
                image_mib = sum(n for n, _a, _b in sums.values()) / 2 ** 20
            else:
                stacked.append(check_warm_events(name, i, events))
            runs.append(dt)
            restarts.append(n_restarts)
            stage_runs.append(stages)
            launch_runs.append(launches)
        _res, _dt, _r, _s, syncs, _l, ev = checked_run(
            name, flow, "sync-counted run", count_syncs=True)
        check_warm_events(name, WARM_RUNS + 1, ev)
        if image_checksums(torch, flow) != sums:
            raise SystemExit(f"{name}: a resident image changed during the "
                             f"warm runs")
        cold, warm = runs[0], runs[1:]
        warm_s = statistics.median(warm)
        want_cold = COLD_RESTARTS.get(name, 0)
        if restarts[0] != want_cold or any(restarts[1:]):
            raise SystemExit(f"{name}: restarts {restarts}, expected "
                             f"{want_cold} on the cold run and none warm")
        # a fresh plan build from the entry point borrows every image
        fresh = builders[name]()
        feed_pregenerated(fresh, gen, CAPACITY)
        _res, fresh_s, fresh_r, _s, _y, _l, ev = checked_run(
            name, fresh, "fresh plan build")
        if ev.get("scan.pack") or ev.get("scan.cache_hit", 0) < 1:
            raise SystemExit(f"{name} fresh plan build: scan.pack "
                             f"{ev.get('scan.pack')}, scan.cache_hit "
                             f"{ev.get('scan.cache_hit')}: expected every "
                             f"image borrowed")
        # the streaming path: a fresh flow with the cache off
        streaming = builders[name]()
        feed_pregenerated(streaming, gen, CAPACITY)
        make_streaming(streaming)
        stream_runs = []
        for i in range(2):
            _res, dt, _r, st, _y, _l, ev = checked_run(
                name, streaming, f"streaming run {i}")
            if not ev.get("scan.pack"):
                raise SystemExit(f"{name} streaming run {i}: no scan.pack")
            stream_runs.append((dt, st))
        print(f"  {name}: {len(oracles[name])} rows match the columnar "
              f"oracle in all {len(runs)} resident runs, the fresh plan "
              f"build and 2 streaming runs; cold {cold:.4f} s, resident "
              f"warm median {warm_s:.4f} s of {[round(w, 4) for w in warm]},"
              f" streaming warm {stream_runs[1][0]:.4f} s, fresh plan build "
              f"{fresh_s:.4f} s ({fresh_r} restarts); restarts per run "
              f"{restarts}; kernel launches per run {launch_runs[-1]}; "
              f"synchronizing CUDA calls in one warm run {syncs}; images "
              f"{image_mib:.1f} MiB in {len(sums)} scans, unchanged; warm "
              f"runs show {stacked[-1] or 'no stacked events'}", flush=True)
        for label, st in (("cold", stage_runs[0]),
                          ("last warm", stage_runs[-1]),
                          ("streaming warm", stream_runs[1][1])):
            print(f"  {name} host stages, {label} run: "
                  + ", ".join(f"{s} {st[s] * 1e3:.2f} ms" for s in STAGES
                              if s in st), flush=True)
        records[name] = {"sf": SF, "capacity": CAPACITY, "cold_s": cold,
                         "warm_s": warm_s, "warm_runs_s": warm,
                         "streaming_warm_s": stream_runs[1][0],
                         "streaming_cold_s": stream_runs[0][0],
                         "fresh_build_s": fresh_s,
                         "restarts": restarts,
                         "kernel_launches": launch_runs[-1],
                         "host_stages_warm_s": stage_runs[-1],
                         "host_stages_cold_s": stage_runs[0],
                         "host_stages_streaming_s": stream_runs[1][1],
                         "host_syncs_warm": syncs, "image_mib": image_mib,
                         "stacked_events_warm": stacked[-1]}
    peak = torch.cuda.max_memory_allocated()
    print(f"  phase {phase}: device memory peak {peak / 2 ** 20:.1f} MiB; "
          f"scan-image cache {scan_image_cache().nbytes / 2 ** 20:.1f} MiB "
          f"in {len(scan_image_cache())} images", flush=True)
    return records, flows


def budget_exhausted_run(torch, gen) -> None:
    """Q6 with storage.hbm_cache_bytes below one chunk and the cache off:
    its scan stays streaming-only (pins nothing, packs every chunk on
    both runs) and equals its oracle."""
    from cockroach_tpu_torch.exec import operators as ops
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.util.settings import HBM_CACHE_BUDGET, Settings

    collect = streaming_collect()

    flow = query_flows(gen)["q6"]()
    feed_pregenerated(flow, gen, CAPACITY)
    make_resident(flow)
    make_streaming(flow)
    (scan,) = scans_of(flow)
    want = query_oracle("q6", gen)
    settings, old_mon = Settings(), ops._hbm_cache_monitor
    old_budget = settings.get(HBM_CACHE_BUDGET)
    settings.set(HBM_CACHE_BUDGET, scan._nbytes - 1)
    ops._hbm_cache_monitor = None
    try:
        for i in range(2):
            res, dt, _r, _s, _y, _l, ev = timed_collect(
                torch, stats, collect, flow)
            if query_rows("q6", res) != want:
                raise SystemExit(f"q6 over budget, run {i}: differs from "
                                 f"its oracle")
            n_chunks = -(-gen.num_rows("lineitem") // CAPACITY)
            if ev.get("scan.pack") != n_chunks or scan._stacked is not None:
                raise SystemExit(f"q6 over budget, run {i}: scan.pack "
                                 f"{ev.get('scan.pack')} of {n_chunks}, "
                                 f"pinned {scan._stacked is not None}")
        used = ops.hbm_cache_monitor().used
    finally:
        settings.set(HBM_CACHE_BUDGET, old_budget)
        ops._hbm_cache_monitor = old_mon
    print(f"  q6 with storage.hbm_cache_bytes {scan._nbytes - 1} (below one "
          f"chunk): streaming-only, matches its oracle in 2 runs, packing "
          f"{n_chunks} chunks each, {used} bytes pinned; last run "
          f"{dt:.4f} s", flush=True)


def profile_queries(torch, records, flows, profile_dir) -> None:
    """One traced run of each query: its device busy time, the ten
    longest device ops and the join probe's cummax total."""
    collect = streaming_collect()
    for name, flow in flows.items():
        busy, wall, top, cummax, cummax_calls = trace_query(
            torch, collect, flow, os.path.join(profile_dir, name))
        records[name]["device_busy_ms"] = busy
        records[name]["traced_wall_ms"] = wall
        records[name]["cummax_ms"] = cummax
        records[name]["cummax_calls"] = cummax_calls
        print(f"  traced {name} run: device busy {busy:.3f} ms of "
              f"{wall:.3f} ms wall; cummax {cummax:.3f} ms in "
              f"{cummax_calls} calls; ten longest device ops (total ms, "
              f"count):", flush=True)
        for op, ms, cnt in top:
            print(f"    {ms:9.3f} {cnt:5d}  {op[:110]}")


def add_layers(records, layers) -> None:
    print("  layers, device ms per call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in layers.items()), flush=True)
    for name in records:
        records[name]["layers_ms"] = {k: v for k, v in layers.items()
                                      if k.startswith(name + ".")}


def run_phase6(torch, gen, dev, profile_dir):
    """Q6, Q3 and Q18 at SF 1 through the port on CUDA. -> {name: JSON
    record}."""
    records, flows = run_query_phase(torch, gen, 6, PHASE6)
    budget_exhausted_run(torch, gen)
    add_layers(records, layer_times(torch, flows, dev))
    if profile_dir:
        profile_queries(torch, records, flows, profile_dir)
    return records


def run_phase7(torch, ck, gen, dev, profile_dir):
    """Q9, Q12 and Q14 at SF 1 through the port on CUDA. -> ({name: JSON
    record}, K1's largest difference from its plain version at Q12's
    shape)."""
    records, flows = run_query_phase(torch, gen, 7, PHASE7)
    layers, worst = layer_times_phase7(torch, ck, flows, dev)
    add_layers(records, layers)
    if profile_dir:
        profile_queries(torch, records, flows, profile_dir)
    return records, worst


def layer_times_phase8(torch, ck, flows, dev, flush):
    """Device ms (CUDA events, median of 10) of one call of each new
    mechanism's layer at the shapes SF 1 gives it: Q2's decorrelated LEFT
    join (its probe against the per-part MIN), Q15's constant-key LEFT
    join (one build row, every probe lane in one run), one fold step of
    Q17's per-part GROUP BY of lineitem (200,000 groups), and Q16's
    DistinctOp (the keys-only GROUP BY of its one batch). Then K1 at Q4's
    and Q5's shapes against its plain version, bit for bit, and timed.
    -> (times, K1's largest difference, {query: K1 at its shape})."""
    from itertools import islice

    from cockroach_tpu_torch.exec.operators import (
        DistinctOp, HashAggOp, JoinOp, _fold_step, _grow_to, _pow2_at_least,
        walk_operators,
    )
    from cockroach_tpu_torch.ops import agg as agg_ops
    from cockroach_tpu_torch.ops.join import (
        hash_join_prepared, prepare_build,
    )

    out = {}
    for name in ("q2", "q15"):
        join = [op for op in walk_operators(flows[name])
                if isinstance(op, JoinOp) and op.how == "left"][0]
        _kind, build = join._materialize_build(dev)
        bt = prepare_build(build, join.build_on, mode="unique-mat")
        probe = next(iter(join.probe.batches(dev)))
        out[f"{name}.join.left"] = event_ms(
            torch, lambda: hash_join_prepared(probe, bt, join.probe_on,
                                              join.build_on, how="left"),
            reps=10)
    agg = [op for op in walk_operators(flows["q17"])
           if isinstance(op, HashAggOp) and op.group_by == ["l_partkey"]][0]
    b1, b2 = islice(agg.child.batches(dev), 2)
    p1, _ = agg._partial(b1)
    p2, _ = agg._partial(b2)
    acc_cap = _pow2_at_least(p1.capacity * agg.expansion)
    acc = _grow_to(p1, acc_cap)
    out["q17.agg.partial"] = event_ms(torch, lambda: agg._partial(b2),
                                      reps=10)
    out["q17.agg.fold_step"] = event_ms(
        torch, lambda: _fold_step(acc, p2, acc_cap, agg.group_by,
                                  agg._merge_aggs, seed=agg.seed), reps=10)
    dist = [op for op in walk_operators(flows["q16"])
            if isinstance(op, DistinctOp)][0]
    b = next(iter(dist._agg.child.batches(dev)))
    out["q16.distinct"] = event_ms(torch, lambda: dist._agg._partial(b),
                                   reps=10)
    worst, shapes = 0, {}
    smem = ck.smem_per_block(dev)
    for name in ("q4", "q5"):
        agg = [op for op in walk_operators(flows[name])
               if isinstance(op, HashAggOp) and op.dense_sizes][0]
        b = next(iter(agg.child.batches(dev)))
        packed, values, live, d = agg_ops.dense_kernel_inputs(
            b, agg.group_by, agg.internal, agg.dense_sizes)
        worst = max(worst, check_dense_case(
            torch, ck, f"{name.upper()}'s first batch", packed, values,
            live, d, smem))
        shapes[name] = measure_dense_sums(torch, ck, packed, values, live, d,
                                          flush)
        m = shapes[name]
        print(f"  dense_sums at {name.upper()}'s shape N={m['n']} "
              f"D={m['d']} K={m['k']} ({m['in_range']} lanes in range): "
              f"kernel_ms {m['ms']:.4f} (after a flush that leaves L2 "
              f"clean {m['clean_l2_ms']:.4f}), bound_ms "
              f"{m['bound_ms']:.4f} ({m['bytes']} bytes, {m['bound_by']}; "
              f"kernel at {m['bound_ms'] / m['ms']:.1%} of it), plain_ms "
              f"{m['plain_ms']:.4f}, library_ms {m['library_ms']:.4f} "
              f"(index_add_)", flush=True)
    return out, worst, shapes


def run_phase8(torch, ck, gen, dev, flush, profile_dir):
    """Q4, Q17, Q16, Q2, Q15, Q5, Q10 and Q19 at SF 1 through the port on
    CUDA. -> ({name: JSON record}, K1's largest difference from its
    plain version at Q4's and Q5's shapes, {query: K1 at its shape})."""
    records, flows = run_query_phase(torch, gen, 8, PHASE8)
    layers, worst, shapes = layer_times_phase8(torch, ck, flows, dev, flush)
    add_layers(records, layers)
    if profile_dir:
        profile_queries(torch, records, flows, profile_dir)
    return records, worst, shapes


def run_phase4(torch, gen):
    """Q1 at SF 1 through the port on CUDA, its scan resident: a cold
    run and WARM_RUNS warm runs (equal to q1_oracle, dense_sums once
    per chunk, no pack or copy when warm, the image unchanged), the
    synchronizing calls of a warm run, a streaming flow (cache off)
    with Q1_STREAMING_RUNS warm runs, and a fresh plan build that
    borrows the image. -> (flow, its JSON record, the cold run's
    kernel launches)."""
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.workload.tpch_queries import q1, q1_oracle

    collect = streaming_collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = gen.table("lineitem")
    flow = q1(gen, CAPACITY)
    (scan,) = scans_of(flow)
    cols = scan.schema.names()
    n_rows = gen.num_rows("lineitem")
    chunks = [{c: table[c][a:a + CAPACITY] for c in cols}
              for a in range(0, n_rows, CAPACITY)]
    scan._chunks = lambda: iter(chunks)  # data generation off the clock
    oracle = q1_oracle(gen)
    print(f"[4] Q1 SF {SF}: {n_rows} lineitem rows in {len(chunks)} chunks "
          f"of {CAPACITY} (datagen + oracle {time.perf_counter() - t0:.2f} s)",
          flush=True)

    # the JAX package's warm headline reads resident scans (bench.py
    # _make_resident): the cold run pins the image, warm runs fold it
    make_resident(flow)
    res, cold, _r, cold_stages, _y, launches, _e = timed_collect(
        torch, stats, collect, flow)
    rf_names = gen.schema("lineitem").dicts["l_returnflag"]
    ls_names = gen.schema("lineitem").dicts["l_linestatus"]
    check_q1(res, oracle, rf_names, ls_names)
    if launches["dense_sums"] != len(chunks):
        raise SystemExit(f"dense_sums launched {launches['dense_sums']} "
                         f"times on the main path, expected {len(chunks)}")
    sums = image_checksums(torch, flow)

    def same_as_cold(label, again):
        for c in res:
            if not np.array_equal(np.asarray(again[c]), np.asarray(res[c])):
                raise SystemExit(f"Q1 {label} differs in {c}")

    warm, warm_launches = [], []
    for i in range(WARM_RUNS):
        again, dt, _r, warm_stages, _y, wl, ev = timed_collect(
            torch, stats, collect, flow)
        same_as_cold(f"warm run {i}", again)
        shown = check_warm_events("q1", i + 1, ev)
        warm.append(dt)
        warm_launches.append(wl["dense_sums"])
    if any(n != len(chunks) for n in warm_launches):
        raise SystemExit(f"dense_sums launched {warm_launches} times in the "
                         f"warm runs, expected {len(chunks)} each")
    if image_checksums(torch, flow) != sums:
        raise SystemExit("Q1's resident image changed during the warm runs")
    warm_s = statistics.median(warm)
    _res, _dt, _r, _s, q1_syncs, _l, _e = timed_collect(
        torch, stats, collect, flow, count_syncs=True)
    # the streaming path: a second flow with its cache key off, 1 cold
    # and Q1_STREAMING_RUNS warm runs
    streaming = q1(gen, CAPACITY)
    make_streaming(streaming)
    (s_scan,) = scans_of(streaming)
    s_scan._chunks = lambda: iter(chunks)
    stream_warm = []
    for i in range(1 + Q1_STREAMING_RUNS):
        again, dt, _r, stream_stages, _y, _l, ev = timed_collect(
            torch, stats, collect, streaming)
        same_as_cold(f"streaming run {i}", again)
        if ev.get("scan.pack") != len(chunks):
            raise SystemExit(f"Q1 streaming run {i}: scan.pack "
                             f"{ev.get('scan.pack')}")
        if i:
            stream_warm.append(dt)
    stream_s = statistics.median(stream_warm)
    # a fresh plan build from the entry point borrows the image
    fresh = q1(gen, CAPACITY)
    (f_scan,) = scans_of(fresh)
    f_scan._chunks = lambda: iter(chunks)
    again, fresh_s, _r, _s, _y, _l, ev = timed_collect(torch, stats,
                                                       collect, fresh)
    same_as_cold("fresh plan build", again)
    if ev.get("scan.pack") or ev.get("scan.cache_hit", 0) < 1:
        raise SystemExit(f"Q1 fresh plan build: {ev}")
    print(f"  result matches q1_oracle: {len(res['count_order'])} groups, "
          f"launches {launches}", flush=True)
    print(f"  cold {cold:.4f} s; resident warm median {warm_s:.4f} s of "
          f"{[round(w, 4) for w in warm]} ({n_rows / warm_s:,.0f} rows/s); "
          f"streaming warm median {stream_s:.4f} s of "
          f"{[round(w, 4) for w in stream_warm]}; fresh plan build "
          f"{fresh_s:.4f} s (borrows the image); warm runs show {shown}; "
          f"synchronizing CUDA calls in one warm run {q1_syncs}; image "
          f"{sum(n for n, _a, _b in sums.values()) / 2 ** 20:.1f} MiB, "
          f"unchanged; device memory peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB",
          flush=True)
    for label, st in (("cold", cold_stages), ("last warm", warm_stages),
                      ("streaming warm", stream_stages)):
        print(f"  q1 host stages, {label} run: "
              + ", ".join(f"{x} {st[x] * 1e3:.2f} ms" for x in STAGES
                          if x in st), flush=True)
    record = {"sf": SF, "capacity": CAPACITY, "cold_s": cold,
              "warm_s": warm_s, "warm_runs_s": warm,
              "streaming_warm_s": stream_s,
              "streaming_warm_runs_s": stream_warm,
              "fresh_build_s": fresh_s, "host_syncs_warm": q1_syncs,
              "host_stages_cold_s": cold_stages,
              "host_stages_warm_s": warm_stages,
              "host_stages_streaming_s": stream_stages}
    return flow, record, launches, res


# ------------------------------------------------------------ phase 9

PHASE9 = ("q1",) + PHASE6 + PHASE7 + PHASE8
# FlowRestarts of each query's fused cold run at SF 1 (every warm run
# must have none): Q2's and Q16's ShrinkOps and Q4's semi join restart
# as on the streaming tier (COLD_RESTARTS; Q4's semi join steps from the
# payload carry to unique-mat to expand); Q18's first aggregate takes
# the int-key route, whose run-ends view cannot overflow; Q16's result
# (about 18,000 rows) passes the first 8,192-row packed window, which
# widens once
COLD_RESTARTS_FUSED = {"q2": 1, "q16": 3, "q4": 2}
# K1 launches of one fused warm run (one replay), from the tracer's
# routes at SF 1: the dense GROUP BYs of Q1, Q4, Q5 and Q12 aggregate
# their materialized input in one call (its rows x bytes fit the JAX
# tracer's 512 MiB workmem rule); no other query takes the dense route.
# Phase 9 counts them in a profiler trace of a replay
FUSED_K1 = {"q1": 1, "q4": 1, "q5": 1, "q12": 1}
# the aggregate routes the fused tracer takes at SF 1, by query (the JAX
# tracer's at SF 0.01: the group-join collapse in Q3 and Q18, the
# int-key GROUP BY in Q15, Q17 and Q18)
FUSED_ROUTES = {
    "q1": {"dense": 1}, "q6": {"fold": 1}, "q3": {"groupjoin": 1},
    "q18": {"int_key": 1, "groupjoin": 1}, "q9": {"mat": 1},
    "q12": {"dense": 1}, "q14": {"fold": 1}, "q4": {"dense": 1},
    "q17": {"int_key": 1, "mat": 1}, "q16": {"mat": 2}, "q2": {"mat": 1},
    "q15": {"int_key": 1, "mat": 1}, "q5": {"dense": 1},
    "q10": {"mat": 1}, "q19": {"fold": 1}}
# the events of a run that left the fused tier
LEFT_FUSED = ("fused.fallback_", "resilience.")


def streaming_collect():
    """exec.collect on the streaming tier (phases 4 and 6 to 8)."""
    import functools

    from cockroach_tpu_torch.exec.operators import collect

    return functools.partial(collect, fuse=False)


def fused_run(torch, flow, stages=None):
    """One run of the flow through exec.collect with its default (fused)
    tier: (result, seconds, restarts, synchronizing calls inside collect,
    kernel launches, every stage's event count, what the runner did). The
    launch counts are set to 0 just before the run and read just
    after. A `stages` dict receives {stage: (events, seconds, bytes)}."""
    import warnings

    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.exec.operators import collect
    from cockroach_tpu_torch.ops import cuda_kernels as ck

    for k in ck.KERNELS:
        k.launches = 0
    with stats.query_stats() as col, warnings.catch_warnings(
            record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            res = collect(flow)
            dt = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {k.source.stem: k.launches for k in ck.KERNELS}
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    events = {n: st.events for n, st in col.stages.items()}
    if stages is not None:
        stages.update({n: (st.events, st.seconds, st.bytes)
                       for n, st in col.stages.items()})
    runner = getattr(flow, "_fused_runner", None)
    last = dict(runner.last) if runner is not None else {}
    return (res, dt, events.get("flow.restart", 0), syncs, launches, events,
            last)


def left_fused(name, label, events, last) -> None:
    """Fail unless the run stayed on the fused tier. The one exception is
    the JAX tracer's own workmem rule, whose reason is printed."""
    bad = {e: n for e, n in events.items()
           if any(e.startswith(p) for p in LEFT_FUSED)}
    if not bad:
        return
    why = last.get("unsupported", "")
    if set(bad) == {"fused.fallback_unsupported"} and "workmem" in why:
        print(f"  {name} {label}: streaming by the JAX tracer's workmem "
              f"rule ({why})", flush=True)
        return
    raise SystemExit(f"{name} {label}: left the fused tier: {bad} {last}")


def kernel_events(trace_path: str, needle: str) -> int:
    """The device kernels in a torch.profiler chrome trace whose name
    holds `needle`."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and needle in e.get("name", ""))


class carry_joins:
    """Within the block, the build keys of every unique build that takes
    the payload carry (ops/sortjoin.py prepare_unique) go into `out`."""

    def __init__(self, out: list):
        self.out = out

    def __enter__(self):
        from cockroach_tpu_torch.ops import sortjoin

        self.orig = sortjoin.prepare_unique

        def counting(*args, **kwargs):
            ub = self.orig(*args, **kwargs)
            if ub.payv is not None:
                self.out.append("+".join(ub.build_on))
            return ub

        sortjoin.prepare_unique = counting
        return self

    def __exit__(self, *exc):
        from cockroach_tpu_torch.ops import sortjoin

        sortjoin.prepare_unique = self.orig


def run_phase9(torch, gen, q1_streaming, profile_dir):
    """The fifteen queries at SF 1, capacity 2^20, every scan resident,
    through exec.collect's default, the fused tier: per query a cold run
    (its images borrowed from the scan-image cache, the eager warm-up and
    the capture) and WARM_RUNS warm runs, each equal to the oracle and to
    the streaming result of phases 4 to 8, none leaving the fused tier;
    every warm run one graph replay with at most one synchronizing call,
    no restart and every image unchanged; one more, traced, replay runs
    FUSED_K1 dense_sums kernels. -> ({name: JSON record}, flows)."""
    from cockroach_tpu_torch.workload import tpch_queries as tq

    builders = dict(query_flows(gen), q1=lambda: tq.q1(gen, CAPACITY))
    print(f"[9] the fifteen queries through the fused tier "
          f"(collect(flow)): SF {SF}, capacity {CAPACITY}, every scan "
          f"resident, each query one CUDA graph", flush=True)
    rf_names = gen.schema("lineitem").dicts["l_returnflag"]
    ls_names = gen.schema("lineitem").dicts["l_linestatus"]
    q1_oracle = tq.q1_oracle(gen)
    oracles = {n: query_oracle(n, gen) for n in PHASE9 if n != "q1"}

    def check(name, label, res):
        if name == "q1":
            check_q1(res, q1_oracle, rf_names, ls_names)
            for c in q1_streaming:
                if not np.array_equal(np.asarray(res[c]),
                                      np.asarray(q1_streaming[c])):
                    raise SystemExit(f"q1 fused {label} differs from the "
                                     f"streaming result in {c}")
            return
        rows = query_rows(name, res)
        if rows != oracles[name] or rows != STREAMING_ROWS[name]:
            raise SystemExit(f"{name} fused {label}: {rows[:3]}... differs "
                             f"from its oracle or its streaming result")

    trace_dir = profile_dir or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "phase9_traces")
    os.makedirs(trace_dir, exist_ok=True)
    records, flows = {}, {}
    total_pool = 0
    for name in PHASE9:
        flow = builders[name]()
        feed_pregenerated(flow, gen, CAPACITY)
        make_resident(flow)
        flows[name] = flow
        carried = []
        with carry_joins(carried):
            res, cold, cold_r, _y, cold_l, ev, last = fused_run(torch, flow)
        check(name, "cold run", res)
        left_fused(name, "cold run", ev, last)
        if last.get("mode") != "capture":
            raise SystemExit(f"{name} fused cold run: {last}, expected a "
                             f"capture")
        sums = image_checksums(torch, flow)
        routes, pool_mib = last["routes"], last["pool_bytes"] / 2 ** 20
        capture_ms = last["capture_s"] * 1e3
        total_pool += last["pool_bytes"]
        if routes != FUSED_ROUTES[name]:
            raise SystemExit(f"{name}: fused routes {routes}, expected "
                             f"{FUSED_ROUTES[name]}")
        warm, syncs, launch_runs = [], [], []
        restarts = [cold_r]
        for i in range(WARM_RUNS):
            res, dt, n_r, n_sync, launches, ev, last = fused_run(torch, flow)
            check(name, f"warm run {i + 1}", res)
            left_fused(name, f"warm run {i + 1}", ev, last)
            if (last.get("mode") != "replay" or ev.get("fused.replay") != 1
                    or ev.get("fused.capture") or ev.get("fused.prime")):
                raise SystemExit(f"{name} fused warm run {i + 1}: {last}, "
                                 f"{ev}: expected exactly one replay")
            if n_sync > 1:
                raise SystemExit(f"{name} fused warm run {i + 1}: {n_sync} "
                                 f"synchronizing calls, expected <= 1")
            warm.append(dt)
            syncs.append(n_sync)
            restarts.append(n_r)
            launch_runs.append(launches)
        if image_checksums(torch, flow) != sums:
            raise SystemExit(f"{name}: a resident image changed during the "
                             f"fused warm runs")
        want_cold = COLD_RESTARTS_FUSED.get(name, 0)
        if restarts[0] != want_cold or any(restarts[1:]):
            raise SystemExit(f"{name}: fused restarts {restarts}, expected "
                             f"{want_cold} on the cold run and none warm")
        # what a replay really runs: the kernels of a traced warm run
        stem = os.path.join(trace_dir, name + "_fused")
        busy, wall, top, cummax, cummax_calls = trace_query(
            torch, _fused_collect(), flow, stem)
        last = flow._fused_runner.last
        if last.get("mode") != "replay":
            raise SystemExit(f"{name} fused traced run: {last}, expected a "
                             f"replay")
        want_k1 = FUSED_K1.get(name, 0)
        k1_traced = kernel_events(stem + "_trace.json", DS_KERNEL)
        n_kernels = kernel_events(stem + "_trace.json", "")
        counted = {run.get("dense_sums", 0) for run in launch_runs}
        if k1_traced != want_k1 or counted != {want_k1}:
            raise SystemExit(f"{name}: a traced replay ran {k1_traced} "
                             f"dense_sums kernels, the launch counts of the "
                             f"warm runs say {launch_runs}; expected "
                             f"{want_k1} (route {routes})")
        warm_s = statistics.median(warm)
        print(f"  {name}: fused warm median {warm_s * 1e3:.3f} ms of "
              f"{[round(w * 1e3, 3) for w in warm]} ms; cold "
              f"{cold * 1e3:.1f} ms (capture {capture_ms:.1f} ms); "
              f"restarts per run {restarts}; synchronizing calls per warm "
              f"run {syncs}; graph pool {pool_mib:.1f} MiB; routes "
              f"{routes}; dense_sums kernels in a traced replay "
              f"{k1_traced} of {n_kernels} kernels, counted per warm run "
              f"{launch_runs[-1]} (cold {cold_l}); joins that took the "
              f"payload carry (build keys) {sorted(set(carried))}",
              flush=True)
        print(f"  traced fused {name} replay: device busy {busy:.3f} ms of "
              f"{wall:.3f} ms wall; cummax {cummax:.3f} ms in "
              f"{cummax_calls} calls; three longest device ops (total ms, "
              f"count):", flush=True)
        for op, ms, cnt in top[:3]:
            print(f"    {ms:9.3f} {cnt:5d}  {op[:110]}")
        records[name] = {"sf": SF, "capacity": CAPACITY, "fused_cold_s": cold,
                         "fused_warm_s": warm_s, "fused_warm_runs_s": warm,
                         "fused_capture_ms": capture_ms,
                         "fused_restarts": restarts,
                         "fused_syncs_warm": syncs,
                         "fused_graph_pool_mib": pool_mib,
                         "fused_routes": routes,
                         "fused_kernel_launches": launch_runs[-1],
                         "fused_k1_traced": k1_traced,
                         "fused_replay_kernels": n_kernels,
                         "fused_device_busy_ms": busy,
                         "fused_traced_wall_ms": wall,
                         "fused_cummax_ms": cummax,
                         "fused_cummax_calls": cummax_calls,
                         "fused_carry_joins": sorted(set(carried))}
    # every graph shares one memory pool: replay each once more, after
    # every other capture, and hold it to its oracle again
    for name, flow in flows.items():
        res, _dt, n_r, _y, _l, ev, last = fused_run(torch, flow)
        check(name, "replay after every capture", res)
        if last.get("mode") != "replay" or n_r:
            raise SystemExit(f"{name}: {last}, {n_r} restarts on the replay "
                             f"after every capture")
    print(f"  phase 9: every query's graph replayed again after every "
          f"capture, equal to its oracle; graph pools grew "
          f"{total_pool / 2 ** 20:.1f} MiB in all (one pool, shared); "
          f"device memory reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB", flush=True)
    return records, flows


def _fused_collect():
    from cockroach_tpu_torch.exec.operators import collect

    return collect


def fused_dense_shapes(torch, ck, flows, flush):
    """K1 at the shapes of the fused queries' dense GROUP BYs: one call
    over each one's materialized input (the fused Q1's is lineitem's
    6 x 2^20 lanes), held bit for bit against its plain version and
    timed. -> ({label: shape}, K1's largest difference from its plain
    version)."""
    from cockroach_tpu_torch.exec import fused
    from cockroach_tpu_torch.exec.operators import HashAggOp, walk_operators
    from cockroach_tpu_torch.ops import agg as agg_ops

    dev = torch.device("cuda")
    out, worst = {}, 0
    smem = ck.smem_per_block(dev)
    for name in FUSED_K1:
        flow = flows[name]
        aggs = [op for op in walk_operators(flow)
                if isinstance(op, HashAggOp) and op.dense_sizes is not None]
        if len(aggs) != FUSED_K1[name]:
            raise SystemExit(f"{name}: {len(aggs)} dense GROUP BYs, "
                             f"expected {FUSED_K1[name]}")
        images, _vkey = flow._fused_runner._prepare(dev)
        agg = aggs[0]
        m = fused._Tracer(images)._mat(agg.child)
        packed, values, live, d = agg_ops.dense_kernel_inputs(
            m, agg.group_by, agg.internal, agg.dense_sizes)
        if len(values) > ck.MAX_COLS:
            raise SystemExit(f"{name}: {len(values)} dense columns launch "
                             f"more than one kernel a call")
        label = name + "_fused"
        worst = max(worst, check_dense_case(torch, ck, label, packed,
                                            values, live, d, smem))
        shape = measure_dense_sums(torch, ck, packed, values, live, d, flush)
        out[label] = shape
        print(f"  dense_sums at {label}'s shape N={shape['n']} D={d} "
              f"K={shape['k']}: kernel_ms {shape['ms']:.4f}, bound_ms "
              f"{shape['bound_ms']:.4f} ({shape['bound_by']}; kernel at "
              f"{shape['bound_ms'] / shape['ms']:.1%} of it), plain_ms "
              f"{shape['plain_ms']:.4f}, library_ms "
              f"{shape['library_ms']:.4f} (index_add_)", flush=True)
    return out, worst


# ----------------------------------------------------------- phase 10

# the per-operator budgets of phase 10's runs (the spill rung's default,
# sql.resilience.spill_workmem_bytes, is 32 MiB)
MIB = 1 << 20
# the stages each budgeted run must show, at least this many times, from
# the plans' row widths (exec/spill.py estimate_row_bytes) against the
# budget: Q18's final 5-key GROUP BY holds 40 B a row (2^20 x 40 B past
# 32 MiB), its first 16 B, the customer build 12 B; Q9's partsupp build
# holds 24 B, its orders build 12 B. At 4 MiB Q18's first GROUP BY and
# two joins spill; its final GROUP BY then reads the grace join's
# replayed batches of 2^16 lanes (the replay capacity fits the join's
# budget), whose 2.5 MiB accumulator fits, as in the JAX package
SPILL_RUNS = {
    "q18_32mib": ("q18", 32 * MIB, {"agg.grace_spill": 1}),
    "q18_4mib": ("q18", 4 * MIB, {"agg.grace_spill": 1,
                                  "join.grace_spill": 2}),
    "q9_8mib": ("q9", 8 * MIB, {"join.grace_spill": 1}),
}
SPILL_RUN_STAGES = ("agg.grace_spill", "join.grace_spill",
                    "agg.grace_partition_retry", "sort.external_spill",
                    "sort.device_run", "sort.host_merge", "flow.restart")
# host timers of the out-of-core paths (exec/spill.py, SortOp)
SPILL_TIMERS = ("spill.partition", "sort.device_run", "sort.host_merge",
                "spill.replay")
RANGE_DENSE_PAIRS = 10


def set_workmem(flow, workmem: int) -> None:
    """Every operator of the flow at `workmem` bytes."""
    from cockroach_tpu_torch.exec.operators import walk_operators

    for op in walk_operators(flow):
        if hasattr(op, "workmem"):
            op.workmem = workmem


def spill_clean(label: str) -> None:
    """After a run: the host-spill monitor back at 0, no spill file
    left."""
    import glob

    from cockroach_tpu_torch.exec import spill

    used = spill.host_spill_monitor().used
    left = glob.glob(os.path.join(spill._spill_dir(), "part-*.bin"))
    if used or left:
        raise SystemExit(f"{label}: host-spill monitor at {used} bytes, "
                         f"spill files left {left}")


def spill_run(torch, flow, collect, label: str):
    """One run with the device memory peak measured from the allocation
    it starts at: (result, seconds, peak MiB, stats stages)."""
    from cockroach_tpu_torch.exec import stats

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with stats.query_stats() as col:
        t0 = time.perf_counter()
        res = collect(flow)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / MIB
    spill_clean(label)
    return res, dt, peak, dict(col.stages)


def spill_line(stages) -> dict:
    """The spill numbers of one run's stats."""
    def get(name, field):
        st = stages.get(name)
        return getattr(st, field) if st else 0

    return {"events": {s: get(s, "events") for s in SPILL_RUN_STAGES
                       if get(s, "events")},
            "spill_write_rows": get("spill.write", "rows"),
            "spill_write_bytes": get("spill.write", "bytes"),
            "spill_replay_rows": get("spill.replay", "rows"),
            "spill_replay_bytes": get("spill.replay", "bytes"),
            "host_ms": {s: get(s, "seconds") * 1e3 for s in SPILL_TIMERS}}


def run_phase10(torch, gen):
    """The out-of-core paths at SF 1, capacity 2^20, data generated off
    the clock, streaming flows (no resident image, the scan-image cache
    off): (a)-(c) Q18 and Q9 under per-operator budgets, a cold run and 2
    more each, beside the same query's unbounded run; (d) an external
    sort of lineitem; (e) the spill rung; (f) the ladder with fusion on;
    (g) the range-dense GROUP BY, merge_join and a checked build. Every
    run equals its oracle and its rows from phases 6-7, and leaves no
    spilled byte or file. -> {label: JSON record}."""
    from cockroach_tpu_torch.exec import operators as ops
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

    print(f"[10] out of core: SF {SF}, capacity {CAPACITY}, streaming "
          f"flows, budgets per operator", flush=True)
    scan_image_cache().clear()
    t_phase = time.perf_counter()
    collect = streaming_collect()
    builders = query_flows(gen)
    oracles = {n: query_oracle(n, gen) for n in ("q18", "q9", "q3")}
    records = {}

    def fresh(name):
        flow = builders[name]()
        feed_pregenerated(flow, gen, CAPACITY)
        make_streaming(flow)
        return flow

    def check(name, label, res):
        rows = query_rows(name, res)
        if rows != oracles[name] or rows != STREAMING_ROWS[name]:
            raise SystemExit(f"{label}: {rows[:3]}... differs from the "
                             f"oracle or the phase 6-7 rows")

    # the unbounded reference of each query: the same streaming path at
    # the default workmem
    unbounded = {}
    for name in ("q18", "q9"):
        res, dt, peak, _st = spill_run(torch, fresh(name), collect,
                                       f"{name} unbounded")
        check(name, f"{name} unbounded", res)
        unbounded[name] = (dt, peak)
        print(f"  {name} unbounded (workmem 512 MiB): {dt:.3f} s, device "
              f"memory peak {peak:.1f} MiB", flush=True)

    # (a)-(c): the budgeted runs
    for label, (name, workmem, want) in SPILL_RUNS.items():
        runs = []
        for i in range(3):
            flow = fresh(name)
            set_workmem(flow, workmem)
            res, dt, peak, st = spill_run(torch, flow, collect, label)
            check(name, f"{label} run {i}", res)
            line = spill_line(st)
            short = {k: n for k, n in want.items()
                     if line["events"].get(k, 0) < n}
            if short:
                raise SystemExit(f"{label} run {i}: events "
                                 f"{line['events']}, expected at least "
                                 f"{want}")
            runs.append(dict(line, wall_s=dt, peak_mib=peak))
            print(f"  {label} run {i}: {dt:.3f} s; events "
                  f"{line['events']}; spill written {line['spill_write_rows']}"
                  f" rows {line['spill_write_bytes'] / MIB:.1f} MiB, "
                  f"replayed {line['spill_replay_rows']} rows "
                  f"{line['spill_replay_bytes'] / MIB:.1f} MiB; host ms "
                  + ", ".join(f"{k} {v:.1f}" for k, v
                              in line["host_ms"].items())
                  + f"; device memory peak {peak:.1f} MiB (unbounded "
                  f"{unbounded[name][1]:.1f} MiB)", flush=True)
        records[label] = {"query": name, "workmem": workmem, "runs": runs,
                          "unbounded_s": unbounded[name][0],
                          "unbounded_peak_mib": unbounded[name][1]}

    # the read-ahead of the grace join's build replay, on and off in
    # alternating pairs over Q9 at 8 MiB
    paired = {"on": [], "off": []}
    real_read_ahead = ops._read_ahead
    for i in range(2):
        for arm in (("on", "off") if i % 2 == 0 else ("off", "on")):
            ops._read_ahead = (real_read_ahead if arm == "on"
                               else (lambda it, depth=2: it))
            try:
                flow = fresh("q9")
                set_workmem(flow, 8 * MIB)
                res, dt, _p, _st = spill_run(torch, flow, collect,
                                             f"q9 read-ahead {arm}")
            finally:
                ops._read_ahead = real_read_ahead
            check("q9", f"q9 read-ahead {arm}", res)
            paired[arm].append(dt)
    print(f"  q9 at 8 MiB, the build replay's read-ahead on / off in "
          f"pairs: on {[round(t, 3) for t in paired['on']]} s, off "
          f"{[round(t, 3) for t in paired['off']]} s", flush=True)
    records["read_ahead_q9_8mib"] = paired

    records["sort_32mib"] = external_sort_run(torch, gen, collect)
    records["spill_rung"] = spill_rung_run(torch, gen, fresh, check)
    records["fused_ladder"] = fused_ladder_run(torch, fresh, check)
    records["routes"] = leftover_routes(torch, gen, fresh, check)
    print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records


def external_sort_run(torch, gen, collect) -> dict:
    """(d) ORDER BY l_shipdate, l_orderkey DESC, l_linenumber over every
    lineitem row, l_quantity carried, at 32 MiB: equal to numpy's stable
    lexsort of the same columns."""
    from cockroach_tpu_torch.exec.operators import ScanOp, SortOp
    from cockroach_tpu_torch.ops.sort import SortKey

    cols = ("l_shipdate", "l_orderkey", "l_linenumber", "l_quantity")
    table = gen.table("lineitem")
    n = gen.num_rows("lineitem")
    chunks = [{c: table[c][a:a + CAPACITY] for c in cols}
              for a in range(0, n, CAPACITY)]
    schema = gen.schema("lineitem").project(list(cols))
    order = np.lexsort((table["l_linenumber"], -table["l_orderkey"],
                        table["l_shipdate"]))
    sort = SortOp(ScanOp(schema, lambda: iter(chunks), CAPACITY),
                  [SortKey("l_shipdate"),
                   SortKey("l_orderkey", descending=True),
                   SortKey("l_linenumber")], workmem=32 * MIB)
    res, dt, peak, st = spill_run(torch, sort, collect, "external sort")
    for c in cols:
        if not np.array_equal(np.asarray(res[c]), table[c][order]):
            raise SystemExit(f"external sort: {c} differs from numpy's "
                             f"stable lexsort")
    line = spill_line(st)
    ev = line["events"]
    if (ev.get("sort.external_spill") != 1 or ev.get("sort.device_run", 0) < 2
            or ev.get("sort.host_merge") != 1):
        raise SystemExit(f"external sort: events {ev}, expected one "
                         f"external spill, at least 2 device runs, one "
                         f"host merge")
    print(f"  (d) external sort of {n} lineitem rows at 32 MiB: {dt:.3f} s, "
          f"equal to numpy's stable lexsort; events {ev}; spill written "
          f"{line['spill_write_rows']} rows "
          f"{line['spill_write_bytes'] / MIB:.1f} MiB, replayed "
          f"{line['spill_replay_rows']} rows; host ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in line["host_ms"].items())
          + f"; device memory peak {peak:.1f} MiB", flush=True)
    return dict(line, wall_s=dt, peak_mib=peak, rows=n)


def spill_rung_run(torch, gen, fresh, check) -> dict:
    """(e) Q3 whose streaming tier runs out of device memory until the
    spill rung clamps its workmem: the ladder degrades, the result equals
    the oracle, and every workmem is restored."""
    from cockroach_tpu_torch.exec import operators as ops
    from cockroach_tpu_torch.util import circuit

    class OomUntilClamped(ops.Operator):
        def __init__(self, inner):
            self.child = inner
            self.schema = inner.schema
            self.workmem = 1 << 30

        def batches(self, device):
            if self.workmem > 64 * MIB:
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory (the streaming tier, stubbed)")
            yield from self.child.batches(device)

    circuit.reset_all()
    op = OomUntilClamped(fresh("q3"))
    before = {id(o): o.workmem for o in ops.walk_operators(op)
              if hasattr(o, "workmem")}
    try:
        res, dt, peak, st = spill_run(
            torch, op, lambda f: ops.collect(f, fuse=False), "spill rung")
    finally:
        circuit.reset_all()
    check("q3", "spill rung", res)
    after = {id(o): o.workmem for o in ops.walk_operators(op)
             if hasattr(o, "workmem")}
    if "resilience.degrade.streaming" not in st or after != before:
        raise SystemExit(f"spill rung: stages {sorted(st)}, workmem "
                         f"restored {after == before}")
    line = spill_line(st)
    print(f"  (e) Q3 through the spill rung: resilience.degrade.streaming "
          f"{st['resilience.degrade.streaming'].events}, {dt:.3f} s, equal "
          f"to the oracle, every workmem restored; events {line['events']}"
          f"; device memory peak {peak:.1f} MiB", flush=True)
    return dict(line, wall_s=dt, peak_mib=peak)


def fused_ladder_run(torch, fresh, check) -> dict:
    """(f) Q18 at 32 MiB through collect(flow): the fused tracer declines
    on its workmem rule and the streaming operators complete through the
    grace paths."""
    from cockroach_tpu_torch.exec.operators import collect

    flow = fresh("q18")
    set_workmem(flow, 32 * MIB)
    res, dt, peak, st = spill_run(torch, flow, collect, "fused ladder")
    check("q18", "fused ladder", res)
    fallback = {k: v.events for k, v in st.items()
                if k.startswith("fused.fallback_")}
    why = flow._fused_runner.last.get("unsupported", "")
    line = spill_line(st)
    if "workmem" not in why or not line["events"].get("agg.grace_spill"):
        raise SystemExit(f"fused ladder: {fallback} ({why}), events "
                         f"{line['events']}")
    print(f"  (f) Q18 at 32 MiB through collect(flow): {fallback} "
          f"({why}); events {line['events']}; {dt:.3f} s, equal to the "
          f"oracle", flush=True)
    return dict(line, wall_s=dt, peak_mib=peak, fallback=fallback,
                unsupported=why)


def leftover_routes(torch, gen, fresh, check) -> dict:
    """(g) the range-dense GROUP BY against the sort route (Q17's
    per-part GROUP BY, whose span the constructor admits, and Q18's first
    GROUP BY, whose 6,000,000 it does not), timed in alternating pairs;
    merge_join at Q3's orders x lineitem join against hash_join; Q3 built
    with sql.tpu.invariants on."""
    from cockroach_tpu_torch.exec.invariants import INVARIANTS
    from cockroach_tpu_torch.exec.operators import (
        HashAggOp, ScanOp, collect,
    )
    from cockroach_tpu_torch.ops.agg import AggSpec
    from cockroach_tpu_torch.ops.join import hash_join, merge_join
    from cockroach_tpu_torch.util.settings import Settings

    out = {}
    dev = torch.device("cuda")
    table = gen.table("lineitem")
    n = gen.num_rows("lineitem")
    for label, key, aggs, (lo, hi) in (
            ("q17_partkey", "l_partkey", [AggSpec("avg", "l_quantity", "a")],
             (1, int(table["l_partkey"].max()))),
            ("q18_orderkey", "l_orderkey",
             [AggSpec("sum", "l_quantity", "s")], (1, 6000000))):
        cols = (key, "l_quantity")
        schema = gen.schema("lineitem").project(list(cols))
        chunks = [{c: table[c][a:a + CAPACITY] for c in cols}
                  for a in range(0, n, CAPACITY)]
        scan = ScanOp(schema, lambda chunks=chunks: iter(chunks), CAPACITY,
                      resident=True)
        rd = HashAggOp(scan, [key], aggs, dense_range=(lo, hi))
        admitted = rd._range_dense is not None
        if not admitted:
            # the JAX constructor's rule (span <= 2^22) declines it: force
            # the route to measure it at this shape
            rd._range_dense = (lo, hi - lo + 1)
        srt = HashAggOp(scan, [key], aggs, expansion=2)

        def run(op):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = list(op.batches(dev))[0]
            torch.cuda.synchronize()
            return b, time.perf_counter() - t0

        run(srt)  # pins the scan's image: both arms read it
        results = {}
        for arm, op in (("range_dense", rd), ("sort", srt)):
            b, _ = run(op)
            live = b.sel.cpu().numpy()
            got = {c: b.col(c).values.cpu().numpy()[live]
                   for c in b.columns}
            o = np.argsort(got[key], kind="stable")
            results[arm] = {c: v[o] for c, v in got.items()}
        for c in results["sort"]:
            a, s = results["range_dense"][c], results["sort"][c]
            same = (np.array_equal(a, s) if a.dtype.kind != "f"
                    else np.allclose(a, s, rtol=1e-6, atol=0))
            if not same:
                raise SystemExit(f"range dense {label}: {c} differs from "
                                 f"the sort route")
        times = {"range_dense": [], "sort": []}
        for i in range(RANGE_DENSE_PAIRS):
            arms = (("range_dense", rd), ("sort", srt))
            for arm, op in (arms if i % 2 == 0 else arms[::-1]):
                times[arm].append(run(op)[1])
        med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
        how = "admitted" if admitted else "forced past the 2^22 span rule"
        print(f"  (g) range-dense GROUP BY {key} span {hi - lo + 1} "
              f"({how}): {len(results['sort'][key])} groups equal to the sort "
              f"route (float32 avg within 1e-6 relative); {RANGE_DENSE_PAIRS}"
              f" pairs, median ms range-dense {med['range_dense']:.2f}, sort "
              f"{med['sort']:.2f}", flush=True)
        out[label] = {"span": hi - lo + 1, "admitted": admitted,
                      "groups": len(results["sort"][key]),
                      "range_dense_ms": times["range_dense"],
                      "sort_ms": times["sort"]}
        scan.evict()

    # merge_join at Q3's orders x lineitem join: one lineitem chunk
    # probing every order, sorted on o_orderkey
    from cockroach_tpu_torch.coldata.carry import batch_from_arrays

    orders = gen.table("orders")
    o = np.argsort(orders["o_orderkey"], kind="stable")
    build = batch_from_arrays(
        {"o_orderkey": (orders["o_orderkey"][o], None),
         "o_orderdate": (orders["o_orderdate"][o], None)},
        np.ones(len(o), bool), len(o), dev)
    probe = batch_from_arrays(
        {"l_orderkey": (table["l_orderkey"][:CAPACITY], None),
         "l_extendedprice": (table["l_extendedprice"][:CAPACITY], None)},
        np.ones(min(CAPACITY, n), bool), min(CAPACITY, n), dev)
    mj = merge_join(probe, build, ["l_orderkey"], ["o_orderkey"])
    hj = hash_join(probe, build, ["l_orderkey"], ["o_orderkey"])

    def join_rows(res):
        b = res.batch
        live = b.sel.cpu().numpy()
        return sorted(zip(*(b.col(c).values.cpu().numpy()[live].tolist()
                            for c in ("l_orderkey", "l_extendedprice",
                                      "o_orderdate"))))

    if bool(mj.overflow) or join_rows(mj) != join_rows(hj):
        raise SystemExit("merge_join differs from hash_join at Q3's "
                         "orders x lineitem join")
    mj_ms = event_ms(torch, lambda: merge_join(
        probe, build, ["l_orderkey"], ["o_orderkey"]), reps=10)
    hj_ms = event_ms(torch, lambda: hash_join(
        probe, build, ["l_orderkey"], ["o_orderkey"]), reps=10)
    print(f"  (g) merge_join at Q3's orders x lineitem join ({probe.capacity}"
          f" probe lanes, {build.capacity} build lanes): equal to "
          f"hash_join's {len(join_rows(hj))} rows; device ms merge_join "
          f"{mj_ms:.3f}, hash_join {hj_ms:.3f}", flush=True)
    out["merge_join_q3"] = {"ms": mj_ms, "hash_join_ms": hj_ms}

    # Q3 with every operator wrapped in the invariants checker
    settings = Settings()
    settings.set(INVARIANTS, True)
    try:
        flow = fresh("q3")
    finally:
        settings.set(INVARIANTS, False)
    res, dt, _peak, st = spill_run(torch, flow, collect, "checked q3")
    check("q3", "checked q3", res)
    if "fused.exec" in st:
        raise SystemExit("checked q3 ran the fused tier")
    print(f"  (g) Q3 with sql.tpu.invariants on (every operator checked, "
          f"the fused tier declined): {dt:.3f} s, equal to the oracle",
          flush=True)
    out["checked_q3_s"] = dt
    return out


# ------------------------------------------------------------ phase 11

PHASE11 = ("q1", "q3", "q5", "q6", "q9", "q10", "q12", "q14", "q16", "q18")
# the SQL texts' output names that differ from the hand plans' (query_rows
# reads the plans' names)
SQL_RENAMES = {"q9": {"nation": "n_name"},
               "q14": {"promo": "promo_revenue", "total": "total_revenue"}}
# The binder's plan for Q5's text (the JAX binder's: greedy join order)
# joins the ASIA suppliers with the orders of their nations' customers on
# the nation key, about 18 M rows at SF 1 from a probe of ~2,000: its
# expand join needs more restarts than MAX_RESTARTS allows, in the JAX
# package as in the port (both raise FlowRestart from SF 0.1 up, where
# SF 0.05 still fits; tests/test_torch_sql_restarts.py). The Session
# maps it to SQLSTATE 40001. Phase 9 runs Q5's hand-built plan.
SQL_RESTARTS_EXHAUSTED = ("q5",)
# the SQL texts whose warm replay phase 11 traces for K1 (Q5's text
# cannot run at SF 1)
SQL_K1 = ("q1", "q12")
WINDOW_SQL = """
select l_orderkey, l_linenumber, l_suppkey,
       row_number() over (partition by l_orderkey order by l_linenumber)
           as rn,
       rank() over (partition by l_orderkey order by l_linenumber) as rk,
       sum(l_quantity) over (partition by l_orderkey order by l_linenumber)
           as sq,
       min(l_extendedprice) over (partition by l_orderkey
                                  order by l_linenumber) as mp,
       lag(l_quantity) over (partition by l_orderkey order by l_linenumber)
           as lq,
       max(l_shipmode) over (partition by l_suppkey) as ms
from lineitem{where}
"""
# the window query over all of lineitem: 5,999,464 result rows, past the
# fused runner's largest packed result (RESULT_CAP_MAX, 2^20 rows), and
# its sort past the default 512 MiB workmem in the fused tracer's rule
WINDOW_SQL_ALL = WINDOW_SQL.format(where="")
# the same windows over the orders up to key WINDOW_PART_ORDERKEY: about
# 960,000 rows, a result inside the packed window. The tracer reckons the
# sort's lanes from the scan's (8 x 2^20, whatever the filter keeps), so
# the session raises workmem to WINDOW_WORKMEM for it
WINDOW_PART_ORDERKEY = 240_000
WINDOW_SQL_PART = WINDOW_SQL.format(
    where=f"\nwhere l_orderkey <= {WINDOW_PART_ORDERKEY}")
WINDOW_WORKMEM = 1 << 30
WINDOW_COLS = ("l_orderkey", "l_linenumber", "l_suppkey", "rn", "rk", "sq",
               "mp", "lq", "ms")
# (label, its computed output column, the text)
ROW_ENGINE_SQL = (
    ("strings", "uname", "select s_suppkey, upper(s_name) as uname "
                         "from supplier where s_suppkey > 0"),
    ("decimals", "third", "select s_suppkey, s_acctbal / 3 as third "
                          "from supplier where s_suppkey > 0"),
)
COUNT_REGION = "select count(*) as n from region"
# what the fused runner does on a warm run (a CPU rehearsal runs eagerly)
WARM_MODE = "replay"
TRACE_ATTEMPTS = 3
FLOOR_RUNS = 20


def pregenerated_catalog(gen):
    """A TPCHCatalog whose chunks are slices of tables generated before
    the clock starts (gen.table is memoized); its scan-cache keys are the
    TPCHCatalog's."""
    from cockroach_tpu_torch.sql.plan import TPCHCatalog

    class Pregenerated(TPCHCatalog):
        def table_chunks(self, name, capacity, columns=None):
            table = self.gen.table(name)
            cols = list(columns) if columns else list(table)
            n = self.gen.num_rows(name)

            def chunks():
                for a in range(0, n, capacity):
                    yield {c: table[c][a:a + capacity] for c in cols}

            return chunks

    return Pregenerated(gen)


def sql_text(name: str) -> str:
    from cockroach_tpu_torch.workload import tpch_queries as tq

    text = tq.SQL[int(name[1:])]
    return text.format(threshold=Q18_THRESHOLD) if name == "q18" else text


def sql_rows(name: str, res) -> list:
    """query_rows over a SQL result, its columns named as the plan's."""
    res = dict(res)
    for a, b in SQL_RENAMES.get(name, {}).items():
        res[b], res[b + "__valid"] = res[a], res[a + "__valid"]
    return query_rows(name, res)


def session_run(torch, session, sql: str, seconds=None):
    """One Session.execute: (result, seconds, synchronizing calls, every
    stage's event count, the parses it made, kernel launches). The launch
    counts are set to 0 just before it and read just after. A dict
    `seconds` receives every stage's seconds."""
    import warnings

    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.ops import cuda_kernels as ck
    from cockroach_tpu_torch.sql import parser

    parses = []
    real_parse = parser.parse
    parser.parse = lambda s: parses.append(s) or real_parse(s)
    for k in ck.KERNELS:
        k.launches = 0
    col = stats.enable()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                kind, res, _schema = session.execute(sql)
                dt = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        stats.disable()
        parser.parse = real_parse
    torch.cuda.synchronize()
    if kind != "rows":
        raise SystemExit(f"{sql[:40]!r}: {kind}, expected rows")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    events = {n: st.events for n, st in col.stages.items()}
    if seconds is not None:
        seconds.update({n: st.seconds for n, st in col.stages.items()})
    events["host.rowmap.rows"] = (col.stages["host.rowmap"].rows
                                  if "host.rowmap" in col.stages else 0)
    events["host.rowmap.s"] = (col.stages["host.rowmap"].seconds
                               if "host.rowmap" in col.stages else 0.0)
    launches = {k.source.stem: k.launches for k in ck.KERNELS}
    return res, dt, syncs, events, len(parses), launches


def check_warm_hit(label: str, runner, events, parses, syncs) -> None:
    """A warm execute is a prepared hit with no parse, exactly one replay
    of `runner`'s graph and at most one synchronizing call."""
    last = runner.last if runner is not None else {}
    if (events.get("sql.prepared_hit") != 1 or parses
            or events.get("fused.replay") != 1
            or events.get("fused.capture") or events.get("fused.prime")
            or last.get("mode") != WARM_MODE):
        raise SystemExit(f"{label}: {events}, {parses} parses, {last}: "
                         f"expected a prepared hit and one replay")
    if syncs > 1:
        raise SystemExit(f"{label}: {syncs} synchronizing calls, expected "
                         f"<= 1")


def scan_keys_cached(cat, plan, dev) -> dict:
    """{table: whether its scan's image is in the scan-image cache} for
    the normalized plan's scans."""
    from cockroach_tpu_torch.exec.operators import _device_key
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
    from cockroach_tpu_torch.sql.plan import Scan, _walk_plan, normalize

    out = {}
    for s in _walk_plan(normalize(plan, cat)):
        if isinstance(s, Scan):
            key = cat.scan_cache_key(s.table, list(s.columns or ()),
                                     CAPACITY) + (_device_key(dev),)
            out[s.table] = out.get(s.table, True) and \
                scan_image_cache().contains(key)
    return out


def window_rows(gen, max_orderkey=None) -> dict:
    """lineitem's columns, only the rows up to `max_orderkey` if given."""
    t = gen.table("lineitem")
    if max_orderkey is None:
        return t
    keep = t["l_orderkey"] <= max_orderkey
    return {c: v[keep] for c, v in t.items()}


def window_oracle(gen, max_orderkey=None) -> dict:
    """The window query's columns from numpy (np.lexsort, segment starts,
    per-segment cumsums), in the operator's output order: (l_suppkey,
    l_orderkey, l_linenumber)."""
    t = window_rows(gen, max_orderkey)
    ok, ln, sk = (t["l_orderkey"].astype(np.int64),
                  t["l_linenumber"].astype(np.int64),
                  t["l_suppkey"].astype(np.int64))
    qty = t["l_quantity"].astype(np.int64)
    price = t["l_extendedprice"].astype(np.int64)
    n = len(ok)
    o1 = np.lexsort((ln, ok))
    ok1, ln1 = ok[o1], ln[o1]
    start = np.r_[True, ok1[1:] != ok1[:-1]]
    peer = start | np.r_[True, ln1[1:] != ln1[:-1]]
    seg = np.cumsum(start) - 1
    seg_start = np.flatnonzero(start)[seg]
    peer_id = np.cumsum(peer) - 1
    peer_start = np.flatnonzero(peer)[peer_id]
    peer_end = np.r_[np.flatnonzero(peer)[1:] - 1, n - 1][peer_id]
    idx = np.arange(n)
    q1 = qty[o1]
    cs = np.cumsum(q1)
    sq = (cs - (cs - q1)[seg_start])[peer_end]
    pos = idx - seg_start
    grid = np.full((seg[-1] + 1, pos.max() + 1), np.iinfo(np.int64).max)
    grid[seg, pos] = price[o1]
    mp = np.minimum.accumulate(grid, axis=1)[seg, peer_end - seg_start]
    lq = np.where(pos > 0, np.r_[0, q1[:-1]], 0)
    by_row = {"rn": idx - seg_start + 1, "rk": peer_start - seg_start + 1,
              "sq": sq, "mp": mp, "lq": lq}
    cols = {}
    for name, v in by_row.items():
        back = np.empty(n, np.int64)
        back[o1] = v
        cols[name] = back
    lq_valid = np.empty(n, bool)
    lq_valid[o1] = pos > 0
    d = gen.schema("lineitem").dicts["l_shipmode"]
    order = np.argsort(d.astype(str))
    rank = np.argsort(order)[t["l_shipmode"]]
    best = np.full(sk.max() + 1, -1)
    np.maximum.at(best, sk, rank)
    cols["ms"] = order[best[sk]].astype(np.int32)
    final = np.lexsort((ln, ok, sk))
    out = {"l_orderkey": ok[final], "l_linenumber": ln[final],
           "l_suppkey": sk[final]}
    for name in ("rn", "rk", "sq", "mp", "lq", "ms"):
        out[name] = cols[name][final]
    out["lq__valid"] = lq_valid[final]
    return out


def check_window(label: str, res, oracle) -> None:
    """Every column equal to the numpy oracle (all integers: exact), every
    column valid but lag's first row of each order."""
    for c in WINDOW_COLS:
        if not np.array_equal(np.asarray(res[c]).astype(np.int64),
                              oracle[c].astype(np.int64)):
            bad = np.flatnonzero(np.asarray(res[c]) != oracle[c])[:3]
            raise SystemExit(f"window {label}: {c} differs from the numpy "
                             f"oracle at rows {bad.tolist()}")
        want_valid = oracle.get(c + "__valid")
        got_valid = np.asarray(res[c + "__valid"])
        if want_valid is None:
            if not got_valid.all():
                raise SystemExit(f"window {label}: {c} has NULLs")
        elif not np.array_equal(got_valid, want_valid):
            raise SystemExit(f"window {label}: {c}'s validity differs")


def window_plain_check(torch, res, gen, dev, max_orderkey=None) -> None:
    """rank, the running min and the string max held to a plain PyTorch
    computation on the card: one torch.sort per partition key, segments
    from torch.unique_consecutive, a cummin over the (order, line)
    layout, a scatter_reduce max per supplier."""
    t = window_rows(gen, max_orderkey)
    ok = torch.from_numpy(t["l_orderkey"].astype(np.int64)).to(dev)
    ln = torch.from_numpy(t["l_linenumber"].astype(np.int64)).to(dev)
    sk = torch.from_numpy(t["l_suppkey"].astype(np.int64)).to(dev)
    price = torch.from_numpy(t["l_extendedprice"].astype(np.int64)).to(dev)
    key = ok * 8 + ln
    skey, perm = torch.sort(key)
    _u, counts = torch.unique_consecutive(skey // 8, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = (torch.arange(len(skey), device=dev)
           - torch.repeat_interleave(starts, counts))
    seg = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                  counts)
    grid = torch.full((len(counts), int(pos.max()) + 1),
                      torch.iinfo(torch.int64).max, device=dev)
    grid[seg, pos] = price[perm]
    run_min = torch.cummin(grid, dim=1).values[seg, pos]
    rank = torch.empty_like(pos)
    rank[perm] = pos + 1
    mins = torch.empty_like(run_min)
    mins[perm] = run_min
    d = gen.schema("lineitem").dicts["l_shipmode"]
    order = np.argsort(d.astype(str))
    rank_of = torch.from_numpy(np.argsort(order)).to(dev)
    code_of = torch.from_numpy(order).to(dev)
    sm = rank_of[torch.from_numpy(t["l_shipmode"].astype(np.int64)).to(dev)]
    best = torch.full((int(sk.max()) + 1,), -1, dtype=torch.int64,
                      device=dev)
    best.scatter_reduce_(0, sk, sm, "amax")
    smax = code_of[best[sk]]
    # the result's rows, keyed by (orderkey, linenumber)
    r_ok = torch.from_numpy(np.asarray(res["l_orderkey"], np.int64)).to(dev)
    r_ln = torch.from_numpy(np.asarray(res["l_linenumber"],
                                       np.int64)).to(dev)
    rpos = torch.searchsorted(skey, r_ok * 8 + r_ln)
    at = perm[rpos]
    for name, plain in (("rk", rank[at]), ("mp", mins[at]),
                        ("ms", smax[at])):
        got = torch.from_numpy(np.asarray(res[name], np.int64)).to(dev)
        if not torch.equal(got, plain.to(torch.int64)):
            raise SystemExit(f"window: {name} differs from its plain "
                             f"PyTorch version (torch.sort per segment)")


def runtime_calls(trace_path: str, needle: str) -> int:
    """The host's CUDA runtime or driver calls in a torch.profiler chrome
    trace whose name holds `needle`."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and needle in e.get("name", ""))


def traced_replay_reading(torch, session, text: str, stem: str) -> dict:
    """One traced warm execute of `text`: the dense_sums kernels and all
    device kernels the trace recorded, the graph launches on its host
    side and the runner's mode. A trace whose host side records the graph
    launch of a replay but whose device side holds no record at all is
    the profiler's loss, not the replay's (a graph launch runs every node
    of the graph): it is taken again, up to TRACE_ATTEMPTS times, and the
    reading says so. Any other reading stands as it is."""
    attempts = 0
    while True:
        attempts += 1
        trace_query(torch, session.execute, text, stem)
        trace = stem + "_trace.json"
        reading = {
            "dense_sums": kernel_events(trace, DS_KERNEL),
            "device_kernels": kernel_events(trace, ""),
            "device_records": device_busy_ms(trace)[1],
            "graph_launches": runtime_calls(trace, "GraphLaunch"),
            "mode": session._prepared[text].op._fused_runner.last.get(
                "mode"),
            "attempts": attempts, "retaken": attempts > 1}
        lost = (reading["device_records"] == 0
                and reading["graph_launches"] >= 1
                and reading["mode"] == WARM_MODE)
        if not lost or attempts == TRACE_ATTEMPTS:
            return reading


def window_tiers(torch, session, text, label, w_oracle, gen, dev, max_okey,
                 trace_dir) -> dict:
    """The window query through the session (a cold and WARM_RUNS warm
    executes, each a prepared hit) and its prepared tree through the
    streaming operators (3 runs), every run equal to the numpy oracle and
    one to plain PyTorch. Where the fused tracer admits it, every warm
    execute is one replay and one replay is traced. -> its record."""
    from cockroach_tpu_torch.exec.fused import RESULT_CAP_MAX
    from cockroach_tpu_torch.exec.operators import collect

    rows = len(w_oracle["rn"])
    fused = max_okey is not None
    if fused != (rows <= RESULT_CAP_MAX):
        raise SystemExit(f"window {label}: {rows} rows against the packed "
                         f"window's {RESULT_CAP_MAX}")
    res, w_cold, _y, ev, _p, _l = session_run(torch, session, text)
    check_window(f"{label} cold", res, w_oracle)
    window_plain_check(torch, res, gen, dev, max_okey)
    runner = session._prepared[text].op._fused_runner
    why = runner.last.get("unsupported", "")
    if not fused and "workmem" not in why:
        raise SystemExit(f"window {label} cold: {runner.last}, expected the "
                         f"fused tracer's workmem rule to decline it")
    w_warm = []
    for i in range(WARM_RUNS):
        res, dt, n_sync, ev, parses, _l = session_run(torch, session, text)
        check_window(f"{label} warm {i + 1}", res, w_oracle)
        if fused:
            check_warm_hit(f"window {label} warm execute {i + 1}", runner,
                           ev, parses, n_sync)
        elif (ev.get("sql.prepared_hit") != 1 or parses
              or runner.last.get("mode") != "streaming"
              or ev.get("fused.replay") or ev.get("fused.capture")):
            raise SystemExit(f"window {label} warm execute {i + 1}: {ev}, "
                             f"{parses} parses, {runner.last}: expected a "
                             f"prepared hit the streaming operators run")
        w_warm.append(dt)
    # the last warm execute's sort, spill and fused events (does a sort
    # go external)
    events = {k: v for k, v in ev.items()
              if k.split(".")[0] in ("sort", "spill", "fused")}
    rec = {"rows": rows, "tier": "fused" if fused else "streaming",
           "declined": why, "warm_events": events,
           "session_warm_s": statistics.median(w_warm),
           "session_warm_runs_s": w_warm, "cold_s": w_cold}
    busy = wall = None
    top = []
    if fused:
        stem = os.path.join(trace_dir, f"sql_window_{label}")
        busy, wall, top, _c, _cc = trace_query(torch, session.execute,
                                               text, stem)
        rec.update({"device_busy_ms": busy, "traced_wall_ms": wall,
                    "top_ops": [(n, t, c) for n, t, c in top[:3]]})
    op = session._prepared[text].op
    w_stream = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = collect(op, device=dev, fuse=False)
        w_stream.append(time.perf_counter() - t0)
        check_window(f"{label} streaming", res, w_oracle)
    rec["streaming_runs_s"] = w_stream
    over = ("all of lineitem" if max_okey is None
            else f"lineitem up to l_orderkey {max_okey}")
    print(f"  window over {over} ({rows} rows): session ({rec['tier']}) warm median "
          f"{statistics.median(w_warm) * 1e3:.1f} ms of "
          f"{[round(w * 1e3, 1) for w in w_warm]} (cold "
          f"{w_cold * 1e3:.1f} ms); streaming collect "
          f"{[round(w * 1e3, 1) for w in w_stream]} ms; equal to the numpy "
          f"oracle and to plain PyTorch; a warm execute's events {events}",
          flush=True)
    if fused:
        print(f"  traced window replay ({label}): device busy {busy:.1f} of "
              f"{wall:.1f} ms; three longest device ops (total ms, count):",
              flush=True)
        for opname, ms, cnt in top[:3]:
            print(f"    {ms:9.3f} {cnt:5d}  {opname[:110]}")
    return rec


def run_phase11(torch, gen, dev, phase9_warm, profile_dir, trace_runs=1):
    """The SQL front end at SF 1, capacity 2^20, on CUDA, through a
    Session over the TPC-H catalog (data generated off the clock):
    (a) the ten SQL texts, each a cold execute and WARM_RUNS warm
    executes (prepared hits: no parse, one graph replay, at most one
    synchronizing call), each equal to its oracle and to phase 9's rows,
    with the front end's costs (parse + bind, compile_plan) beside the
    cold, warm and phase 9 fused warm times; (b) `trace_runs` traced warm
    replays of the SQL Q1 and Q12 each run FUSED_K1 dense_sums kernels;
    (c) a window query over all of lineitem (streaming: the fused tracer
    declines it) and over the orders up to WINDOW_PART_ORDERKEY (both
    tiers), held to a numpy oracle and to plain PyTorch; (d) the row engine over a fused subtree (computed
    strings, exact decimal division); (e) EXPLAIN and EXPLAIN ANALYZE of
    Q3; (f) the cost model's coefficients; (g) the shell in a
    subprocess. -> (the JSON records, the K1 launches of the SQL
    path)."""
    from decimal import ROUND_HALF_UP, Decimal

    from cockroach_tpu_torch.cli import decimal_text
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.exec.operators import collect
    from cockroach_tpu_torch.exec.rowexec import RowMapOp
    from cockroach_tpu_torch.sql.bind import plan_sql
    from cockroach_tpu_torch.sql.plan_compile import (
        CompiledSubtreeOp, compile_plan,
    )
    from cockroach_tpu_torch.sql.session import Session
    from cockroach_tpu_torch.workload import tpch_queries as tq
    from cockroach_tpu_torch.workload.tpch import TPCH

    print(f"[11] the SQL front end: SF {SF}, capacity {CAPACITY}, a "
          f"Session over the TPC-H catalog on {dev}", flush=True)
    t_phase = time.perf_counter()
    cat = pregenerated_catalog(gen)
    session = Session(cat, capacity=CAPACITY, device=dev)
    rf_names = gen.schema("lineitem").dicts["l_returnflag"]
    ls_names = gen.schema("lineitem").dicts["l_linestatus"]
    q1_oracle = tq.q1_oracle(gen)
    oracles = {n: query_oracle(n, gen) for n in PHASE11 if n != "q1"}
    records, k1_sql = {}, {}

    def check(name, label, res):
        if name == "q1":
            check_q1(res, q1_oracle, rf_names, ls_names)
            return
        rows = sql_rows(name, res)
        if rows != oracles[name] or rows != STREAMING_ROWS[name]:
            raise SystemExit(f"sql {name} {label}: {rows[:3]}... differs "
                             f"from its oracle or phase 9's rows")

    trace_dir = profile_dir or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "phase11_traces")
    os.makedirs(trace_dir, exist_ok=True)

    # (a) the ten texts
    for name in PHASE11:
        text = sql_text(name)
        # the first bind samples the catalog's statistics of each table
        # it has not seen yet; the second is the per-statement cost
        t0 = time.perf_counter()
        plan = plan_sql(text, cat)
        first_bind_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plan = plan_sql(text, cat)
        bind_ms = (time.perf_counter() - t0) * 1e3
        compile_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            compile_plan(plan, cat, CAPACITY)
            compile_ms.append((time.perf_counter() - t0) * 1e3)
        cached = scan_keys_cached(cat, plan, dev)
        if name in SQL_RESTARTS_EXHAUSTED:
            from cockroach_tpu_torch.sql.session import SQLError

            t0 = time.perf_counter()
            try:
                session.execute(text)
            except SQLError as e:
                if e.pgcode != "40001" or "restart" not in str(e):
                    raise
                fail_s = time.perf_counter() - t0
                print(f"  sql {name}: parse+bind {bind_ms:.2f} ms; raised "
                      f"SQLSTATE 40001 ({e}) after {fail_s:.1f} s, as the "
                      f"JAX binder's plan does (its nation-key join of "
                      f"suppliers and orders outgrows the restarts)",
                      flush=True)
                records[name] = {"bind_ms": bind_ms, "error": str(e),
                                 "pgcode": e.pgcode, "fail_s": fail_s}
                continue
            raise SystemExit(f"sql {name}: ran at SF {SF}, expected the "
                             f"restart budget to run out")
        res, cold, _y, ev, _p, _l = session_run(torch, session, text)
        check(name, "cold execute", res)
        cold_restarts = ev.get("flow.restart", 0)
        packed = ev.get("scan.pack", 0)
        if all(cached.values()) and packed:
            raise SystemExit(f"sql {name} cold execute: {packed} scan.pack "
                             f"events, though every image was cached")
        warm, syncs = [], []
        for i in range(WARM_RUNS):
            res, dt, n_sync, ev, parses, launches = session_run(
                torch, session, text)
            check(name, f"warm execute {i + 1}", res)
            check_warm_hit(f"sql {name} warm execute {i + 1}",
                           session._prepared[text].op._fused_runner, ev,
                           parses, n_sync)
            warm.append(dt)
            syncs.append(n_sync)
        warm_s = statistics.median(warm)
        fused_s = phase9_warm[name]
        # the same prepared tree collected directly (each run a replay):
        # the session's own cost is the difference
        op = session._prepared[text].op
        direct = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            res = collect(op, device=dev)
            direct.append(time.perf_counter() - t0)
            if op._fused_runner.last.get("mode") != WARM_MODE:
                raise SystemExit(f"sql {name}: a direct collect of the "
                                 f"prepared tree was not a replay")
        check(name, "direct collect", res)
        direct_s = statistics.median(direct)
        borrowed = sorted(t for t, hit in cached.items() if hit)
        print(f"  sql {name}: parse+bind {bind_ms:.2f} ms (first "
              f"{first_bind_ms:.2f}), compile_plan {compile_ms[1]:.2f} ms "
              f"(first {compile_ms[0]:.2f}); cold {cold * 1e3:.1f} ms, "
              f"{cold_restarts} restarts (images borrowed {borrowed}, packed "
              f"{sorted(t for t, hit in cached.items() if not hit)}); warm "
              f"median {warm_s * 1e3:.3f} ms of "
              f"{[round(w * 1e3, 3) for w in warm]}; the prepared tree "
              f"collected directly {direct_s * 1e3:.3f} ms (the session's "
              f"own cost {(warm_s - direct_s) * 1e3:.3f} ms); phase 9 "
              f"fused warm (the hand plan) {fused_s * 1e3:.3f} ms; syncs "
              f"{syncs}", flush=True)
        records[name] = {"bind_ms": bind_ms, "first_bind_ms": first_bind_ms,
                         "compile_plan_ms": compile_ms[1],
                         "first_compile_plan_ms": compile_ms[0],
                         "cold_restarts": cold_restarts, "cold_s": cold,
                         "direct_s": direct_s, "warm_s": warm_s,
                         "warm_runs_s": warm,
                         "phase9_fused_warm_s": fused_s,
                         "borrowed": borrowed, "syncs_warm": syncs}

    # (b) K1 from SQL: traced warm replays, `trace_runs` of each text,
    # every one read on both sides of the trace: the device's kernels
    # (dense_sums among them) and the host's graph launches
    for name in SQL_K1:
        text = sql_text(name)
        readings = []
        for i in range(trace_runs):
            stem = os.path.join(trace_dir, f"sql_{name}_{i}")
            readings.append(traced_replay_reading(
                torch, session, text, stem))
        retaken = [i for i, r in enumerate(readings) if r["retaken"]]
        for r in readings:
            if r["dense_sums"] != FUSED_K1[name] or r["mode"] != WARM_MODE:
                raise SystemExit(f"sql {name}: traced warm runs {readings}; "
                                 f"expected {FUSED_K1[name]} dense_sums "
                                 f"kernels in a {WARM_MODE}")
        _r, _dt, _y, ev, _p, launches = session_run(torch, session, text)
        if launches.get("dense_sums") != FUSED_K1[name]:
            raise SystemExit(f"sql {name}: a warm run counted {launches}; "
                             f"expected {FUSED_K1[name]} dense_sums")
        seen = [(r["device_kernels"], r["graph_launches"], r["attempts"])
                for r in readings]
        print(f"  sql {name}: {trace_runs} traced warm replays, each "
              f"{FUSED_K1[name]} dense_sums; (device kernels, host graph "
              f"launches, attempts) {seen}; retaken after the profiler "
              f"left the device side empty: {retaken}", flush=True)
        k1_sql[name] = readings[0]["dense_sums"]
        records[name]["k1_traces"] = readings
    print(f"  K1 from SQL: dense_sums kernels per traced warm replay "
          f"{k1_sql} (FUSED_K1 {FUSED_K1})", flush=True)

    # (c) the window query. Over all of lineitem its result is past the
    # fused runner's packed window and its sort past the default workmem:
    # the fused tracer declines (its workmem rule, cached for the config)
    # and the streaming operators run it, the session's warm executes
    # too. Over the orders up to WINDOW_PART_ORDERKEY its result fits the
    # packed window, and under WINDOW_WORKMEM it runs on both tiers
    records["window"] = {}
    for label, text, max_okey, workmem in (
            ("all", WINDOW_SQL_ALL, None, None),
            ("part", WINDOW_SQL_PART, WINDOW_PART_ORDERKEY, WINDOW_WORKMEM)):
        t0 = time.perf_counter()
        w_oracle = window_oracle(gen, max_okey)
        oracle_s = time.perf_counter() - t0
        saved = session._get_var("workmem")
        if workmem is not None:
            session.execute(f"set workmem = {workmem}")
        try:
            rec = window_tiers(torch, session, text, label, w_oracle, gen,
                               dev, max_okey, trace_dir)
        finally:
            session.execute(f"set workmem = {saved}")
        rec["oracle_s"] = oracle_s
        rec["workmem"] = workmem or saved
        records["window"][label] = rec

    # (d) the row engine over a fused subtree
    s = gen.table("supplier")
    names = gen.schema("supplier").dicts["s_name"]
    host_rows, host_s = 0, 0.0
    for label, out_col, text in ROW_ENGINE_SQL:
        if label == "decimals":
            session.execute("set exact_arithmetic = on")
        try:
            res, cold, _y, ev, _p, _l = session_run(torch, session, text)
            root = session._prepared[text].op
            if not (isinstance(root, RowMapOp)
                    and isinstance(root.child, CompiledSubtreeOp)):
                raise SystemExit(f"row engine {label}: the tree is "
                                 f"{type(root).__name__} over "
                                 f"{type(root.child).__name__}")
            runs = []
            for i in range(3):
                res, dt, n_sync, ev, parses, _l = session_run(
                    torch, session, text)
                check_warm_hit(f"row engine {label} warm {i + 1}",
                               root.child.runner, ev, parses, n_sync)
                runs.append(dt)
                host_rows += ev["host.rowmap.rows"]
                host_s += ev["host.rowmap.s"]
            if label == "strings":
                minted = root.schema.dictionary(out_col)
                got = [str(minted[c]) for c in res[out_col]]
                want = [str(x).upper() for x in names[s["s_name"]]]
            else:
                got = np.asarray(res[out_col]).tolist()
                want = [int((Decimal(int(v)).scaleb(-2) / 3).quantize(
                    Decimal(1).scaleb(-6), rounding=ROUND_HALF_UP)
                    .scaleb(6)) for v in s["s_acctbal"]]
            if got != want or not np.asarray(res[out_col + "__valid"]).all():
                raise SystemExit(f"row engine {label}: differs from its "
                                 f"oracle")
            tiers = [(o.name, o.tier) for o in compile_plan(
                plan_sql(text, cat), cat, CAPACITY).placement.ops]
            print(f"  row engine {label}: RowMapOp over one CUDA graph, "
                  f"{len(got)} rows equal to the oracle; cold "
                  f"{cold * 1e3:.1f} ms, warm "
                  f"{[round(r * 1e3, 1) for r in runs]} ms; tiers {tiers}",
                  flush=True)
            records[f"rowmap_{label}"] = {"cold_s": cold, "warm_runs_s": runs,
                                          "tiers": tiers}
        finally:
            if label == "decimals":
                session.execute("set exact_arithmetic = off")

    # (e) EXPLAIN and EXPLAIN ANALYZE of Q3
    for head in ("explain ", "explain analyze "):
        kind, lines, _ = session.execute(head + sql_text("q3"))
        tiers = [ln for ln in lines if "[tier=" in ln]
        if kind != "explain" or not tiers or any(
                "tier=fused" not in ln for ln in tiers):
            raise SystemExit(f"{head}q3: tiers are not all fused: {lines}")
        print(f"  {head.strip().upper()} q3:")
        for ln in lines:
            print(f"    {ln}")

    # (f) the cost model's coefficients
    res, _c, _y, _e, _p, _l = session_run(torch, session, COUNT_REGION)
    floor = []
    for i in range(FLOOR_RUNS):
        res, dt, n_sync, ev, parses, _l = session_run(torch, session,
                                                      COUNT_REGION)
        check_warm_hit(f"count(*) region warm {i + 1}",
                       session._prepared[COUNT_REGION].op._fused_runner, ev,
                       parses, n_sync)
        floor.append(dt)
    if int(res["n"][0]) != 5:
        raise SystemExit("select count(*) from region: not 5")
    coeffs = {"dispatch_floor_s": statistics.median(floor),
              "device_rows_per_s": gen.num_rows("lineitem")
              / phase9_warm["q1"],
              "host_rows_per_s": host_rows / host_s}
    card = card_line()
    print(f"  coefficients ({card}): dispatch floor "
          f"{coeffs['dispatch_floor_s'] * 1e3:.4f} ms (a warm session "
          f"execute of {COUNT_REGION!r}, median of {FLOOR_RUNS}); device "
          f"{coeffs['device_rows_per_s']:.4g} rows/s (lineitem over phase "
          f"9's fused Q1 warm median); host {coeffs['host_rows_per_s']:.4g} "
          f"rows/s (the row engine, {host_rows} rows)", flush=True)
    records["coefficients"] = dict(coeffs, card=card)

    # (g) the shell in a subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "cockroach_tpu_torch", "sql", "--sf", "0.01",
         "-e", sql_text("q6")], cwd=repo, env=env, capture_output=True,
        text=True, timeout=600)
    shell_s = time.perf_counter() - t0
    want = decimal_text(tq.q6_oracle(TPCH(sf=0.01)), 4)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or len(lines) < 3 or lines[2].strip() != want:
        raise SystemExit(f"the shell: exit {out.returncode}, printed "
                         f"{lines[:4]}, expected revenue {want}; "
                         f"{out.stderr[-2000:]}")
    print(f"  shell: python -m cockroach_tpu_torch sql --sf 0.01 -e <Q6> "
          f"exit 0 in {shell_s:.1f} s, revenue {lines[2].strip()} equal to "
          f"the oracle", flush=True)
    records["shell_s"] = shell_s
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records, k1_sql


# ----------------------------------------------------------- phase 12

COLD_MODE = "capture"  # what the runner does on a flow's cold run
MVCC_TABLES = ("lineitem", "orders", "customer", "part", "supplier",
               "partsupp", "nation", "region")
MVCC_WARM_RUNS = 3
# the write burst of (c): puts to random lineitem rows (new l_quantity,
# l_extendedprice and l_discount) and deletes, then a second burst of
# puts past the lowered compaction fraction
BURST_PUTS = 10_000
BURST_DELETES = 1_000
COMPACT_PUTS = 4_000
COMPACT_FRACTION = 0.0005
BURST_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount")
# the host stages of a read (exec/stats.py timers; summed over Q1 and Q6):
# the resident tier's materialize (the visibility pass, its count's sync
# and the image's copy to the host), that copy alone, the delta fold,
# and ScanOp's pack and copy back to the card
READ_STAGES = ("scan.resident", "scan.resident_transfer",
               "scan.resident_fold", "scan.pack", "scan.transfer")
# YCSB-E (d): the reference's workload E at 1,000,000 records
YCSB_RECORDS = 1_000_000
YCSB_OPS = 10_000
YCSB_TOPK = 100
YCSB_MICRO_K = 10
YCSB_BATCH = 256


def same_rows(name, label, res, q1_streaming) -> None:
    """Phase 12's runs against phase 9's rows (which phase 9 held to the
    oracles and to the streaming results): Q1's columns, or the query's
    rows."""
    if name == "q1":
        for c in q1_streaming:
            if not np.array_equal(np.asarray(res[c]),
                                  np.asarray(q1_streaming[c])):
                raise SystemExit(f"q1 {label} differs from phase 9 in {c}")
        return
    rows = query_rows(name, res)
    if rows != STREAMING_ROWS[name]:
        raise SystemExit(f"{name} {label}: {rows[:3]}... differs from "
                         f"phase 9's rows")


def equal_results(label, a, b) -> None:
    if list(a) != list(b):
        raise SystemExit(f"{label}: columns {list(a)} against {list(b)}")
    for c in a:
        if not np.array_equal(np.asarray(a[c]), np.asarray(b[c])):
            raise SystemExit(f"{label}: differs in {c}")


def same_as(name, label, res, ref) -> None:
    """A run against another tier's result of the same query: Q1's
    columns, or the query's rows."""
    if name == "q1":
        equal_results(label, res, ref)
    elif query_rows(name, res) != query_rows(name, ref):
        raise SystemExit(f"{name} {label}: differs from the streaming "
                         f"read")


def write_burst(store, tid, names, table, rng, n_puts, n_deletes,
                deleted=()):
    """n_puts puts (new values of BURST_COLUMNS, drawn within each
    column's loaded range) to distinct random rows and n_deletes deletes
    of others, none of them among the pks `deleted` already, at the
    store clock's timestamps. -> (seconds, the pks deleted)."""
    cols = [names.index(c) for c in BURST_COLUMNS]
    bounds = [(int(table[c].min()), int(table[c].max()))
              for c in BURST_COLUMNS]
    live = np.setdiff1d(np.arange(len(table[names[0]])),
                        np.asarray(deleted, np.int64))
    pks = rng.choice(live, n_puts + n_deletes, replace=False)
    t0 = time.perf_counter()
    for pk in pks[:n_puts].tolist():
        row, _ts = store.get(tid, pk)
        for j, (lo, hi) in zip(cols, bounds):
            row[j] = int(rng.integers(lo, hi + 1))
        store.put(tid, pk, row)
    for pk in pks[n_puts:].tolist():
        store.delete(tid, pk)
    return time.perf_counter() - t0, pks[n_puts:]


def check_mvcc_warm(label, last, events, syncs, restarts) -> None:
    """A warm run of a resident flow on the fused tier is exactly one
    graph replay with at most one synchronizing call and no restart."""
    if (last.get("mode") != WARM_MODE or events.get("fused.replay") != 1
            or events.get("fused.capture") or events.get("fused.prime")):
        raise SystemExit(f"{label}: {last}, {events}: expected exactly one "
                         f"replay")
    if syncs > 1 or restarts:
        raise SystemExit(f"{label}: {syncs} syncs, {restarts} restarts")


def run_phase12(torch, gen, dev, q1_streaming, profile_dir):
    """The MVCC storage layer on the card: (a) the native engine's build,
    (b) TPC-H SF 1 loaded into it and the fifteen queries through the
    MVCCCatalog on the fused tier (a cold run and MVCC_WARM_RUNS warm
    replays each, equal to phase 9's rows; Q1 and Q18 on the streaming
    tier too), (c) lineitem on the device-resident tier through a write
    burst, its fold, a forced compaction and snapshot reads, equal to
    the host walk, (d) YCSB-E at YCSB_RECORDS records. -> (JSON record,
    {K1 path: launches})."""
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.ops import mvcc_filter as mf
    from cockroach_tpu_torch.sql.plan import MVCCCatalog
    from cockroach_tpu_torch.storage import engine as engine_mod
    from cockroach_tpu_torch.storage import resident
    from cockroach_tpu_torch.storage.mvcc import MVCCStore
    from cockroach_tpu_torch.util.hlc import HLC, ManualClock
    from cockroach_tpu_torch.util.settings import Settings
    from cockroach_tpu_torch.workload import tpch_queries as tq
    from cockroach_tpu_torch.workload import ycsb

    t_phase = time.perf_counter()
    rec: dict = {"card": card_line()}
    k1: dict = {}

    # ---- (a) the engine
    t0 = time.perf_counter()
    lib = engine_mod._load()
    build_s = time.perf_counter() - t0
    if lib is None:
        raise SystemExit(f"the native engine did not build: "
                         f"{engine_mod._lib_err}")
    engine = engine_mod.NativeEngine()
    fallback = type(engine_mod.open_engine()).__name__
    if fallback != "NativeEngine":
        raise SystemExit(f"open_engine gives a {fallback} on the card")
    print(f"[12] the MVCC storage layer: native engine "
          f"{os.path.basename(lib._name)} built and loaded in "
          f"{build_s:.2f} s (g++ -O2, {engine_mod.BUILD_DIR})", flush=True)
    rec["engine_build_s"] = build_s

    # ---- (b) TPC-H SF 1 through the engine
    store = MVCCStore(engine=engine, clock=HLC(), device=dev)
    for t in MVCC_TABLES:
        gen.table(t)  # generated off the clock (earlier phases' memo)
    ingest_s: dict = {}
    ingest = store.ingest_table

    def timed_ingest(tid, pks, cols, ts=None):
        t1 = time.perf_counter()
        out = ingest(tid, pks, cols, ts)
        ingest_s[MVCC_TABLES[tid - 10]] = time.perf_counter() - t1
        return out

    store.ingest_table = timed_ingest
    t0 = time.perf_counter()
    mcat = gen.mvcc_load(store, MVCC_TABLES)
    load_s = time.perf_counter() - t0
    del store.ingest_table
    li_tid, li_schema = mcat.tables["lineitem"]
    li_names = li_schema.names()
    n_li = gen.num_rows("lineitem")
    n_chunks = -(-n_li // CAPACITY)  # K1 launches of a streaming Q1 pass
    t0 = time.perf_counter()
    walked = sum(len(c["f0"]) for c in store.scan_chunks(
        li_tid, len(li_names), CAPACITY))
    walk_s = time.perf_counter() - t0
    if walked != n_li:
        raise SystemExit(f"lineitem host walk: {walked} rows, expected "
                         f"{n_li}")
    print(f"  (b) mvcc_load of {len(MVCC_TABLES)} tables at SF {SF} in "
          f"{load_s:.2f} s (ingest per table: "
          + ", ".join(f"{t} {s:.3f} s" for t, s in ingest_s.items())
          + f"); lineitem host walk {walked} rows in {walk_s:.3f} s "
          f"({walked / walk_s:.4g} rows/s)", flush=True)
    rec.update(load_s=load_s, ingest_s=ingest_s, host_walk_rows=walked,
               host_walk_s=walk_s, host_walk_rows_per_s=walked / walk_s)

    builders = {n: (lambda n=n: (tq.q18(gen, Q18_THRESHOLD, CAPACITY,
                                        catalog=mcat) if n == "q18" else
                                 getattr(tq, n)(gen, CAPACITY,
                                                catalog=mcat)))
                for n in PHASE9}
    queries: dict = {}
    q1_flow = None
    for name in PHASE9:
        flow = builders[name]()
        make_resident(flow)
        res, cold, cold_r, cold_y, _l, ev, last = fused_run(torch, flow)
        same_rows(name, "mvcc cold run", res, q1_streaming)
        left_fused(name, "mvcc cold run", ev, last)
        if last.get("mode") != COLD_MODE:
            raise SystemExit(f"{name} mvcc cold run: {last}, expected a "
                             f"{COLD_MODE}")
        warm, syncs, restarts = [], [], [cold_r]
        for i in range(MVCC_WARM_RUNS):
            res, dt, n_r, n_sync, launches, ev, last = fused_run(torch, flow)
            same_rows(name, f"mvcc warm run {i + 1}", res, q1_streaming)
            left_fused(name, f"mvcc warm run {i + 1}", ev, last)
            check_mvcc_warm(f"{name} mvcc warm run {i + 1}", last, ev,
                            n_sync, n_r)
            want_k1 = FUSED_K1.get(name, 0)
            if launches.get("dense_sums", 0) != want_k1:
                raise SystemExit(f"{name} mvcc warm run {i + 1}: dense_sums "
                                 f"{launches}, expected {want_k1}")
            warm.append(dt)
            syncs.append(n_sync)
            restarts.append(n_r)
        if name in FUSED_K1:
            k1[f"{name}_mvcc_fused"] = launches.get("dense_sums", 0)
        queries[name] = {"cold_s": cold, "warm_s": statistics.median(warm),
                         "warm_runs_s": warm, "restarts": restarts,
                         "cold_syncs": cold_y, "warm_syncs": syncs,
                         "routes": last.get("routes")}
        print(f"  {name} via MVCCCatalog: cold {cold * 1e3:.1f} ms (syncs "
              f"{cold_y}), fused warm median "
              f"{statistics.median(warm) * 1e3:.3f} ms of "
              f"{[round(w * 1e3, 3) for w in warm]}; restarts {restarts}; "
              f"syncs per warm run {syncs}; routes {last.get('routes')}",
              flush=True)
        if name == "q1":
            q1_flow = flow
    # what a replay of the MVCC Q1 runs: K1 in a traced warm run
    trace_dir = profile_dir or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build",
        "phase12_traces")
    os.makedirs(trace_dir, exist_ok=True)
    stem = os.path.join(trace_dir, "q1_mvcc_fused")
    trace_query(torch, _fused_collect(), q1_flow, stem)
    k1_traced = kernel_events(stem + "_trace.json", DS_KERNEL)
    if q1_flow._fused_runner.last.get("mode") != WARM_MODE or k1_traced != 1:
        raise SystemExit(f"mvcc q1 traced replay: {k1_traced} dense_sums "
                         f"kernels, {q1_flow._fused_runner.last}")
    k1["q1_mvcc_fused_traced"] = k1_traced
    # Q1 and Q18 on the streaming tier, over the images the fused runs
    # left in the scan-image cache (fresh plan builds borrow them)
    for name in ("q1", "q18"):
        runs = []
        for i in range(2):
            flow = builders[name]()
            make_resident(flow)
            res, dt, n_r, _st, _y, launches, _ev = timed_collect(
                torch, stats, streaming_collect(), flow)
            same_rows(name, f"mvcc streaming run {i + 1}", res,
                      q1_streaming)
            if name == "q1" and launches["dense_sums"] != n_chunks * (1 + n_r):
                raise SystemExit(f"mvcc q1 streaming: dense_sums "
                                 f"{launches}, expected {n_chunks} a pass")
            runs.append((dt, n_r, launches["dense_sums"]))
        if name == "q1":
            k1["q1_mvcc_streaming"] = runs[-1][2]
        queries[name]["streaming_runs"] = runs
        print(f"  {name} via MVCCCatalog on the streaming tier: "
              f"(seconds, restarts, dense_sums) per run {runs}", flush=True)
    rec["queries"] = queries
    # (b)'s images and graphs go before lineitem attaches
    for scan in scans_of(q1_flow):
        scan.evict()
    q1_flow._fused_runner = None
    del q1_flow, flow
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

    scan_image_cache().clear()
    torch.cuda.empty_cache()

    # ---- (c) the device-resident tier at lineitem's full size
    settings = Settings()
    prev_frac = settings.get(resident.RESIDENT_COMPACT_FRACTION)
    settings.set(resident.RESIDENT_SCAN, True)
    bad_events = {"scan.resident_fallback": 0, "scan.resident_attach_fail": 0}

    def note(col):
        for e in bad_events:
            st = col.stages.get(e)
            bad_events[e] += st.events if st else 0

    ncols = len(li_names)
    with stats.query_stats() as col:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not store.make_resident(li_tid, ncols):
            raise SystemExit("lineitem did not attach to the resident tier")
        torch.cuda.synchronize()
        attach_ms = (time.perf_counter() - t0) * 1e3
    note(col)
    rt = resident.lookup(store, li_tid)
    if rt.cap != mf.pow2_at_least(n_li) or rt.n != n_li:
        raise SystemExit(f"resident lineitem: n {rt.n}, cap {rt.cap}")
    tread = rt._max_packed
    vis_ms = event_ms(torch, lambda: mf.visible_image(
        rt._pk, rt._ts, rt._tomb, rt._vals, rt.n, tread), reps=10)
    dcap = mf.pow2_at_least(BURST_PUTS + BURST_DELETES)
    delta = [torch.from_numpy(a).to(dev)
             for a in mf.sentinel_arrays(dcap, ncols)]
    g = torch.Generator(device=dev).manual_seed(12)
    delta[0][:dcap - 1] = torch.randint(0, n_li, (dcap - 1,), device=dev,
                                        generator=g)
    delta[1][:dcap - 1] = tread + 1
    delta[2][:dcap - 1] = torch.arange(rt.n, rt.n + dcap - 1, device=dev)
    fold_ms = event_ms(torch, lambda: mf.fold_versions(
        (rt._pk, rt._ts, rt._seq, rt._tomb, rt._vals), tuple(delta),
        rt.cap), reps=10)
    del delta
    # the bytes each pass must move, live lanes only: visible_image reads
    # pk, ts, tomb and the values of the n live lanes and writes the pks
    # and values of the `count` visible rows; the fold reads the n live
    # lanes and the d delta lanes and writes the n + d merged ones
    count = int(mf.visible_image(rt._pk, rt._ts, rt._tomb, rt._vals, rt.n,
                                 tread)[2])
    d = dcap - 1
    lane = 8 * 3 + 1 + 8 * ncols
    vis_bytes = rt.n * (8 + 8 + 1 + 8 * ncols) + count * (8 + 8 * ncols)
    fold_bytes = 2 * (rt.n + d) * lane
    print(f"  (c) lineitem resident: {rt.n} lanes at cap {rt.cap}, {ncols} "
          f"value columns, {rt.nbytes} bytes on the card; attach "
          f"{attach_ms:.1f} ms; visible_image ({count} rows) {vis_ms:.3f} ms "
          f"(bound {vis_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms by bytes); "
          f"fold_versions of a {d}-lane delta {fold_ms:.3f} ms (bound "
          f"{fold_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms by bytes)",
          flush=True)
    rec["resident"] = {"lanes": rt.n, "cap": rt.cap, "nbytes": rt.nbytes,
                       "attach_ms": attach_ms, "visible_image_ms": vis_ms,
                       "visible_image_bound_ms":
                           vis_bytes / PEAK_BYTES_PER_S * 1e3,
                       "visible_rows": count,
                       "fold_versions_ms": fold_ms, "fold_delta_lanes": d,
                       "fold_versions_bound_ms":
                           fold_bytes / PEAK_BYTES_PER_S * 1e3}

    def read(label, ts, resident_tier=True):
        """Q1 and Q6 at ts through a catalog pinned there (it keys no
        scan image, so every run reads the store) on the streaming
        tier, each run in a stats collection of its own: -> ({name:
        result}, {stage: (events, seconds, bytes)} summed, {name:
        seconds})."""
        from cockroach_tpu_torch.ops import cuda_kernels as ck

        cat = MVCCCatalog(mcat.store, mcat.tables, rows=mcat.rows,
                          pks=mcat.pks, stats=mcat.stats, ts=ts)
        out, stages, secs = {}, {}, {}
        for name in ("q1", "q6"):
            flow = getattr(tq, name)(gen, CAPACITY, catalog=cat)
            for k in ck.KERNELS:
                k.launches = 0
            with stats.query_stats() as col:
                t0 = time.perf_counter()
                res = streaming_collect()(flow)
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
            launches = {k.source.stem: k.launches for k in ck.KERNELS}
            restart = col.stages.get("flow.restart")
            n_r = restart.events if restart else 0
            if name == "q1" and launches["dense_sums"] != n_chunks * (1 + n_r):
                raise SystemExit(f"{label} q1: dense_sums {launches}, "
                                 f"expected {n_chunks} a pass")
            out[name] = res
            for n, st in col.stages.items():
                e, t, b = stages.get(n, (0, 0.0, 0))
                stages[n] = (e + st.events, t + st.seconds, b + st.bytes)
            went = "scan.resident" in col.stages
            if went != resident_tier:
                raise SystemExit(
                    f"{label} {name}: scan.resident "
                    f"{col.stages.get('scan.resident')}, expected the "
                    f"{'resident' if resident_tier else 'host-walk'} tier")
        for e in bad_events:
            bad_events[e] += stages.get(e, (0, 0.0, 0))[0]
        host_ms = {n: round(stages[n][1] * 1e3, 1) for n in READ_STAGES
                   if n in stages}
        xfer = stages.get("scan.resident_transfer", (0, 0.0, 0))[2]
        print(f"  {label}: Q1, Q6 "
              f"{ {n: round(t, 4) for n, t in secs.items()} } s; host ms "
              f"{host_ms}"
              + (f"; scan.resident_transfer {xfer} bytes"
                 if resident_tier else ""), flush=True)
        return out, stages, secs

    def fused_read(label):
        """Q1 and Q6 built over `mcat` (the read pinned at plan time, the
        images keyed by the table's version) on the fused tier, the scan
        served by the resident tier: a cold run, whose prefetch thread
        runs the visibility pass (the first read of this data: no image
        memoized) under the sync debug mode before the capture, and
        MVCC_WARM_RUNS replays, each equal to the cold run. -> ({name:
        the cold run's result}, {name: numbers})."""
        out, results = {}, {}
        for name in ("q1", "q6"):
            flow = getattr(tq, name)(gen, CAPACITY, catalog=mcat)
            make_resident(flow)
            cold_st: dict = {}
            res, cold, cold_r, cold_y, _l, ev, last = fused_run(
                torch, flow, cold_st)
            for e in bad_events:
                bad_events[e] += ev.get(e, 0)
            if not ev.get("scan.resident") or last.get("mode") != COLD_MODE:
                raise SystemExit(f"{name} {label} cold run: {last}, {ev}: "
                                 f"expected a {COLD_MODE} over the "
                                 f"resident tier")
            left_fused(name, f"{label} cold run", ev, last)
            results[name] = res
            warm, syncs = [], []
            for i in range(MVCC_WARM_RUNS):
                again, dt, n_r, n_sync, launches, ev, last = fused_run(torch,
                                                                       flow)
                same_as(name, f"{label} warm run {i + 1}", again, res)
                check_mvcc_warm(f"{name} {label} warm run {i + 1}", last, ev,
                                n_sync, n_r)
                if launches.get("dense_sums", 0) != FUSED_K1.get(name, 0):
                    raise SystemExit(f"{name} {label} warm run {i + 1}: "
                                     f"dense_sums {launches}")
                warm.append(dt)
                syncs.append(n_sync)
            out[name] = {"cold_s": cold, "cold_restarts": cold_r,
                         "cold_syncs": cold_y, "warm_runs_s": warm,
                         "warm_syncs": syncs,
                         "cold_transfer_bytes": cold_st.get(
                             "scan.resident_transfer", (0, 0.0, 0))[2],
                         "cold_host_ms": {n: cold_st[n][1] * 1e3
                                          for n in READ_STAGES
                                          if n in cold_st}}
            for scan in scans_of(flow):
                scan.evict()
            flow._fused_runner = None
        parts = []
        for n, o in out.items():
            host = {k: round(v, 1) for k, v in o["cold_host_ms"].items()}
            warm = [round(w * 1e3, 3) for w in o["warm_runs_s"]]
            parts.append(f"{n} cold {o['cold_s'] * 1e3:.1f} ms (syncs "
                         f"{o['cold_syncs']}; host ms {host}), warm {warm} "
                         f"ms")
        print(f"  {label}, fused over the resident tier: "
              + "; ".join(parts), flush=True)
        return results, out

    # the fused runs come first at each data state, so that their cold
    # runs' prefetch threads run the visibility pass (and after the
    # burst the fold); the streaming reads then hit the memoized image
    fres0, fused0 = fused_read("before the burst")
    ts0 = store.clock.now()
    before, st0, secs0 = read("resident read before the burst", ts0)
    for name, res in before.items():
        same_rows(name, "resident read before the burst", res, q1_streaming)
        same_as(name, "fused before the burst", fres0[name], res)
    rng = np.random.default_rng(20260)
    table = gen.table("lineitem")
    folds, rebuilds = rt.folds, rt.rebuilds
    burst_s, deleted = write_burst(store, li_tid, li_names, table, rng,
                                   BURST_PUTS, BURST_DELETES)
    fres1, fused1 = fused_read("after the burst")
    ts1 = store.clock.now()
    after1, st1, secs1 = read("resident read after the burst", ts1)
    for name, res in after1.items():
        same_as(name, "fused after the burst", fres1[name], res)
    if rt.folds != folds + 1 or rt.rebuilds != rebuilds:
        raise SystemExit(f"the burst: folds {folds} -> {rt.folds}, rebuilds "
                         f"{rebuilds} -> {rt.rebuilds}; expected one fold")
    fold_ms = fused1["q1"]["cold_host_ms"].get("scan.resident_fold")
    if fold_ms is None:
        raise SystemExit("the burst: the fused Q1 cold run did not fold")
    print(f"  burst of {BURST_PUTS} puts and {BURST_DELETES} deletes in "
          f"{burst_s:.2f} s; folded once, in the fused cold run's prefetch "
          f"(scan.resident_fold {fold_ms:.1f} ms host)", flush=True)
    snap, _st, _s = read("resident snapshot read before the burst, over "
                         "the folded arrays", ts0)
    for name, res in snap.items():
        same_rows(name, "resident snapshot read (folded)", res, q1_streaming)
    # a forced compaction: the fraction lowered under a second burst
    settings.set(resident.RESIDENT_COMPACT_FRACTION, COMPACT_FRACTION)
    try:
        burst2_s, _d = write_burst(store, li_tid, li_names, table, rng,
                                   COMPACT_PUTS, 0, deleted)
        ts2 = store.clock.now()
        after2, st2, secs2 = read("resident read after the compacting "
                                  "burst", ts2)
    finally:
        settings.set(resident.RESIDENT_COMPACT_FRACTION, prev_frac)
    compact = st2.get("scan.resident_compact")
    if rt.rebuilds != rebuilds + 1 or compact is None:
        raise SystemExit(f"the compacting burst: rebuilds {rt.rebuilds}, "
                         f"expected {rebuilds + 1} (a compaction)")
    print(f"  compacting burst of {COMPACT_PUTS} puts in {burst2_s:.2f} s; "
          f"compaction {compact[1] * 1e3:.1f} ms host", flush=True)
    again1, _st, _s = read("resident read at the first burst's timestamp, "
                           "compacted", ts1)
    snap2, _st, _s = read("resident snapshot read before the burst, "
                          "compacted", ts0)
    for name in ("q1", "q6"):
        equal_results(f"{name} at ts1 compacted", again1[name], after1[name])
        same_rows(name, "resident snapshot read (compacted)", snap2[name],
                  q1_streaming)
    # the host walk (table detached, storage.resident_scan off) at the
    # same timestamps
    settings.set(resident.RESIDENT_SCAN, False)
    resident.detach(store, li_tid)
    host1, _st, hsecs1 = read("host walk at the first burst's timestamp",
                              ts1, resident_tier=False)
    host2, _st, hsecs2 = read("host walk at the compacting burst's "
                              "timestamp", ts2, resident_tier=False)
    for name in ("q1", "q6"):
        equal_results(f"{name} resident vs host walk at ts1", after1[name],
                      host1[name])
        equal_results(f"{name} resident vs host walk at ts2", after2[name],
                      host2[name])
    if any(bad_events.values()):
        raise SystemExit(f"resident tier: {bad_events}")
    rec["resident"].update(
        burst_puts=BURST_PUTS, burst_deletes=BURST_DELETES, burst_s=burst_s,
        compact_puts=COMPACT_PUTS, compact_burst_s=burst2_s,
        fold_host_ms=fold_ms, compact_host_ms=compact[1] * 1e3,
        transfer_bytes_q1_q6=sum(o["cold_transfer_bytes"]
                                 for o in fused0.values()),
        read_before_host_ms={n: st0[n][1] * 1e3 for n in READ_STAGES
                             if n in st0},
        read_after_host_ms={n: st1[n][1] * 1e3 for n in READ_STAGES
                            if n in st1},
        read_before_s=secs0, read_after_s=secs1,
        read_after_compaction_s=secs2, host_walk_s=hsecs1,
        fused_before=fused0, fused_after=fused1,
        host_walk_after_compaction_s=hsecs2,
        fallbacks=bad_events["scan.resident_fallback"],
        attach_fails=bad_events["scan.resident_attach_fail"])
    print(f"  resident tier: equal to the host walk after both bursts, the "
          f"snapshot before them equal to phase 9; {bad_events}", flush=True)
    del rt
    resident.reset()
    torch.cuda.empty_cache()

    # ---- (d) YCSB-E
    ystore = MVCCStore(engine=engine_mod.NativeEngine(),
                       clock=HLC(ManualClock(1000)), device=dev)
    t0 = time.perf_counter()
    ycsb.load(ystore, YCSB_RECORDS, np.random.default_rng(0))
    yload_s = time.perf_counter() - t0
    ops_s, rows_scanned = ycsb.run_e(ystore, YCSB_OPS, YCSB_RECORDS,
                                     np.random.default_rng(1))
    f0 = np.concatenate([c["f0"] for c in ystore.scan_chunks(
        ycsb.TABLE_ID, ycsb.N_FIELDS, 1 << 17)])
    want_top = np.sort(f0)[::-1][:YCSB_TOPK]
    flow = ycsb.scan_topk_flow(ystore, capacity=1 << 17, k=YCSB_TOPK)
    make_resident(flow)
    topk_s = []
    for label in ("cold", "warm"):
        res, dt, _n_r, _st, _y, _l, _ev = timed_collect(
            torch, stats, _fused_collect(), flow)
        if res["field0"].tolist() != want_top.tolist():
            raise SystemExit(f"ycsb scan_topk_flow {label}: differs from "
                             f"numpy's top {YCSB_TOPK}")
        topk_s.append(dt)
    batcher = ycsb.ScanTopKBatcher.from_store(ystore, capacity=1 << 17,
                                              k=YCSB_MICRO_K)
    n_now = len(f0)
    qrng = np.random.default_rng(7)
    starts = ycsb.fnv_scramble(ycsb.Zipf(n_now, rng=qrng).draw(YCSB_OPS),
                               n_now)
    lens = qrng.integers(1, ycsb.MAX_SCAN_LEN + 1, YCSB_OPS)
    batcher.run(starts[:YCSB_BATCH], lens[:YCSB_BATCH],
                batch_size=YCSB_BATCH)  # warm both paths off the clock
    batcher.run_unbatched(starts[:2], lens[:2])
    batcher.ops_submitted = batcher.slots_dispatched = batcher.dispatches = 0
    t0 = time.perf_counter()
    un_v, un_c = batcher.run_unbatched(starts, lens)
    unbatched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_v, b_c = batcher.run(starts, lens, batch_size=YCSB_BATCH)
    batched_s = time.perf_counter() - t0
    if not (np.array_equal(un_v, b_v) and np.array_equal(un_c, b_c)):
        raise SystemExit("ycsb micro-queries: batched and unbatched differ")
    for i in range(YCSB_OPS):
        sel = f0[starts[i]:starts[i] + lens[i]]
        top = np.sort(sel)[::-1][:YCSB_MICRO_K]
        if b_c[i] != len(sel) or b_v[i, :len(top)].tolist() != top.tolist():
            raise SystemExit(f"ycsb micro-query {i}: differs from numpy")
    print(f"  (d) YCSB-E: load of {YCSB_RECORDS} records (per-row puts) "
          f"{yload_s:.2f} s; run_e {YCSB_OPS} ops at {ops_s:.4g} ops/s on "
          f"the host ({rows_scanned} rows scanned); scan_topk_flow "
          f"(k {YCSB_TOPK}) cold {topk_s[0] * 1e3:.1f} ms, warm "
          f"{topk_s[1] * 1e3:.1f} ms, equal to numpy; {YCSB_OPS} "
          f"micro-queries (k {YCSB_MICRO_K}) one call each "
          f"{YCSB_OPS / unbatched_s:.4g} ops/s, in batches of {YCSB_BATCH} "
          f"{YCSB_OPS / batched_s:.4g} ops/s, bit-identical and equal to "
          f"numpy; occupancy {batcher.occupancy():.4f}", flush=True)
    rec["ycsb_e"] = {"records": YCSB_RECORDS, "load_s": yload_s,
                     "run_e_ops": YCSB_OPS, "run_e_ops_per_s": ops_s,
                     "rows_scanned": rows_scanned,
                     "scan_topk_cold_s": topk_s[0],
                     "scan_topk_warm_s": topk_s[1],
                     "micro_unbatched_ops_per_s": YCSB_OPS / unbatched_s,
                     "micro_batched_ops_per_s": YCSB_OPS / batched_s,
                     "micro_batch": YCSB_BATCH,
                     "occupancy": batcher.occupancy(),
                     "dispatches": batcher.dispatches}
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 12: {rec['seconds']:.1f} s", flush=True)
    return rec, k1


# ----------------------------------------------------------- phase 13

SESSION_TABLES = ("lineitem", "orders", "customer")
# the session tables' primary keys; lineitem and partsupp keep a hidden
# rowid (their TPC-H keys are composite)
SESSION_PKS = {"orders": "o_orderkey", "customer": "c_custkey",
               "part": "p_partkey", "supplier": "s_suppkey",
               "nation": "n_nationkey", "region": "r_regionkey"}
SESSION_QUERIES = ("q1", "q6")
RF1_ORDERS = 1500        # TPC-H 2.5, RF1: SF x 1,500 new orders
RF1_LINES = (1, 7)       # each with 1 to 7 lineitems
INSERT_ROWS = 500        # rows per INSERT statement
POINT_LOOKUPS = 1000
INDEX_ON = ("orders", "o_custkey")
LOOKUP_SQL = ("select o_orderkey, o_totalprice from orders "
              "where o_custkey = {k}")
UPDATE_NATION = 7
DELETE_ABOVE = 149_000
LOGIC_CAPACITY = 128


def session_load(gen, store, tables):
    """Generated TPC-H tables as the tables of a SessionCatalog over
    `store`, written the way a bulk import writes them: each table's rows
    go straight into the engine in the session's row codec (the value
    columns' int64 slots in the schema's order, the primary key in the
    key (SESSION_PKS; else a hidden rowid from 1), then a NULL bitmap of
    0), and a TableDescriptor holding the generator's dictionaries, its
    `next_rowid` and `row_count` is saved. Every column is declared NOT
    NULL, as TPC-H declares them. -> (SessionCatalog, {table: seconds})."""
    from cockroach_tpu_torch.coldata.batch import Kind
    from cockroach_tpu_torch.sql.session import (
        SessionCatalog, TableDescriptor, _type_name,
    )

    cat = SessionCatalog(store)
    secs = {}
    for name in tables:
        t0 = time.perf_counter()
        schema = gen.schema(name)
        table = gen.table(name)
        n = gen.num_rows(name)
        pk = SESSION_PKS.get(name)
        pks = (np.asarray(table[pk], np.int64) if pk
               else np.arange(1, n + 1, dtype=np.int64))
        order = np.argsort(pks, kind="stable")
        slots = {f.name: np.asarray(table[f.name], np.int64)[order]
                 for f in schema if f.name != pk}
        slots["__nulls"] = np.zeros(n, np.int64)
        tid = cat._next_id()
        store.ingest_table(tid, pks[order], slots)
        columns = [(f.name, _type_name(f.type)) for f in schema]
        dicts = {f.name: [str(s) for s in schema.dictionary(f.name)]
                 for f in schema if f.type.kind is Kind.STRING}
        cat.save(TableDescriptor(
            tid, name, columns, pk, dicts=dicts,
            next_rowid=n + 1 if pk is None else 1, row_count=n,
            notnull=[c for c, _ in columns]))
        secs[name] = time.perf_counter() - t0
    return cat, secs


def sql_literal(ty, dictionary, v: int) -> str:
    """One stored value as an INSERT literal of its column's type."""
    from cockroach_tpu_torch.coldata.batch import Kind

    if ty.kind is Kind.STRING:
        return "'" + str(dictionary[v]).replace("'", "''") + "'"
    if ty.kind is Kind.DECIMAL:
        unit = 10 ** ty.scale
        return (f"{'-' if v < 0 else ''}{abs(v) // unit}."
                f"{abs(v) % unit:0{ty.scale}d}")
    if ty.kind is Kind.DATE:
        import datetime

        day = datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
        return f"date '{day.isoformat()}'"
    return str(v)


def insert_statements(gen, name: str, cols: dict) -> list:
    """INSERT statements of at most INSERT_ROWS rows each, for the rows
    `cols` (int64 columns of the table, in its schema's codes)."""
    schema = gen.schema(name)
    fields = [(f.type, schema.dictionary(f.name), cols[f.name].tolist())
              for f in schema]
    n = len(fields[0][2])
    rows = ["(" + ", ".join(sql_literal(ty, d, vals[i])
                            for ty, d, vals in fields) + ")"
            for i in range(n)]
    return [f"insert into {name} values " + ", ".join(rows[a:a + INSERT_ROWS])
            for a in range(0, n, INSERT_ROWS)]


def rf1_rows(gen, rng, n_orders: int, first_key: int):
    """The rows of TPC-H's refresh function RF1 (spec 2.5): `n_orders` new
    orders keyed from `first_key` up, each with RF1_LINES lineitems; every
    other value is drawn with `rng` from the loaded column (so strings
    stay in their dictionaries). -> (orders, lineitem) int64 columns."""
    orders_t, li_t = gen.table("orders"), gen.table("lineitem")
    keys = np.arange(first_key, first_key + n_orders, dtype=np.int64)
    orders = {f.name: (keys if f.name == "o_orderkey" else rng.choice(
        np.asarray(orders_t[f.name], np.int64), n_orders))
        for f in gen.schema("orders")}
    lines = rng.integers(RF1_LINES[0], RF1_LINES[1] + 1, n_orders)
    m = int(lines.sum())
    fixed = {"l_orderkey": np.repeat(keys, lines),
             "l_linenumber": np.concatenate(
                 [np.arange(1, k + 1) for k in lines]).astype(np.int64)}
    li = {f.name: fixed.get(f.name) if f.name in fixed else rng.choice(
        np.asarray(li_t[f.name], np.int64), m)
        for f in gen.schema("lineitem")}
    return orders, li


def parse_corpus(text: str) -> list:
    """A logic-corpus file (tests/testdata/logic/*.txt) as [(kind, sql,
    expected lines)]: the format tests/test_logic.py reads."""
    blocks = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.startswith("statement"):
            kind = "statement_error" if "error" in line else "statement_ok"
            i += 1
            sql = []
            while i < len(lines) and lines[i].strip():
                sql.append(lines[i])
                i += 1
            blocks.append((kind, "\n".join(sql), None))
        elif line.startswith("query"):
            i += 1
            sql = []
            while i < len(lines) and lines[i].strip() != "----":
                sql.append(lines[i])
                i += 1
            i += 1
            expected = []
            while i < len(lines) and lines[i].strip():
                expected.append(lines[i].strip())
                i += 1
            blocks.append(("query", "\n".join(sql), expected))
        else:
            raise SystemExit(f"corpus: bad line {line!r}")
    return blocks


def render_rows(payload, schema) -> list:
    """Result rows as text, as tests/test_logic.py renders them."""
    from cockroach_tpu_torch.cli import decode_column

    cols = []
    for n in [n for n in payload if not n.endswith("__valid")]:
        ty = d = None
        if schema is not None and n in schema.names():
            ty, d = schema.field(n).type, schema.dictionary(n)
        cols.append(decode_column(payload[n], payload.get(n + "__valid"),
                                  ty, d))
    return [" ".join("NULL" if c[r] is None else c[r] for c in cols)
            for r in range(len(cols[0]) if cols else 0)]


def corpus_files() -> list:
    """The logic corpus's files (tests/testdata/logic/*.txt)."""
    import glob

    here = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(here, "tests", "testdata", "logic",
                                          "*.txt")))
    if not paths:
        raise SystemExit("the logic corpus (tests/testdata/logic) is "
                         "missing")
    return paths


def run_corpus_file(path: str, dev) -> int:
    """Every block of one corpus file through a fresh Session over a
    SessionCatalog (PyEngine store) on `dev`, capacity LOGIC_CAPACITY:
    each statement runs or raises as the file says, and each query's
    rendered rows equal its expected lines. A `statement error` block
    expects one of the session's user-facing errors (ParseError,
    BindError, SQLError); any other exception, a device fault among
    them, fails the file. -> the blocks run."""
    from cockroach_tpu_torch.sql.bind import BindError
    from cockroach_tpu_torch.sql.parser import ParseError
    from cockroach_tpu_torch.sql.session import (
        Session, SessionCatalog, SQLError,
    )
    from cockroach_tpu_torch.storage.engine import PyEngine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore
    from cockroach_tpu_torch.util.hlc import HLC, ManualClock

    name = os.path.basename(path)
    store = MVCCStore(engine=PyEngine(), clock=HLC(ManualClock(1000)),
                      device=dev)
    sess = Session(SessionCatalog(store), capacity=LOGIC_CAPACITY,
                   device=dev)
    with open(path) as f:
        blocks = parse_corpus(f.read())
    if not blocks:
        raise SystemExit(f"corpus {name}: no blocks")
    for kind, sql, expected in blocks:
        try:
            k, payload, schema = sess.execute(sql)
        except (ParseError, BindError, SQLError) as e:
            if kind != "statement_error":
                raise SystemExit(f"corpus {name}: {sql!r} raised "
                                 f"{type(e).__name__}: {e}") from e
            continue
        except Exception as e:  # noqa: BLE001 — never a block's answer
            raise SystemExit(f"corpus {name}: {sql!r} raised "
                             f"{type(e).__name__}: {e}") from e
        if kind == "statement_error":
            raise SystemExit(f"corpus {name}: {sql!r} did not raise")
        got = render_rows(payload, schema) if k == "rows" else None
        if kind == "query" and got != expected:
            raise SystemExit(f"corpus {name}: {sql!r} gave {k} {got}, "
                             f"expected {expected}")
        if kind == "statement_ok" and k not in ("ok", "rows"):
            raise SystemExit(f"corpus {name}: {sql!r} gave {k}")
    return len(blocks)


def run_corpus(dev) -> dict:
    """Every corpus file through run_corpus_file on `dev`. -> {file:
    (blocks, seconds)}."""
    out = {}
    for path in corpus_files():
        t0 = time.perf_counter()
        n = run_corpus_file(path, dev)
        out[os.path.basename(path)] = (n, time.perf_counter() - t0)
    return out


def table_digests(columns: dict) -> dict:
    """{column: sha256 of its int64 values}."""
    import hashlib

    return {c: hashlib.sha256(np.ascontiguousarray(
        np.asarray(v, np.int64)).tobytes()).hexdigest()
        for c, v in columns.items()}


def run_phase13(torch, gen, dev, q1_streaming, profile_dir, seed):
    """The storage-backed session at SF 1 on the card: (a) lineitem,
    orders and customer loaded into a SessionCatalog over a native-engine
    MVCCStore (session_load), each read back by a host walk through
    `table_chunks` and held to the generator's columns by digest; (b) the
    SQL Q1 and Q6 through a Session on CUDA with the resident tier on (a
    cold execute and WARM_RUNS prepared hits, each one replay and at
    most one sync; a traced warm Q1 replay runs FUSED_K1 dense_sums);
    (c) RF1's rows (drawn from `seed`) inserted in a transaction: a
    second session's Q1 does not see them, COMMIT makes the next Q1 cold
    (its prepared entry rotated, the resident tier folding the delta) and
    the one after a replay, both equal to the oracle over the union; a
    second batch rolled back leaves Q1 as it was; (d) CREATE INDEX on
    INDEX_ON as a jobs-registry backfill, EXPLAIN naming the index scan,
    POINT_LOOKUPS point lookups equal to numpy, an insert found through
    the index; (e) UPDATE, DELETE, ALTER TABLE ADD COLUMN on customer and
    ANALYZE lineitem, every read after them equal to numpy; (f) the logic
    corpus through sessions on CUDA. -> (JSON record, {K1 path:
    launches})."""
    from cockroach_tpu_torch.server.jobs import Registry
    from cockroach_tpu_torch.sql.session import Session
    from cockroach_tpu_torch.storage import resident
    from cockroach_tpu_torch.storage.engine import NativeEngine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore, encode_key
    from cockroach_tpu_torch.util.hlc import HLC
    from cockroach_tpu_torch.util.settings import Settings
    from cockroach_tpu_torch.workload import tpch_queries as tq

    t_phase = time.perf_counter()
    rec: dict = {"card": card_line(), "seed": seed}
    k1: dict = {}
    rng = np.random.default_rng(seed)
    settings = Settings()
    prev_resident = settings.get(resident.RESIDENT_SCAN)
    print(f"[13] the storage-backed session: SF {SF}, capacity {CAPACITY}, "
          f"{', '.join(SESSION_TABLES)} in a SessionCatalog on {dev}",
          flush=True)

    part_s: dict = {}
    rec["part_s"] = part_s
    t_part = time.perf_counter()

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        part_s[label] = now - t_part
        t_part = now

    # ---- (a) the load, and a host walk of each table
    store = MVCCStore(engine=NativeEngine(), clock=HLC(), device=dev)
    cat, load_s = session_load(gen, store, SESSION_TABLES)
    walk_s = {}
    for name in SESSION_TABLES:
        table = gen.table(name)
        pk = SESSION_PKS.get(name)
        order = (np.argsort(np.asarray(table[pk]), kind="stable") if pk
                 else slice(None))
        t0 = time.perf_counter()
        chunks = list(cat.table_chunks(name, CAPACITY)())
        walk_s[name] = time.perf_counter() - t0
        got = table_digests({f.name: np.concatenate([c[f.name]
                                                      for c in chunks])
                             for f in gen.schema(name)})
        want = table_digests({f.name: np.asarray(table[f.name])[order]
                              for f in gen.schema(name)})
        if got != want:
            bad = sorted(c for c in want if got[c] != want[c])
            raise SystemExit(f"session table {name}: the host walk differs "
                             f"from the generator in {bad}")
        del chunks
    rows = {n: gen.num_rows(n) for n in SESSION_TABLES}
    print(f"  (a) loaded {rows} rows in "
          f"{ {n: round(s, 2) for n, s in load_s.items()} } s; host walks "
          f"{ {n: round(s, 2) for n, s in walk_s.items()} } s, every "
          f"column's digest equal to the generator's", flush=True)
    rec["load_s"], rec["host_walk_s"], rec["rows"] = load_s, walk_s, rows
    part_done("a")

    # ---- (b) SQL Q1 and Q6 over the session tables, on CUDA
    settings.set(resident.RESIDENT_SCAN, True)
    session = Session(cat, capacity=CAPACITY, device=dev)
    rf_names = gen.schema("lineitem").dicts["l_returnflag"]
    ls_names = gen.schema("lineitem").dicts["l_linestatus"]
    oracles = {"q1": tq.q1_oracle(gen), "q6": query_oracle("q6", gen)}
    trace_dir = profile_dir or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "phase13_traces")
    os.makedirs(trace_dir, exist_ok=True)

    def check(name, label, res, oracle=None):
        oracle = oracle or oracles[name]
        if name == "q1":
            check_q1(res, oracle, rf_names, ls_names)
            if oracle is oracles["q1"]:
                for c in q1_streaming:
                    if c in res and not np.array_equal(
                            np.asarray(res[c]), np.asarray(q1_streaming[c])):
                        raise SystemExit(f"session q1 {label}: differs from "
                                         f"phase 9 in {c}")
            return
        got = sql_rows(name, res)
        if got != oracle or got != STREAMING_ROWS[name]:
            raise SystemExit(f"session {name} {label}: {got[:3]} differs "
                             f"from its oracle or phase 9's rows")

    def warm_runs(sess, name, label, oracle=None):
        text = sql_text(name)
        times, syncs = [], []
        for i in range(WARM_RUNS):
            res, dt, n_sync, ev, parses, _l = session_run(torch, sess, text)
            check(name, f"{label} warm {i + 1}", res, oracle)
            check_warm_hit(f"session {name} {label} warm {i + 1}",
                           sess._prepared[text].op._fused_runner, ev,
                           parses, n_sync)
            times.append(dt)
            syncs.append(n_sync)
        return times, syncs

    def traced_k1(sess, stem):
        reading = traced_replay_reading(torch, sess, sql_text("q1"),
                                        os.path.join(trace_dir, stem))
        if reading["dense_sums"] != FUSED_K1["q1"] or \
                reading["mode"] != WARM_MODE:
            raise SystemExit(f"{stem}: {reading}, expected a replay with "
                             f"{FUSED_K1['q1']} dense_sums kernel")
        return reading

    rec["sql"] = {}
    li_tid = cat.desc("lineitem").table_id
    for name in SESSION_QUERIES:
        secs: dict = {}
        res, cold, cold_y, ev, _p, _l = session_run(
            torch, session, sql_text(name), seconds=secs)
        check(name, "cold", res)
        warm, syncs = warm_runs(session, name, "")
        rec["sql"][name] = {
            "cold_s": cold, "cold_syncs": cold_y,
            "cold_restarts": ev.get("flow.restart", 0),
            "warm_s": warm, "warm_median_s": statistics.median(warm),
            "warm_syncs": syncs,
            "cold_host_ms": {n: s * 1e3 for n, s in secs.items()
                             if n.startswith("scan.")}}
        print(f"  (b) session {name}: cold {cold * 1e3:.1f} ms (host ms "
              f"{ {n: round(v, 1) for n, v in rec['sql'][name]['cold_host_ms'].items()} }), "
              f"warm median {statistics.median(warm) * 1e3:.3f} ms "
              f"{[round(w * 1e3, 3) for w in warm]}, syncs {syncs}; equal "
              f"to the oracle and phase 9", flush=True)
    if resident.lookup(store, li_tid) is None:
        raise SystemExit("session lineitem: the resident tier did not "
                         "attach")
    reading = traced_k1(session, "q1_session")
    k1["q1_session"] = reading["dense_sums"]
    rec["q1_traced"] = reading
    part_done("b")

    # ---- (c) RF1 in a transaction
    o_tab = gen.table("orders")
    first_key = int(np.asarray(o_tab["o_orderkey"]).max()) + 1
    n_new = int(SF * RF1_ORDERS)
    new_o, new_li = rf1_rows(gen, rng, n_new, first_key)
    stmts = (insert_statements(gen, "orders", new_o)
             + insert_statements(gen, "lineitem", new_li))
    union_q1 = tq.q1_oracle_columnar(gen, [gen.table("lineitem"), new_li])
    reader = Session(cat, capacity=CAPACITY, device=dev)
    t0 = time.perf_counter()
    session.execute("begin")
    for s in stmts:
        if session.execute(s)[0] != "ok":
            raise SystemExit("RF1: an INSERT did not run")
    insert_s = time.perf_counter() - t0
    res, _dt, n_sync, ev, parses, _l = session_run(torch, reader,
                                                   sql_text("q1"))
    check("q1", "second session during the transaction", res)
    check_warm_hit("second session's Q1 during the transaction",
                   reader._prepared[sql_text("q1")].op._fused_runner, ev,
                   parses, n_sync)
    t0 = time.perf_counter()
    if session.execute("commit")[1] != "COMMIT":
        raise SystemExit("RF1: COMMIT did not commit")
    commit_s = time.perf_counter() - t0
    secs = {}
    res, after_cold, _y, ev, _p, _l = session_run(torch, session,
                                                  sql_text("q1"),
                                                  seconds=secs)
    check("q1", "after the commit", res, union_q1)
    if ev.get("sql.prepared_hit") or "scan.resident_fold" not in ev:
        raise SystemExit(f"Q1 after the commit: {ev}; expected a rebuilt "
                         f"plan over a folded resident image")
    after_warm, after_syncs = warm_runs(session, "q1", "after the commit",
                                        union_q1)
    reading = traced_k1(session, "q1_session_after_write")
    k1["q1_session_after_write"] = reading["dense_sums"]
    # a second batch rolled back
    rb_o, rb_li = rf1_rows(gen, rng, n_new, first_key + n_new)
    session.execute("begin")
    for s in (insert_statements(gen, "orders", rb_o)
              + insert_statements(gen, "lineitem", rb_li)):
        session.execute(s)
    if session.execute("rollback")[1] != "ROLLBACK":
        raise SystemExit("RF1: ROLLBACK did not roll back")
    res, _dt, n_sync, ev, parses, _l = session_run(torch, session,
                                                   sql_text("q1"))
    check("q1", "after the rollback", res, union_q1)
    check_warm_hit("Q1 after the rollback",
                   session._prepared[sql_text("q1")].op._fused_runner, ev,
                   parses, n_sync)
    rec["rf1"] = {
        "orders": n_new, "lineitems": len(new_li["l_orderkey"]),
        "statements": len(stmts), "insert_s": insert_s,
        "commit_s": commit_s, "q1_after_cold_s": after_cold,
        "q1_after_fold_ms": secs.get("scan.resident_fold", 0.0) * 1e3,
        "q1_after_warm_s": after_warm, "q1_after_warm_syncs": after_syncs,
        "q1_after_traced": reading}
    print(f"  (c) RF1: {n_new} orders and {len(new_li['l_orderkey'])} "
          f"lineitems in {len(stmts)} INSERTs in a transaction "
          f"{insert_s:.2f} s, COMMIT {commit_s:.2f} s; a second session's "
          f"Q1 before it a replay of the old rows; Q1 after it cold "
          f"{after_cold * 1e3:.1f} ms (fold "
          f"{rec['rf1']['q1_after_fold_ms']:.1f} ms), warm "
          f"{[round(w * 1e3, 3) for w in after_warm]} ms, equal to the "
          f"oracle over the union, K1 {reading['dense_sums']} a replay; a "
          f"rolled-back batch left Q1 as it was", flush=True)
    part_done("c")

    # ---- (d) a secondary index and point lookups through it
    itable, icol = INDEX_ON
    t0 = time.perf_counter()
    session.execute(f"create index {icol}_idx on {itable} ({icol})")
    index_s = time.perf_counter() - t0
    jobs = [r for r in Registry(store).list_jobs()
            if r.kind == "index_backfill"]
    idx_id = cat.desc(itable).indexes[icol]
    entries, start = 0, encode_key(idx_id, 0)
    while True:
        res = store.engine.scan_to_cols(start, encode_key(idx_id + 1, 0),
                                        store.clock.now(), 2, CAPACITY)
        entries += res.rows
        if not res.more:
            break
        start = res.resume_key
    o_all = {c: np.concatenate([np.asarray(o_tab[c], np.int64), new_o[c]])
             for c in ("o_orderkey", "o_custkey", "o_totalprice")}
    if (len(jobs) != 1 or jobs[0].state != "succeeded"
            or entries != len(o_all["o_orderkey"])):
        raise SystemExit(f"CREATE INDEX: jobs {jobs}, {entries} entries for "
                         f"{len(o_all['o_orderkey'])} rows")
    _k, lines, _s = session.execute("explain " + LOOKUP_SQL.format(k=1))
    if not any(f"index scan {itable}@{icol}" in ln for ln in lines):
        raise SystemExit(f"EXPLAIN of a lookup: {lines}")
    order = np.argsort(o_all["o_custkey"], kind="stable")
    by_cust = {c: o_all[c][order] for c in o_all}
    n_cust = gen.num_rows("customer")

    def lookup_oracle(k):
        lo, hi = np.searchsorted(by_cust["o_custkey"], [k, k + 1])
        return sorted(zip(by_cust["o_orderkey"][lo:hi].tolist(),
                          by_cust["o_totalprice"][lo:hi].tolist()))

    def lookup(k, label):
        kind, res, _s = session.execute(LOOKUP_SQL.format(k=k))
        got = sorted(zip(np.asarray(res["o_orderkey"]).tolist(),
                         np.asarray(res["o_totalprice"]).tolist()))
        if kind != "rows" or got != lookup_oracle(k):
            raise SystemExit(f"{label} o_custkey = {k}: {got} differs from "
                             f"numpy's {lookup_oracle(k)}")
        return len(got)

    keys = rng.integers(1, n_cust + 1, POINT_LOOKUPS)
    t0 = time.perf_counter()
    found = sum(lookup(int(k), "point lookup") for k in keys)
    lookups_s = time.perf_counter() - t0
    # a row written after the backfill is found through the index
    extra_key = first_key + 2 * n_new
    k0 = int(keys[0])
    row = {c: np.asarray([v], np.int64) for c, v in {
        **{c: new_o[c][0] for c in new_o}, "o_orderkey": extra_key,
        "o_custkey": k0}.items()}
    session.execute(insert_statements(gen, "orders", row)[0])
    for c in o_all:
        by_cust[c] = np.concatenate([by_cust[c], row[c]])
    order = np.argsort(by_cust["o_custkey"], kind="stable")
    by_cust = {c: v[order] for c, v in by_cust.items()}
    lookup(k0, "after an insert")
    rec["index"] = {"table": itable, "column": icol, "entries": entries,
                    "backfill_s": index_s,
                    "checkpoint_start_pk": int(jobs[0].progress.get(
                        "start_pk", 0)),
                    "lookups": POINT_LOOKUPS, "rows_found": found,
                    "lookups_s": lookups_s,
                    "lookups_per_s": POINT_LOOKUPS / lookups_s}
    print(f"  (d) CREATE INDEX on {itable} ({icol}): {entries} entries "
          f"backfilled as a jobs-registry job in {index_s:.2f} s; EXPLAIN "
          f"names the index scan; {POINT_LOOKUPS} point lookups ({found} "
          f"rows) at {POINT_LOOKUPS / lookups_s:.1f} lookups/s, each equal "
          f"to numpy; an insert after the backfill found through the "
          f"index", flush=True)
    part_done("d")

    # ---- (e) UPDATE, DELETE, ALTER TABLE on customer; ANALYZE lineitem
    c_tab = gen.table("customer")
    c_key = np.asarray(c_tab["c_custkey"], np.int64)
    c_nat = np.asarray(c_tab["c_nationkey"], np.int64)
    c_bal = np.asarray(c_tab["c_acctbal"], np.int64).copy()
    dml = {}

    def timed(sql):
        t0 = time.perf_counter()
        out = session.execute(sql)
        return out, time.perf_counter() - t0

    def read_customer(label, keep):
        _k, res, _s = session.execute("select c_custkey, c_nationkey, "
                                      "c_acctbal from customer")
        order = np.argsort(np.asarray(res["c_custkey"]))
        for c, want in (("c_custkey", c_key), ("c_nationkey", c_nat),
                        ("c_acctbal", c_bal)):
            if not np.array_equal(np.asarray(res[c])[order], want[keep]):
                raise SystemExit(f"customer after {label}: {c} differs "
                                 f"from numpy")

    out, dml["update_s"] = timed(f"update customer set c_acctbal = "
                                 f"c_acctbal + 1 where c_nationkey = "
                                 f"{UPDATE_NATION}")
    hit = c_nat == UPDATE_NATION
    c_bal[hit] += 100  # decimal(2): 1 is 100 hundredths
    if out[1] != f"UPDATE {int(hit.sum())}":
        raise SystemExit(f"UPDATE: {out[1]}, expected {int(hit.sum())} rows")
    read_customer("the update", slice(None))
    out, dml["delete_s"] = timed(f"delete from customer where c_custkey > "
                                 f"{DELETE_ABOVE}")
    keep = c_key <= DELETE_ABOVE
    if out[1] != f"DELETE {int((~keep).sum())}":
        raise SystemExit(f"DELETE: {out[1]}")
    read_customer("the delete", keep)
    out, dml["alter_s"] = timed("alter table customer add column c_flag int")
    _k, res, _s = session.execute("select count(c_flag) as n_flag, "
                                  "count(*) as n from customer")
    if (int(res["n_flag"][0]), int(res["n"][0])) != (0, int(keep.sum())):
        raise SystemExit(f"ALTER TABLE ADD COLUMN: {res}")
    out, dml["analyze_s"] = timed("analyze lineitem")
    n_li = gen.num_rows("lineitem") + len(new_li["l_orderkey"])
    if out[1] != f"ANALYZE {n_li} rows":
        raise SystemExit(f"ANALYZE: {out[1]}, expected {n_li} rows")
    rec["dml"] = dml
    print(f"  (e) customer: UPDATE of {int(hit.sum())} rows "
          f"{dml['update_s']:.2f} s, DELETE of {int((~keep).sum())} rows "
          f"{dml['delete_s']:.2f} s, ALTER TABLE ADD COLUMN (backfill of "
          f"{int(keep.sum())} rows) {dml['alter_s']:.2f} s, each read "
          f"after them equal to numpy; ANALYZE lineitem ({n_li} rows) "
          f"{dml['analyze_s']:.2f} s", flush=True)
    settings.set(resident.RESIDENT_SCAN, prev_resident)
    del session, reader
    resident.reset()
    torch.cuda.empty_cache()
    part_done("e")

    # ---- (f) the logic corpus on CUDA
    t0 = time.perf_counter()
    corpus = run_corpus(dev)
    corpus_s = time.perf_counter() - t0
    blocks = sum(b for b, _s in corpus.values())
    slow = sorted(corpus.items(), key=lambda kv: -kv[1][1])[:3]
    print(f"  (f) the logic corpus: {len(corpus)} files, {blocks} blocks, "
          f"every one as expected, on {dev} in {corpus_s:.1f} s (slowest "
          f"{[(n, round(s, 2)) for n, (_b, s) in slow]})", flush=True)
    rec["corpus"] = {"files": len(corpus), "blocks": blocks,
                     "seconds": corpus_s}
    part_done("f")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 13: {rec['seconds']:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in part_s.items()} }", flush=True)
    return rec, k1


# ----------------------------------------------------------- phase 14

STATEMENT_TIMEOUT_S = 0.1
CHAOS_PROB = 0.3
CHAOS_Q1_POINTS = ("scan.transfer", "scan.stack", "fused.compile",
                   "fused.exec", "cache.insert")
CHAOS_JOIN_POINTS = ("scan.transfer", "fused.exec")
ADMISSION_THREADS = 4
ADMISSION_RUNS = 3
DELAY_S = 0.3            # the armed delay fault of (f)
LEAK_BYTES = 64 << 20    # device memory a cancelled statement may leave
BUNDLE_MEMBERS = ["digest.json", "operators.json", "plan.txt", "stmt.sql",
                  "trace.json", "trace.txt"]
RESIDENT_PLANT_ROWS = 20_000


def prefetch_threads() -> list:
    """The scan prefetch producers alive (exec/operators.py _prefetch)."""
    import threading

    return [t for t in threading.enumerate()
            if "produce_tracked" in t.name and t.is_alive()]


def firing_seed(start: int, p: float) -> int:
    """The first seed from `start` whose fault registry fires on a
    point's first pass at probability `p` (util/fault.py draws one
    random() per pass), so that every chaos case shows its point
    firing; later passes draw as the seed goes."""
    import random

    seed = start
    while random.Random(seed).random() >= p:
        seed += 1
    return seed


def delayed_retryable(delay: float):
    """A fault factory: each fire stalls the statement's thread `delay`
    seconds, then is a transient error (one in-place retry)."""

    def make():
        time.sleep(delay)
        return ConnectionError("transfer failed")

    return make


def bit_equal_results(label: str, want: dict, got: dict) -> None:
    """Bit-for-bit equality of two collect results (equal_results
    compares values, where -0.0 equals 0.0)."""
    if list(got) != list(want):
        raise SystemExit(f"{label}: columns {list(got)} != {list(want)}")
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        if a.dtype == object or b.dtype == object:
            same = a.shape == b.shape and list(a) == list(b)
        else:
            same = (a.dtype == b.dtype and a.shape == b.shape
                    and a.tobytes() == b.tobytes())
        if not same:
            raise SystemExit(f"{label}: column {k} differs from the "
                             f"fault-free run")


def resident_plants(torch, dev) -> dict:
    """Queue 3's open check on the card: a RuntimeError planted in the
    resident tier's visibility pass or fold, read through the
    `scan.resident` seam, propagates and leaves the table attached; an
    out-of-memory there falls back to the host walk and detaches it."""
    from cockroach_tpu_torch.ops import mvcc_filter as mf
    from cockroach_tpu_torch.storage import resident
    from cockroach_tpu_torch.storage.engine import open_engine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore
    from cockroach_tpu_torch.util.hlc import HLC, ManualClock, Timestamp

    tid, n = 3, RESIDENT_PLANT_ROWS
    out = {}
    for pass_name in ("visible_image", "fold_versions"):
        for exc, msg, falls_back in (
                (RuntimeError, "planted pass failure", False),
                (torch.cuda.OutOfMemoryError, "CUDA out of memory (planted)",
                 True)):
            resident.reset()
            store = MVCCStore(engine=open_engine(),
                              clock=HLC(ManualClock(1000)), device=dev)
            for pk in range(n):
                store.put(tid, pk, [pk, 0], ts=Timestamp(100, 0))
            if not store.make_resident(tid, 2):
                raise SystemExit("resident plant: the table did not attach")
            rt = resident.lookup(store, tid)
            store.put(tid, n + 1, [n + 1, 0], ts=Timestamp(150, 0))
            want = list(range(n)) + [n + 1]
            real = getattr(mf, pass_name)

            def planted(*a, **kw):
                raise exc(msg)

            def rows():
                chunks = list(store.scan_chunks(tid, 2, 1 << 16,
                                                ts=Timestamp(200, 0)))
                return np.concatenate([c["f0"] for c in chunks]).tolist()

            from cockroach_tpu_torch.exec import stats

            setattr(mf, pass_name, planted)
            try:
                with stats.query_stats() as col:
                    try:
                        got = rows()
                        raised = None
                    except Exception as e:  # noqa: BLE001
                        got, raised = None, e
            finally:
                setattr(mf, pass_name, real)
            attached = resident.lookup(store, tid) is rt
            fallbacks = col.stages["scan.resident_fallback"].events \
                if "scan.resident_fallback" in col.stages else 0
            if falls_back:
                ok = (raised is None and got == want and not attached
                      and fallbacks == 1)
            else:
                ok = (isinstance(raised, exc) and msg in str(raised)
                      and attached and rows() == want)
            label = f"{pass_name}/{exc.__name__}"
            if not ok:
                raise SystemExit(f"resident plant {label}: raised "
                                 f"{raised!r}, attached {attached}, "
                                 f"fallbacks {fallbacks}")
            out[label] = {"propagated": raised is not None,
                          "attached": attached, "fallbacks": fallbacks}
            resident.reset()
    return out


def run_phase14(torch, gen, dev, records11, profile_dir):
    """The lifecycle seams at SF 1 on CUDA, through Sessions over phase
    11's TPC-H catalog (the scan-image cache holds its images), every
    reading held to its oracle: (a) SQL Q1 cold and WARM_RUNS prepared
    hits with `sql.trace.enabled` off and on (its default): each hit one
    replay and at most one sync, K1 once in a traced replay, the
    session's own cost beside phase 11's, the root span's tree; (b)
    EXPLAIN ANALYZE of Q1 and Q3 (span tree, digest, operators) and
    EXPLAIN ANALYZE (DEBUG)'s bundle, read back; (c) statement_timeout
    0.1 s over the window query of all of lineitem (57014, the deadline
    to the raise, the session's next Q1, no prefetch thread, device
    memory back within LEAK_BYTES); (d) the same statement in a thread,
    listed by another session's SHOW QUERIES and cancelled by its CANCEL
    QUERY (57014, the latency); (e) session admission (53300 with the
    control heads passing) and flow admission at 2 slots under 4 threads
    of Q1; (g) chaos on the card (Q1 under five points, Q3 and Q18 under
    two, at probability 0.3, seeded; a forced fused out-of-memory) and
    the resident passes' planted faults; (f) crdb_internal.node_metrics,
    an insight and a slow-query log line for a statement slowed by an
    armed delay fault. -> (the JSON record, K1's launches per traced
    session replay)."""
    import threading
    import zipfile
    from collections import OrderedDict

    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.exec.operators import collect
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
    from cockroach_tpu_torch.exec.spill import host_spill_monitor
    from cockroach_tpu_torch.server.registry import default_query_registry
    from cockroach_tpu_torch.sql.insights import default_insights
    from cockroach_tpu_torch.sql.session import (
        SLOW_QUERY_LATENCY, STATEMENT_TIMEOUT, Session, SQLError,
    )
    from cockroach_tpu_torch.sql.sqlstats import fingerprint
    from cockroach_tpu_torch.util import admission, circuit, tracing
    from cockroach_tpu_torch.util import log as ulog
    from cockroach_tpu_torch.util.fault import registry as faults
    from cockroach_tpu_torch.util.metric import default_registry
    from cockroach_tpu_torch.util.settings import Settings
    from cockroach_tpu_torch.workload import tpch_queries as tq

    print(f"[14] the lifecycle seams: SF {SF}, capacity {CAPACITY}, "
          f"Sessions over the TPC-H catalog on {dev}", flush=True)
    t_phase = time.perf_counter()
    st = Settings()
    metrics = default_registry()
    qreg = default_query_registry()
    cat = pregenerated_catalog(gen)
    # the sessions of this catalog share one prepared cache, so one
    # operator tree and one fused runner, whose lock serializes replays
    cat.shared_prepared = (OrderedDict(), threading.Lock())
    session = Session(cat, capacity=CAPACITY, device=dev)
    rf_names = gen.schema("lineitem").dicts["l_returnflag"]
    ls_names = gen.schema("lineitem").dicts["l_linestatus"]
    q1_oracle = tq.q1_oracle(gen)
    q1 = sql_text("q1")
    trace_dir = profile_dir or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "phase14_traces")
    os.makedirs(trace_dir, exist_ok=True)
    rec: dict = {"card": card_line()}

    def counter(name):
        return metrics.counter(name).value()

    start = {n: counter(n) for n in (
        "sql_resilience_retries_total", "sql_resilience_degradations_total",
        "sql_flow_restarts_total")}

    # ---- (a) seams at their defaults, tracing off and on
    res, cold, _y, _e, _p, _l = session_run(torch, session, q1)
    check_q1(res, q1_oracle, rf_names, ls_names)
    k1_traced = []
    rec["a"] = {"cold_s": cold}
    for label, on in (("trace_off", False), ("trace_on", True)):
        st.set(tracing.TRACE_ENABLED, on)
        warm, syncs = [], []
        for i in range(WARM_RUNS):
            res, dt, n_sync, ev, parses, launches = session_run(
                torch, session, q1)
            check_q1(res, q1_oracle, rf_names, ls_names)
            check_warm_hit(f"[14] q1 {label} warm {i + 1}",
                           session._prepared[q1].op._fused_runner, ev,
                           parses, n_sync)
            if launches.get("dense_sums") != FUSED_K1["q1"]:
                raise SystemExit(f"[14] q1 {label}: launches {launches}")
            warm.append(dt)
            syncs.append(n_sync)
        op = session._prepared[q1].op
        direct = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            collect(op, device=dev)
            direct.append(time.perf_counter() - t0)
        reading = traced_replay_reading(
            torch, session, q1, os.path.join(trace_dir, f"q1_{label}"))
        if reading["dense_sums"] != FUSED_K1["q1"] or \
                reading["mode"] != WARM_MODE:
            raise SystemExit(f"[14] q1 {label}: traced replay {reading}")
        k1_traced.append(reading["dense_sums"])
        own = statistics.median(warm) - statistics.median(direct)
        p11 = records11["q1"]["warm_s"] - records11["q1"]["direct_s"]
        print(f"  (a) q1 {label}: warm median "
              f"{statistics.median(warm) * 1e3:.3f} ms of "
              f"{[round(w * 1e3, 3) for w in warm]}, syncs {syncs}; direct "
              f"collect {statistics.median(direct) * 1e3:.3f} ms; the "
              f"session's own cost {own * 1e3:.3f} ms (phase 11, this run: "
              f"{p11 * 1e3:.3f} ms); traced replay dense_sums "
              f"{reading['dense_sums']}, mode {reading['mode']}",
              flush=True)
        rec["a"][label] = {"warm_s": warm, "direct_s": direct,
                           "own_cost_s": own, "phase11_own_cost_s": p11,
                           "syncs": syncs, "k1_traced": reading}
    # the root span of one warm execute (tracing on, its default)
    with tracing.tracer().span("phase14") as outer:
        session.execute(q1)
    root = outer.children[0]
    names = [s.name for s in root.walk()]
    if root.name != "session.execute" or "flow.fused" not in names or \
            "fused.exec" not in names or outer.tags.get("tier") != "fused":
        raise SystemExit(f"[14] the warm execute's span tree: {names}, "
                         f"root tags {outer.tags}")
    print("  (a) the root span of a warm execute:")
    for ln in root.render().splitlines():
        print(f"    {ln}")
    rec["a"]["span_names"] = names

    # ---- (b) EXPLAIN ANALYZE and the statement bundle
    for name in ("q1", "q3"):
        kind, lines, _ = session.execute("explain analyze " + sql_text(name))
        text = "\n".join(lines)
        need = ("query:", "flow.fused", "fused.exec", "operators:",
                "resilience: tier=fused")
        missing = [n for n in need if n not in text]
        if kind != "explain" or missing:
            raise SystemExit(f"[14] explain analyze {name}: missing "
                             f"{missing}: {lines}")
        print(f"  (b) EXPLAIN ANALYZE {name}:")
        for ln in lines:
            print(f"    {ln}")
    kind, lines, _ = session.execute("explain analyze (debug) " + q1)
    path = lines[-1].split(": ", 1)[1]
    with zipfile.ZipFile(path) as zf:
        members = sorted(zf.namelist())
        digest = json.loads(zf.read("digest.json"))
        trace = json.loads(zf.read("trace.json"))
    os.remove(path)
    if members != BUNDLE_MEMBERS or digest.get("tier") != "fused" or \
            trace.get("name") != "query":
        raise SystemExit(f"[14] statement bundle: {members}, digest "
                         f"{digest}, trace root {trace.get('name')}")
    print(f"  (b) EXPLAIN ANALYZE (DEBUG) q1: bundle {members}, digest "
          f"{digest}", flush=True)
    rec["b"] = {"bundle": members, "digest": digest}

    # ---- (c) statement_timeout over the window query of all of lineitem
    wsql = WINDOW_SQL_ALL
    session.execute(wsql)  # cold: the fused tracer declines it
    t0 = time.perf_counter()
    session.execute(wsql)
    window_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    # the cluster default, not SET: a SET clears the prepared cache, and
    # the next Q1 must be a replay of the kept tree
    st.set(STATEMENT_TIMEOUT, STATEMENT_TIMEOUT_S)
    t0 = time.perf_counter()
    try:
        session.execute(wsql)
        raise SystemExit("[14] (c): the window query outran its "
                         "statement_timeout without 57014")
    except SQLError as e:
        if e.pgcode != "57014":
            raise
    finally:
        st.set(STATEMENT_TIMEOUT, 0.0)
    timeout_latency = time.perf_counter() - (t0 + STATEMENT_TIMEOUT_S)
    torch.cuda.synchronize()
    leak = torch.cuda.memory_allocated(dev) - mem_before
    alive = prefetch_threads()
    if alive or leak > LEAK_BYTES or qreg.query_count() \
            or host_spill_monitor().used:
        raise SystemExit(f"[14] (c): after 57014: prefetch threads {alive}, "
                         f"device memory {leak} bytes over, registry "
                         f"{qreg.query_count()}, host spill "
                         f"{host_spill_monitor().used}")
    res, _dt, n_sync, ev, parses, _l = session_run(torch, session, q1)
    check_q1(res, q1_oracle, rf_names, ls_names)
    check_warm_hit("[14] (c) q1 after 57014",
                   session._prepared[q1].op._fused_runner, ev, parses,
                   n_sync)
    print(f"  (c) statement_timeout {STATEMENT_TIMEOUT_S} s over the window "
          f"query (warm {window_s * 1e3:.1f} ms): 57014 "
          f"{timeout_latency * 1e3:.1f} ms after the deadline; then q1 a "
          f"replay with {n_sync} sync, equal rows; prefetch threads 0; "
          f"device memory {leak} bytes from before", flush=True)
    rec["c"] = {"window_warm_s": window_s,
                "deadline_to_raise_s": timeout_latency,
                "device_bytes_after": leak}

    # ---- (d) SHOW QUERIES and CANCEL QUERY from a second session
    other = Session(cat, capacity=CAPACITY, device=dev)
    box: dict = {}

    def long_statement():
        try:
            session.execute(wsql)
            box["err"] = None
        except SQLError as e:
            box["err"], box["t_raise"] = e.pgcode, time.perf_counter()
        except BaseException as e:  # noqa: BLE001
            box["err"] = repr(e)

    th = threading.Thread(target=long_statement)
    th.start()
    qid, listed, deadline = None, None, time.monotonic() + 60
    while qid is None and time.monotonic() < deadline and th.is_alive():
        _, q, _ = other.execute("show queries")
        for i, s, ph in zip(q["query_id"], q["sql"], q["phase"]):
            if s == wsql[:200] and ph == "executing":
                qid, listed = int(i), list(zip(q["sql"], q["phase"]))
        if qid is None:
            time.sleep(0.005)
    if qid is None:
        th.join(60)
        raise SystemExit(f"[14] (d): SHOW QUERIES never listed the "
                         f"statement executing ({box})")
    t_cancel = time.perf_counter()
    other.execute(f"cancel query {qid}")
    th.join(120)
    if th.is_alive() or box.get("err") != "57014":
        raise SystemExit(f"[14] (d): CANCEL QUERY gave {box}")
    cancel_latency = box["t_raise"] - t_cancel
    _, q, _ = other.execute("show queries")
    rest = [s for s in q["sql"] if s != "show queries"]
    if rest or prefetch_threads():
        raise SystemExit(f"[14] (d): after the cancel SHOW QUERIES lists "
                         f"{rest}, prefetch threads {prefetch_threads()}")
    print(f"  (d) SHOW QUERIES listed query {qid} executing; CANCEL QUERY "
          f"-> 57014 in the first session {cancel_latency * 1e3:.1f} ms "
          f"later; SHOW QUERIES afterwards lists only itself", flush=True)
    rec["d"] = {"cancel_latency_s": cancel_latency, "query_id": qid}

    # ---- (e) admission
    st.set(admission.SESSION_SLOTS, 1)
    st.set(admission.SESSION_QUEUE_TIMEOUT, 0.05)
    sq = admission.session_queue()
    sq.acquire()
    try:
        session.execute("set statement_timeout = 0")
        session.execute("show statement_timeout")
        try:
            session.execute(q1)
            raise SystemExit("[14] (e): a work statement ran with the only "
                             "session slot held")
        except SQLError as e:
            if e.pgcode != "53300":
                raise
    finally:
        sq.release()
        st.set(admission.SESSION_SLOTS, 0)
    if sq.used.value() or sq.waiting.value():
        raise SystemExit("[14] (e): a session slot leaked")
    session.execute("set admission_slots = 2")
    # a SET clears the shared prepared cache: one execute keeps the tree
    # (and captures its graph) before the threads, so that they all
    # replay one graph under its runner's lock
    session.execute(q1)
    fq = admission.flow_queue()
    sessions = [Session(cat, capacity=CAPACITY, device=dev)
                for _ in range(ADMISSION_THREADS)]
    errors, peak, done = [], [0], threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], int(fq.used.value()))
            time.sleep(0.0002)

    def worker(s):
        try:
            for _ in range(ADMISSION_RUNS):
                _k, res, _s = s.execute(q1)
                check_q1(res, q1_oracle, rf_names, ls_names)
        except BaseException as e:  # noqa: BLE001
            errors.append(repr(e))

    sampler = threading.Thread(target=sample)
    sampler.start()
    t0 = time.perf_counter()
    workers = [threading.Thread(target=worker, args=(s,)) for s in sessions]
    for w in workers:
        w.start()
    for w in workers:
        w.join(120)
    adm_s = time.perf_counter() - t0
    done.set()
    sampler.join()
    session.execute("set admission_slots = 0")
    if errors or peak[0] > 2 or fq.used.value() or any(
            w.is_alive() for w in workers):
        raise SystemExit(f"[14] (e): errors {errors}, flow slots peak "
                         f"{peak[0]}, held {fq.used.value()}")
    print(f"  (e) session admission: 53300 with the only slot held, SET "
          f"and SHOW passed; flow admission at 2 slots: "
          f"{ADMISSION_THREADS} threads x {ADMISSION_RUNS} q1, every result "
          f"equal to the oracle, slots used peak {peak[0]}, "
          f"{adm_s:.2f} s", flush=True)
    rec["e"] = {"flow_slots_peak": peak[0], "threads_s": adm_s}

    # ---- (g) chaos on the card, seeded; the images held aside
    cached = scan_image_cache().snapshot()
    builders = {"q1": lambda: tq.q1(gen, CAPACITY, catalog=cat),
                "q3": lambda: tq.q3(gen, CAPACITY, catalog=cat),
                "q18": lambda: tq.q18(gen, Q18_THRESHOLD, CAPACITY,
                                      catalog=cat)}

    def fresh(name):
        scan_image_cache().clear()
        flow = builders[name]()
        make_resident(flow)
        return flow

    chaos = {}
    try:
        baseline = {n: collect(fresh(n), device=dev) for n in builders}
        cases = [("q1", p) for p in CHAOS_Q1_POINTS] + [
            (n, p) for n in ("q3", "q18") for p in CHAOS_JOIN_POINTS]
        for i, (name, point) in enumerate(cases):
            circuit.reset_all()
            flow = fresh(name)
            reg = faults()
            reg.set_seed(firing_seed(1000 + 100 * i, CHAOS_PROB))
            reg.arm(point, probability=CHAOS_PROB)
            r0, d0 = (counter("sql_resilience_retries_total"),
                      counter("sql_resilience_degradations_total"))
            t0 = time.perf_counter()
            try:
                got = collect(flow, device=dev)
            finally:
                fires = reg.fires(point)
                reg.disarm(point)
            dt = time.perf_counter() - t0
            retries = counter("sql_resilience_retries_total") - r0
            degr = counter("sql_resilience_degradations_total") - d0
            bit_equal_results(f"[14] (g) {name} under {point}",
                              baseline[name], got)
            if not fires or (point != "cache.insert"
                             and retries + degr < 1):
                raise SystemExit(f"[14] (g) {name} {point}: {fires} fires, "
                                 f"{retries} retries, {degr} degradations")
            chaos[f"{name}/{point}"] = {"fires": fires, "retries": retries,
                                        "degradations": degr, "s": dt}
        print(f"  (g) chaos at p={CHAOS_PROB}, each result bit-equal to its "
              f"fault-free run: " + "; ".join(
                  f"{k} {v['fires']} fires {v['retries']} retries "
                  f"{v['degradations']} degradations"
                  for k, v in chaos.items()), flush=True)
        # a forced fused out-of-memory completes on a lower rung
        circuit.reset_all()
        faults().arm("fused.exec", probability=1.0,
                     make=lambda: torch.cuda.OutOfMemoryError(
                         "CUDA out of memory (injected)"))
        try:
            with stats.query_stats() as col:
                got = collect(builders["q1"](), device=dev)
        finally:
            faults().disarm()
            circuit.reset_all()
        bit_equal_results("[14] (g) q1 under a forced fused OOM",
                          baseline["q1"], got)
        if "resilience.degrade.fused" not in col.stages:
            raise SystemExit(f"[14] (g) forced OOM: {sorted(col.stages)}")
        print("  (g) a forced fused OOM: degraded to the streaming tier, "
              "equal rows", flush=True)
    finally:
        scan_image_cache().clear()
        scan_image_cache().restore(cached)
        del cached
    plants = resident_plants(torch, dev)
    print(f"  (g) resident passes on the card: {plants}", flush=True)
    rec["g"] = {"chaos": chaos, "resident_plants": plants}

    # ---- (f) node_metrics, an insight and the slow-query log
    # a fresh Q18 streaming flow restarts once at SF 1 (phase 6)
    collect(tq.q18(gen, Q18_THRESHOLD, CAPACITY, catalog=cat), device=dev,
            fuse=False)
    q6 = sql_text("q6")
    session.execute(q6)
    session.execute(q6)
    ins = default_insights()
    ins.reset()
    for _ in range(6):  # a healthy baseline for its fingerprint
        ins.observe(q6, 0.002)
    lg = ulog.get_logger()
    sink = ulog.MemorySink()
    lg.add_sink(ulog.Channel.SQL_EXEC, sink)
    st.set(SLOW_QUERY_LATENCY, DELAY_S / 2)
    faults().arm("fused.exec", after=0, make=delayed_retryable(DELAY_S))
    try:
        t0 = time.perf_counter()
        session.execute(q6)
        slow_s = time.perf_counter() - t0
    finally:
        faults().disarm()
        st.set(SLOW_QUERY_LATENCY, 0.0)
        lg._sinks[ulog.Channel.SQL_EXEC].remove(sink)
    _, res, schema = session.execute(
        "select fingerprint, kinds, elapsed_s from "
        "crdb_internal.cluster_execution_insights")
    fdict = schema.dicts[schema.field("fingerprint").dict_ref]
    kdict = schema.dicts[schema.field("kinds").dict_ref]
    flagged = [str(kdict[int(k)]) for f, k in zip(res["fingerprint"],
                                                   res["kinds"])
               if str(fdict[int(f)]) == fingerprint(q6)]
    slow_lines = [e for e in sink.entries
                  if e.get("event") == "slow_query" and q6 in e["sql"]]
    _, res, schema = session.execute(
        "select name, value from crdb_internal.node_metrics where "
        "name = 'sql_resilience_retries_total' or name = "
        "'sql_resilience_degradations_total' or name = "
        "'sql_flow_restarts_total'")
    ndict = schema.dicts[schema.field("name").dict_ref]
    node = {str(ndict[int(c)]): float(v)
            for c, v in zip(res["name"], res["value"])}
    moved = {n: node.get(n, 0.0) - start[n] for n in start}
    if not any("slow" in k for k in flagged) or not slow_lines or \
            any(v < 1 for v in moved.values()) or \
            any(node[n] != counter(n) for n in start):
        raise SystemExit(f"[14] (f): insights {flagged}, slow lines "
                         f"{len(slow_lines)}, node_metrics {node}, moved "
                         f"{moved}")
    print(f"  (f) crdb_internal.node_metrics {node} (this phase moved "
          f"{moved}); the delayed q6 ({slow_s * 1e3:.1f} ms) flagged "
          f"{flagged} in cluster_execution_insights and logged "
          f"{len(slow_lines)} slow_query line", flush=True)
    rec["f"] = {"node_metrics": node, "moved": moved, "insights": flagged,
                "slow_s": slow_s}
    rec["s"] = time.perf_counter() - t_phase
    print(f"  phase 14: {rec['s']:.1f} s", flush=True)
    return rec, k1_traced


# ----------------------------------------------------------- phase 15

CF_BURSTS = 10            # (a) write bursts, each polled once
CF_BURST_ROWS = 1000      # (a) rows per burst
FOLD_BURSTS = (1000, 10000)  # (b) rows per burst under the two views
FOLD_RUNS = 3             # (b) fold refreshes, then re-scans, each
VIEW_CUSTOMERS = 1000     # (c) new customers inserted
FEED_POLL_MS = 100        # (c) the continuous job's pause between polls
VEC_N, VEC_D, VEC_QUERIES = 100_000, 64, 64   # (d), (e): bench.py's shape
VEC_CLUSTERS, VEC_NPROBE, VEC_K = 64, 8, 10
VEC_RUNS = 3              # (d) per-query runs (median) and batched runs
VEC_RECALL_FLOOR = 0.9
VEC_INSERT = 1000         # (e) rows appended before the last ANN query
VEC_TOL = 1e-5            # relative distance within which ids may swap
V_SEG = ("select c_nationkey, c_mktsegment, count(*) as n, "
         "sum(c_acctbal) as bal from customer group by c_nationkey, "
         "c_mktsegment")
V_MM = ("select c_nationkey, c_mktsegment, count(*) as n, "
        "sum(c_acctbal) as bal, min(c_acctbal) as lo, max(c_acctbal) as hi "
        "from customer group by c_nationkey, c_mktsegment")


def decoded_rows(payload, schema, cols) -> list:
    """Sorted row tuples of `cols`, string codes decoded through the
    schema's dictionaries (a view and a GROUP BY may order differently)."""
    out = []
    for c in cols:
        v = np.asarray(payload[c])
        d = schema.dictionary(c) if schema is not None else None
        out.append([str(d[x]) for x in v] if d is not None else v.tolist())
    return sorted(zip(*out))


def view_equals_groupby(session, view: str, sql: str, cols) -> bool:
    """`select * from <view>` against the session's own GROUP BY over the
    table, row for row: integer columns bit for bit."""
    _k, got, gs = session.execute(f"select * from {view}")
    _k, want, ws = session.execute(sql)
    return decoded_rows(got, gs, cols) == decoded_rows(want, ws, cols)


def ids_tie_equal(a, b, dist) -> bool:
    """Equal id lists up to swaps between candidates whose float64
    distances `dist[id]` lie within VEC_TOL of each other."""
    for x, y in zip(np.asarray(a).tolist(), np.asarray(b).tolist()):
        if x == y:
            continue
        if x < 0 or y < 0 or abs(dist[x] - dist[y]) > VEC_TOL * max(
                abs(dist[x]), abs(dist[y]), 1e-12):
            return False
    return len(a) == len(b)


def f64_distances(vecs, q, metric="l2"):
    v = vecs.astype(np.float64)
    q = np.asarray(q, np.float64)
    if metric == "l2":
        return np.sqrt(((v - q) ** 2).sum(1))
    return 1.0 - (v @ q) / np.maximum(np.linalg.norm(v, axis=1)
                                     * np.linalg.norm(q), 1e-30)


def vec_text(v) -> str:
    """A vector literal that parses back to the same float32 lanes."""
    return "[" + ",".join(repr(float(x)) for x in np.asarray(v)) + "]"


def docs_load(store, cat, vecs, groups):
    """The vectors as a session table docs (id int primary key, grp int,
    emb vector(d)) written the way session_load writes TPC-H: the row
    codec straight into the engine (d slots of float32 bits per vector,
    then the NULL bitmap)."""
    from cockroach_tpu_torch.sql.session import TableDescriptor

    n, d = vecs.shape
    slots = {"grp": np.asarray(groups, np.int64)}
    bits = vecs.view(np.uint32).astype(np.int64)
    for j in range(d):
        slots[f"emb_{j}"] = bits[:, j]
    slots["__nulls"] = np.zeros(n, np.int64)
    tid = cat._next_id()
    store.ingest_table(tid, np.arange(n, dtype=np.int64), slots)
    cat.save(TableDescriptor(
        tid, "docs", [("id", "int"), ("grp", "int"),
                      ("emb", f"vector({d})")], "id",
        next_rowid=1, row_count=n, notnull=["id"]))


def run_phase15(torch, gen, dev, seed):
    """Streaming and vector search on the card: (a) changefeed emit over
    CF_BURSTS bursts; (b) a view's fold against its re-scan at the
    FOLD_BURSTS bursts; (c) two standing views and a file-sink changefeed
    job over TPC-H customer through an UPDATE, a DELETE (the job paused
    across it) and an INSERT; (d) workload/vectorbench.py `run` and the
    searchers held to a float64 oracle and to themselves batched; (e) the
    same vectors through SQL, exact and ANN. -> JSON record."""
    import threading

    from cockroach_tpu_torch.kv.rangefeed import _metrics as cf_metrics
    from cockroach_tpu_torch.ops.vector import (
        ExactSearcher, VectorIndex, recall_at_k,
    )
    from cockroach_tpu_torch.sql import changefeed as cfmod
    from cockroach_tpu_torch.sql.session import Session, SessionCatalog
    from cockroach_tpu_torch.storage.engine import NativeEngine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore
    from cockroach_tpu_torch.util.hlc import HLC, Timestamp
    from cockroach_tpu_torch.util.settings import (
        Settings, VECTOR_ANN, VECTOR_NPROBE,
    )
    from cockroach_tpu_torch.workload import vectorbench

    t_phase = time.perf_counter()
    rec: dict = {"card": card_line(), "seed": seed}
    part_s: dict = {}
    rec["part_s"] = part_s
    t_part = time.perf_counter()

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        part_s[label] = now - t_part
        t_part = now

    print(f"[15] streaming and vector search on {dev}", flush=True)
    rng = np.random.default_rng(5)
    store = MVCCStore(engine=NativeEngine(), clock=HLC(), device=dev)
    cat = SessionCatalog(store)
    session = Session(cat, capacity=1 << 13, device=dev)

    def burst(table, start, n):
        ks = np.arange(start, start + n)
        grps = rng.integers(0, 64, n)
        vs = rng.integers(0, 100_000, n)
        for i in range(0, n, INSERT_ROWS):
            vals = ",".join("(%d,%d,%d)" % (ks[j], grps[j], vs[j])
                            for j in range(i, min(i + INSERT_ROWS, n)))
            session.execute(f"insert into {table} values {vals}")
        return {int(k): (int(g), int(v)) for k, g, v in zip(ks, grps, vs)}

    # ---- (a) changefeed emit
    session.execute("create table cf (k int primary key, grp int not null, "
                    "v int)")
    sink = cfmod.MemorySink()
    stream = cfmod.ChangefeedStream(store, cat.desc("cf"), sink)
    stream.poll()  # catch up on the empty table
    inserted, emitted, emit_s, lags = {}, 0, 0.0, []
    for b in range(CF_BURSTS):
        inserted.update(burst("cf", b * CF_BURST_ROWS, CF_BURST_ROWS))
        t0 = time.perf_counter()
        emitted += stream.poll()
        emit_s += time.perf_counter() - t0
        lags.append(cf_metrics.frontier_lag_ns.value())
    events = sink.events()
    got = {e["key"]: (e["after"]["grp"], e["after"]["v"]) for e in events}
    if (emitted != CF_BURSTS * CF_BURST_ROWS or len(events) != emitted
            or len(got) != emitted or got != inserted
            or any(e["op"] != "upsert" for e in events)):
        raise SystemExit(f"(a) changefeed: {emitted} envelopes for "
                         f"{len(inserted)} inserted rows, or an envelope "
                         f"differs from its row")
    lags.sort()
    rec["changefeed"] = {
        "envelopes": emitted, "emit_s": emit_s,
        "envelopes_per_s": emitted / emit_s,
        "frontier_lag_ns": lags,
        "frontier_lag_p50_ns": lags[len(lags) // 2],
        "frontier_lag_p99_ns": lags[min(len(lags) - 1,
                                        int(len(lags) * 0.99))]}
    print(f"  (a) changefeed: {emitted} envelopes in {CF_BURSTS} polls, "
          f"{emitted / emit_s:.0f} envelopes/s, frontier lag p50 "
          f"{rec['changefeed']['frontier_lag_p50_ns'] / 1e6:.3f} ms p99 "
          f"{rec['changefeed']['frontier_lag_p99_ns'] / 1e6:.3f} ms; every "
          f"envelope equal to its inserted row", flush=True)
    part_done("a")

    # ---- (b) the view fold against its re-scan
    folds: dict = {}
    for n in FOLD_BURSTS:
        t = f"cfv{n}"
        session.execute(f"create table {t} (k int primary key, "
                        "grp int not null, v int)")
        vsql = f"select grp, count(*) as c, sum(v) as s from {t} group by grp"
        session.execute(f"create materialized view m{n} as {vsql}")
        mgr = session._matviews()
        burst(t, 0, n)
        session.execute(f"refresh materialized view m{n}")
        r0 = mgr.report()[f"m{n}"]["rescans"]
        fold_ms, start = [], n
        for i in range(FOLD_RUNS):
            burst(t, start, n)
            start += n
            t0 = time.perf_counter()
            session.execute(f"refresh materialized view m{n}")
            fold_ms.append((time.perf_counter() - t0) * 1e3)
            if not view_equals_groupby(session, f"m{n}", vsql,
                                       ("grp", "c", "s")):
                raise SystemExit(f"(b) m{n} after fold {i + 1} differs "
                                 f"from the GROUP BY")
        rep = mgr.report()[f"m{n}"]
        during = rep["rescans"] - r0
        mv = mgr.get(f"m{n}")
        rescan_ms = []
        for _ in range(FOLD_RUNS):
            t0 = time.perf_counter()
            mv._rescan(store.clock.now())
            rescan_ms.append((time.perf_counter() - t0) * 1e3)
        if during != 0 or not view_equals_groupby(session, f"m{n}", vsql,
                                                  ("grp", "c", "s")):
            raise SystemExit(f"(b) m{n}: {during} re-scans during the "
                             f"folds, or the re-scanned view differs")
        folds[str(n)] = {
            "fold_refresh_ms": fold_ms, "rescan_refresh_ms": rescan_ms,
            "fold_vs_rescan": statistics.median(rescan_ms)
            / statistics.median(fold_ms),
            "rescans_during_folds": during,
            "state_bytes": mv.state.nbytes()}
        print(f"  (b) {n}-row bursts: refresh by fold {fold_ms} ms, by "
              f"re-scan {rescan_ms} ms ({folds[str(n)]['fold_vs_rescan']:.2f}"
              f"x), 0 re-scans during the folds, every read equal to the "
              f"GROUP BY", flush=True)
    rec["fold"] = folds
    part_done("b")

    # ---- (c) standing views and a changefeed job over TPC-H customer
    store = MVCCStore(engine=NativeEngine(), clock=HLC(), device=dev)
    cat, load_s = session_load(gen, store, ("customer",))
    session = Session(cat, capacity=CAPACITY, device=dev)
    mgr = session._matviews()
    seg_cols = ("c_nationkey", "c_mktsegment", "n", "bal")
    mm_cols = seg_cols + ("lo", "hi")
    views = {"v_seg": (V_SEG, seg_cols), "v_mm": (V_MM, mm_cols)}
    first_s = {}
    for name, (vsql, _c) in views.items():
        t0 = time.perf_counter()
        session.execute(f"create materialized view {name} as {vsql}")
        first_s[name] = time.perf_counter() - t0

    def check_views(label):
        for name, (vsql, cols) in views.items():
            if not view_equals_groupby(session, name, vsql, cols):
                raise SystemExit(f"(c) {name} after {label} differs from "
                                 f"the GROUP BY over customer")

    check_views("its first build")
    feed_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "phase15_feed")
    if os.path.isdir(feed_dir):
        for f in os.listdir(feed_dir):
            os.unlink(os.path.join(feed_dir, f))
    t_job = time.perf_counter()
    _k, payload, _s = session.execute(
        f"create changefeed for table customer with sink = 'file:{feed_dir}'"
        f", poll_interval_ms = {FEED_POLL_MS}, run = false")
    job_id = int(payload["job_id"][0])
    reg = session._jobs_registry()

    def adopt():
        th = threading.Thread(target=reg.adopt_and_run, daemon=True)
        th.start()
        return th

    def stop(th, label):
        th.join(timeout=120)
        if th.is_alive():
            raise SystemExit(f"(c) the changefeed job did not stop at "
                             f"{label}")

    adopter = adopt()
    c_tab = gen.table("customer")
    c_key = np.asarray(c_tab["c_custkey"], np.int64)
    writes: dict = {}

    def write(label, sql_list, delta_rows):
        t0 = time.perf_counter()
        for s in sql_list:
            session.execute(s)
        w = {"write_s": time.perf_counter() - t0}
        before = {n: (mgr.get(n).folds, mgr.get(n).rescans) for n in views}
        for name in views:
            t0 = time.perf_counter()
            session.execute(f"refresh materialized view {name}")
            w[f"{name}_refresh_ms"] = (time.perf_counter() - t0) * 1e3
            mv = mgr.get(name)
            w[f"{name}_how"] = ("fold" if mv.folds > before[name][0]
                                else "rescan" if mv.rescans
                                > before[name][1] else "idle")
        w["delta_rows"] = delta_rows
        check_views(label)
        writes[label] = w
        print(f"  (c) {label} ({delta_rows} delta rows): write "
              f"{w['write_s']:.2f} s; v_seg "
              f"{w['v_seg_how']} {w['v_seg_refresh_ms']:.1f} ms, v_mm "
              f"{w['v_mm_how']} {w['v_mm_refresh_ms']:.1f} ms; both equal "
              f"to the GROUP BY", flush=True)

    n_upd = int((np.asarray(c_tab["c_nationkey"]) == UPDATE_NATION).sum())
    # an UPDATE folds each row out at its old value and in at its new
    write("update", [f"update customer set c_acctbal = c_acctbal + 1 "
                     f"where c_nationkey = {UPDATE_NATION}"], 2 * n_upd)
    session.execute(f"pause job {job_id}")
    stop(adopter, "the pause")
    paused_state = reg.get(job_id).state
    n_del = int((c_key > DELETE_ABOVE).sum())
    write("delete", [f"delete from customer where c_custkey > "
                     f"{DELETE_ABOVE}"], n_del)
    session.execute(f"resume job {job_id}")
    adopter = adopt()
    first_key = int(c_key.max()) + 1
    new = {f.name: (np.arange(first_key, first_key + VIEW_CUSTOMERS,
                              dtype=np.int64) if f.name == "c_custkey"
                    else rng.choice(np.asarray(c_tab[f.name], np.int64),
                                    VIEW_CUSTOMERS))
           for f in gen.schema("customer")}
    write("insert", insert_statements(gen, "customer", new), VIEW_CUSTOMERS)
    horizon = store.clock.now()
    deadline = time.perf_counter() + 300
    while True:
        prog = reg.get(job_id).progress or {}
        if Timestamp(*prog.get("frontier", [0, 0])) >= horizon:
            break
        if time.perf_counter() > deadline or not adopter.is_alive():
            raise SystemExit(f"(c) the changefeed job stopped short of the "
                             f"last write: {reg.get(job_id)}")
        time.sleep(0.01)
    job_s = time.perf_counter() - t_job
    session.execute(f"cancel job {job_id}")
    stop(adopter, "the cancel")
    acked = cfmod.FileSink.read_events(feed_dir)
    seen, state = set(), {}
    for e in sorted(acked, key=lambda e: tuple(e["ts"])):
        k = (e["key"], tuple(e["ts"]))
        if k in seen:
            raise SystemExit(f"(c) the changefeed emitted {k} twice")
        seen.add(k)
        if e["op"] == "delete":
            state.pop(e["key"], None)
        else:
            a = e["after"]
            state[e["key"]] = (a["c_nationkey"], a["c_acctbal"],
                               a["c_mktsegment"])
    _k, res, sch = session.execute("select c_custkey, c_nationkey, "
                                   "c_acctbal, c_mktsegment from customer")
    seg = sch.dictionary("c_mktsegment")
    table = {int(k): (int(n), str(Decimal(int(b)).scaleb(-2)), str(seg[s]))
             for k, n, b, s in zip(*(np.asarray(res[c]) for c in (
                 "c_custkey", "c_nationkey", "c_acctbal", "c_mktsegment")))}
    if state != table:
        bad = sorted(set(state.items()) ^ set(table.items()))[:3]
        raise SystemExit(f"(c) the file sink's events replayed differ from "
                         f"the final table: {bad}")
    rep = mgr.report()
    if rep["v_seg"]["rescans"] != 1 or rep["v_seg"]["folds"] != 3:
        raise SystemExit(f"(c) v_seg: {rep['v_seg']}, expected one re-scan "
                         f"(its build) and three folds")
    # MIN/MAX cannot fold a retraction: the UPDATE and the DELETE both
    # retract rows, so v_mm re-scans at each; the INSERT folds
    if (rep["v_mm"]["rescans"] != 3 or rep["v_mm"]["folds"] != 1
            or writes["delete"]["v_mm_how"] != "rescan"
            or writes["insert"]["v_mm_how"] != "fold"):
        raise SystemExit(f"(c) v_mm: {rep['v_mm']}, {writes}: expected "
                         f"re-scans at its build, the UPDATE and the DELETE "
                         f"and a fold at the INSERT")
    rec["views"] = {
        "load_s": load_s["customer"], "first_build_s": first_s,
        "writes": writes, "report": rep,
        "rows": {"update": n_upd, "delete": n_del,
                 "insert": VIEW_CUSTOMERS},
        "state_bytes": {n: mgr.get(n).state.nbytes() for n in views},
        "groups": {n: len(mgr.get(n).state.keys) for n in views},
        "job": {"envelopes": len(acked), "seconds": job_s,
                "paused_state": paused_state,
                "final_state": reg.get(job_id).state,
                "segments": len(os.listdir(feed_dir))}}
    print(f"  (c) customer ({store.engine.__class__.__name__}): first builds "
          f"{ {k: round(v, 2) for k, v in first_s.items()} } s, "
          f"{rec['views']['groups']} groups, state bytes "
          f"{rec['views']['state_bytes']}; the job ({paused_state} across "
          f"the DELETE) acked {len(acked)} envelopes in {job_s:.1f} s, "
          f"replayed exactly once onto the final table", flush=True)
    del session, mgr, reg
    torch.cuda.empty_cache()
    part_done("c")

    # ---- (d) vector search at bench.py's shape
    block = vectorbench.run(n=VEC_N, d=VEC_D, n_queries=VEC_QUERIES,
                            k=VEC_K, n_clusters=VEC_CLUSTERS,
                            nprobe=VEC_NPROBE, runs=VEC_RUNS, seed=seed,
                            device=dev)
    vrng = np.random.default_rng(seed)
    vecs, _assign = vectorbench.make_dataset(VEC_N, VEC_D, VEC_CLUSTERS, vrng)
    qs = vectorbench.make_queries(vecs, VEC_QUERIES, vrng)
    exact = ExactSearcher(vecs, "l2", VEC_K, device=dev)
    index = VectorIndex.build(vecs, "l2", n_clusters=VEC_CLUSTERS,
                              device=dev)
    ex_ids, ex_d = exact.search_batch(qs, batch_size=VEC_QUERIES)
    an_ids, an_d = index.search_batch(qs, k=VEC_K, nprobe=VEC_NPROBE,
                                      batch_size=VEC_QUERIES)
    dists = [f64_distances(vecs, q) for q in qs]
    for i, q in enumerate(qs):
        oracle = np.argsort(dists[i], kind="stable")[:VEC_K]
        if not ids_tie_equal(ex_ids[i], oracle, dists[i]):
            raise SystemExit(f"(d) exact query {i}: {ex_ids[i]} against "
                             f"the float64 oracle's {oracle}")
        for searcher, ids, d in (
                (lambda x: exact.search(x), ex_ids, ex_d),
                (lambda x: index.search(x, VEC_K, VEC_NPROBE), an_ids,
                 an_d)):
            one_ids, one_d = searcher(q)
            if not (np.array_equal(one_ids, ids[i]) and np.array_equal(
                    one_d.view(np.int32), d[i].view(np.int32))):
                raise SystemExit(f"(d) query {i}: batched differs from "
                                 f"per-query")
    recall = recall_at_k(an_ids, ex_ids)
    if recall < VEC_RECALL_FLOOR or block["recall_at_k"] < VEC_RECALL_FLOOR:
        raise SystemExit(f"(d) recall@{VEC_K} {recall}, bench "
                         f"{block['recall_at_k']}: below {VEC_RECALL_FLOOR}")
    block.update(recall_here=recall, image_bytes=exact.nbytes(),
                 index_bytes=index.nbytes(), index_m=index.m)
    rec["vector"] = block
    print(f"  (d) vectors n={VEC_N} d={VEC_D}: recall@{VEC_K} "
          f"{block['recall_at_k']}, exact p50/p99 {block['exact_p50_ms']}/"
          f"{block['exact_p99_ms']} ms, ANN {block['ann_p50_ms']}/"
          f"{block['ann_p99_ms']} ms, batched {block['exact_queries_per_sec']}"
          f"/{block['ann_queries_per_sec']} q/s, build "
          f"{block['index_build_s']} s, image {exact.nbytes()} B, index "
          f"{index.nbytes()} B; exact ids equal the float64 oracle's, "
          f"batched equal per-query bit for bit", flush=True)
    part_done("d")

    # ---- (e) the same vectors through SQL
    settings = Settings()
    prev = (settings.get(VECTOR_ANN), settings.get(VECTOR_NPROBE))
    store = MVCCStore(engine=NativeEngine(), clock=HLC(), device=dev)
    cat = SessionCatalog(store)
    groups = np.arange(VEC_N, dtype=np.int64) % 3
    t0 = time.perf_counter()
    docs_load(store, cat, vecs, groups)
    sql_rec: dict = {"load_s": time.perf_counter() - t0}
    session = Session(cat, capacity=CAPACITY, device=dev)
    q = qs[0]
    d0 = dists[0]
    ex_text = (f"select id from docs order by emb <-> '{vec_text(q)}' "
               f"limit {VEC_K}")

    def run(label, text, check):
        res, dt, syncs, ev, parses, _l = session_run(torch, session, text)
        ids = np.asarray(res["id"])
        check(label, ids)
        sql_rec[label] = {"s": dt, "syncs": syncs,
                          "events": {k: v for k, v in ev.items()
                                     if k.startswith(("vector.", "fused.",
                                                      "sql."))}}
        return ev, parses, syncs

    def same_as(want, dist):
        def check(label, ids):
            if not (np.array_equal(ids, want)
                    or ids_tie_equal(ids, want, dist)):
                raise SystemExit(f"(e) {label}: {ids.tolist()} against "
                                 f"{np.asarray(want).tolist()}")
        return check

    run("exact_cold", ex_text, same_as(ex_ids[0], d0))
    ev, parses, syncs = run("exact_warm", ex_text, same_as(ex_ids[0], d0))
    check_warm_hit("(e) exact warm", session._prepared[ex_text].op.
                   _fused_runner, ev, parses, syncs)
    mask = groups == 1
    sub = np.flatnonzero(mask)
    f_ids, _fd = ExactSearcher(vecs[mask], "l2", VEC_K,
                               device=dev).search(q)
    run("filtered", f"select id from docs where grp = 1 order by emb <-> "
        f"'{vec_text(q)}' limit {VEC_K}", same_as(sub[f_ids], d0))
    cos_d = f64_distances(vecs, q, "cos")
    c_ids, _cd = ExactSearcher(vecs, "cos", VEC_K, device=dev).search(q)
    run("cosine", f"select id from docs order by emb <=> '{vec_text(q)}' "
        f"limit {VEC_K}", same_as(c_ids, cos_d))
    # ANN: the setting is process-wide and a prepared entry keeps the plan
    # it was built with, so the cache is cleared where it changes
    settings.set(VECTOR_ANN, True)
    settings.set(VECTOR_NPROBE, VEC_NPROBE)
    try:
        with session._prepared_mu:
            session._prepared.clear()
        ann_index = VectorIndex.build(vecs, "l2", device=dev)
        a_ids, _ad = ann_index.search(q, VEC_K, VEC_NPROBE)
        ev, _p, _s = run("ann_cold", ex_text, same_as(a_ids, d0))
        if ev.get("vector.index_build") != 1:
            raise SystemExit(f"(e) ANN cold: {ev}, expected one index build")
        ev, _p, _s = run("ann_warm", ex_text, same_as(a_ids, d0))
        if ev.get("vector.index_build") or ev.get("vector.index_hit") != 1:
            raise SystemExit(f"(e) ANN warm: {ev}, expected the cached index")
        extra, _e = vectorbench.make_dataset(VEC_INSERT, VEC_D, VEC_CLUSTERS,
                                             np.random.default_rng(seed + 1))
        rows = [f"({VEC_N + i}, {i % 3}, '{vec_text(v)}')"
                for i, v in enumerate(extra)]
        t0 = time.perf_counter()
        for a in range(0, len(rows), INSERT_ROWS):
            session.execute("insert into docs values "
                            + ", ".join(rows[a:a + INSERT_ROWS]))
        sql_rec["insert_s"] = time.perf_counter() - t0
        ann_index.append(extra, start_id=VEC_N)
        a_ids, _ad = ann_index.search(q, VEC_K, VEC_NPROBE)
        all_d = np.concatenate([d0, f64_distances(extra, q)])
        ev, _p, _s = run("ann_after_insert", ex_text, same_as(a_ids, all_d))
        if ev.get("vector.index_append") != 1 or ev.get("vector.index_build"):
            raise SystemExit(f"(e) ANN after the INSERT: {ev}, expected one "
                             f"append and no build")
        sql_rec["ann_index_bytes"] = ann_index.nbytes()
        sql_rec["ann_clusters"] = ann_index.n_clusters
    finally:
        settings.set(VECTOR_ANN, prev[0])
        settings.set(VECTOR_NPROBE, prev[1])
    rec["vector_sql"] = sql_rec
    print(f"  (e) docs ({VEC_N} rows, vector({VEC_D})) through SQL: exact "
          f"cold {sql_rec['exact_cold']['s'] * 1e3:.1f} ms, warm "
          f"{sql_rec['exact_warm']['s'] * 1e3:.2f} ms (one replay, "
          f"{sql_rec['exact_warm']['syncs']} sync), filtered "
          f"{sql_rec['filtered']['s'] * 1e3:.1f} ms, <=> "
          f"{sql_rec['cosine']['s'] * 1e3:.1f} ms; ANN cold "
          f"{sql_rec['ann_cold']['s'] * 1e3:.1f} ms (index build), warm "
          f"{sql_rec['ann_warm']['s'] * 1e3:.2f} ms, after an INSERT of "
          f"{VEC_INSERT} rows {sql_rec['ann_after_insert']['s'] * 1e3:.1f} "
          f"ms (one append, no build); every answer equal to the searchers'",
          flush=True)
    del session
    torch.cuda.empty_cache()
    part_done("e")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 15: {rec['seconds']:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in part_s.items()} }", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one more run of each query and write "
                    "their kernel tables")
    ap.add_argument("--trace-runs", type=int, default=1, metavar="N",
                    help="phase 11 (b): traced warm replays of each SQL "
                    "text that runs K1 (default 1)")
    ap.add_argument("--seed", type=int, default=19940211,
                    help="phases 13 and 15: the seed of RF1's rows, the "
                    "point lookups' keys and the vector data (default "
                    "19940211)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from cockroach_tpu_torch.ops import agg
    from cockroach_tpu_torch.ops import cuda_kernels as ck
    from cockroach_tpu_torch.workload import tpch

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
    ptxas = dense_sums_ptxas(ck.DENSE_SUMS.build_log)
    for (kc, exact, vec, priv), got in sorted(ptxas.items()):
        print(f"  dense_sums_kernel<{kc}{'' if exact else '+'}, "
              f"{'vector' if vec else 'scalar'}, "
              f"{'private' if priv else 'warp'}>: registers, spill stores, "
              f"spill loads {got}")
    q1_ptxas = ptxas.get((6, 1, 1, 1))
    if q1_ptxas is None or q1_ptxas[1:] != (0, 0):
        raise SystemExit(f"dense_sums' Q1 instantiation: ptxas says "
                         f"{q1_ptxas}, expected 0 spill bytes")
    q1_sass = dense_sums_q1_sass(ck)
    print(f"  dense_sums_kernel<6, vector, private> SASS: {q1_sass}",
          flush=True)
    if q1_sass["ATOMS"]:
        raise SystemExit("dense_sums' Q1 instantiation has shared-memory "
                         "atomics in its SASS")

    # ---- 3. kernels vs plain versions
    print("[3] kernels against their plain versions", flush=True)
    worst = sweep_dense_sums(torch, ck, dev)

    # ---- 4. the main path: Q1 SF 1 through the port on CUDA
    gen = tpch.TPCH(sf=SF)
    flow, q1_record, launches, q1_streaming = run_phase4(torch, gen)

    # ---- 5. kernels at the main path's shapes
    agg_op = flow.child
    first = next(agg_op.child.batches(dev))
    packed, values, live, d = agg.dense_kernel_inputs(
        first, agg_op.group_by, agg_op.internal, agg_op.dense_sizes)
    n = packed.shape[0]
    worst = max(worst, check_dense_case(torch, ck, "Q1's first chunk",
                                        packed, values, live, d,
                                        ck.smem_per_block(dev)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    q1_shape = measure_dense_sums(torch, ck, packed, values, live, d, flush)
    kernel_ms, plain_ms = q1_shape["ms"], q1_shape["plain_ms"]
    library_ms, bound_ms = q1_shape["library_ms"], q1_shape["bound_ms"]
    nbytes, k_cols = q1_shape["bytes"], q1_shape["k"]
    kernel_clean_ms = q1_shape["clean_l2_ms"]
    # a yardstick for reading that many bytes: one torch.sum over them
    same_bytes = torch.ones(nbytes // 8, dtype=torch.int64, device=dev)
    read_ms = event_ms(torch, lambda: same_bytes.sum(), flush=flush)
    read_clean_ms = event_ms(torch, lambda: same_bytes.sum(), flush=flush,
                             clean=True)
    print(f"[5] dense_sums at Q1's shape N={n} D={d} K={k_cols}: "
          f"kernel_ms {kernel_ms:.4f} (first version {DENSE_SUMS_FIRST_MS}), "
          f"bound_ms {bound_ms:.4f} ({nbytes} bytes; kernel at "
          f"{bound_ms / kernel_ms:.1%} of it), plain_ms {plain_ms:.4f}, "
          f"library_ms {library_ms:.4f} (index_add_)", flush=True)
    print(f"  after a flush that leaves L2 clean: kernel_ms "
          f"{kernel_clean_ms:.4f}; torch.sum over {nbytes} bytes "
          f"{read_ms:.4f} (dirty L2), {read_clean_ms:.4f} (clean L2)",
          flush=True)
    # the same at 4 x the rows: the slope over the 3 x nbytes more is the
    # streaming rate, the intercept the fixed cost of one call
    rep4 = lambda x: None if x is None else x.repeat(4)
    packed4, values4, live4 = (packed.repeat(4), [rep4(v) for v in values],
                               [rep4(m) for m in live])
    kernel4_ms = event_ms(
        torch, lambda: ck.dense_sums(packed4, values4, live4, d), flush=flush)
    same_bytes4 = same_bytes.repeat(4)
    read4_ms = event_ms(torch, lambda: same_bytes4.sum(), flush=flush)
    for name, t1, t4 in (("kernel", kernel_ms, kernel4_ms),
                         ("torch.sum", read_ms, read4_ms)):
        rate = 3 * nbytes / ((t4 - t1) * 1e-3)
        print(f"  {name} at 4 x the rows: {t4:.4f} ms; streams "
              f"{rate / 1e12:.3f} TB/s ({rate / PEAK_BYTES_PER_S:.1%} of "
              f"{PEAK_BYTES_PER_S / 1e12} TB/s) past a fixed cost of "
              f"{t1 - (t4 - t1) / 3:.4f} ms", flush=True)
    del packed4, values4, live4, same_bytes4

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            streaming_collect()(flow)
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

    # ---- 6. Q6, Q3 and Q18 at SF 1
    query_records = run_phase6(torch, gen, dev, args.profile)
    # ---- 7. Q9, Q12 and Q14 at SF 1
    records7, worst7 = run_phase7(torch, ck, gen, dev, args.profile)
    query_records.update(records7)
    worst = max(worst, worst7)
    # ---- 8. Q4, Q17, Q16, Q2, Q15, Q5, Q10 and Q19 at SF 1
    records8, worst8, k1_shapes = run_phase8(torch, ck, gen, dev, flush,
                                             args.profile)
    query_records.update(records8)
    worst = max(worst, worst8)
    # ---- 9. the fifteen queries through the fused tier, one CUDA graph
    # each
    records9, flows9 = run_phase9(torch, gen, q1_streaming, args.profile)
    q1_record.update(records9.pop("q1"))
    for name, rec in records9.items():
        query_records[name].update(rec)
    fused_shapes, worst9 = fused_dense_shapes(torch, ck, flows9, flush)
    worst = max(worst, worst9)
    # the phase 9 flows' images and graphs go before the out-of-core runs
    # measure their device memory peaks
    for f in flows9.values():
        for scan in scans_of(f):
            scan.evict()
        f._fused_runner = None
    del flows9, flow
    torch.cuda.empty_cache()
    # phase 10 empties the scan-image cache; phase 11's sessions borrow
    # what phases 6-9 left there, so those images are held aside (on the
    # card) and put back after it
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

    cached_images = scan_image_cache().snapshot()
    # ---- 10. the out-of-core paths
    records10 = run_phase10(torch, gen)
    # ---- 11. the SQL front end
    scan_image_cache().restore(cached_images)
    del cached_images
    phase9_warm = {n: (q1_record if n == "q1" else query_records[n])[
        "fused_warm_s"] for n in PHASE11}
    records11, k1_sql = run_phase11(torch, gen, dev, phase9_warm,
                                    args.profile, args.trace_runs)
    # ---- 12. the MVCC storage layer; the cache's images are held aside
    # (on the card) so that the resident pin is not refused for them
    cached_images = scan_image_cache().snapshot()
    scan_image_cache().clear()
    records12, k1_mvcc = run_phase12(torch, gen, dev, q1_streaming,
                                     args.profile)
    scan_image_cache().restore(cached_images)
    del cached_images
    # ---- 13. the storage-backed session; the cache's images held aside
    # as in phase 12 (and, with few entries, each write's invalidation
    # scan stays short)
    cached_images = scan_image_cache().snapshot()
    scan_image_cache().clear()
    records13, k1_session = run_phase13(torch, gen, dev, q1_streaming,
                                        args.profile, args.seed)
    scan_image_cache().restore(cached_images)
    del cached_images
    # ---- 14. the lifecycle seams, over phase 11's images
    records14, k1_traced_session = run_phase14(torch, gen, dev, records11,
                                               args.profile)
    # ---- 15. streaming and vector search, on stores of their own
    cached_images = scan_image_cache().snapshot()
    scan_image_cache().clear()
    records15 = run_phase15(torch, gen, dev, args.seed)
    scan_image_cache().restore(cached_images)
    del cached_images

    kernels = [{
        "name": "dense_sums",
        "route": "cuda",
        "source": "cockroach_tpu_torch/csrc/dense_sums.cu",
        "replaces": "cockroach_tpu/ops/pallas_kernels.py:89",
        "launches": launches["dense_sums"],
        "launches_by_path": {
            "q1": launches["dense_sums"],
            **{q: query_records[q]["kernel_launches"]["dense_sums"]
               for q in ("q12", "q4", "q5")},
            **{f"{q}_fused": (q1_record if q == "q1" else query_records[q])[
                "fused_k1_traced"] for q in FUSED_K1},
            **{f"{q}_sql": n for q, n in k1_sql.items()},
            **k1_mvcc, **k1_session,
            "q1_traced_session": k1_traced_session},
        "sql_traces": {q: records11[q]["k1_traces"] for q in k1_sql},
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": q1_shape["bound_by"],
        "library_ms": library_ms,
        "at_shapes": {"q1": q1_shape, **k1_shapes, **fused_shapes},
    }]
    print(f"[16] whole run {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"q1": q1_record}))
    for name in PHASE6 + PHASE7 + PHASE8:
        print(json.dumps({name: query_records[name]}))
    print(json.dumps({"phase10": records10}))
    for name, rec in records11.items():
        print(json.dumps({f"sql_{name}": rec}))
    print(json.dumps({"phase12": records12}))
    print(json.dumps({"phase13": records13}))
    print(json.dumps({"phase14": records14}))
    print(json.dumps({"phase15": records15}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

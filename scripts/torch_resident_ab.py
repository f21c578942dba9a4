#!/usr/bin/env python3
"""Paired timings of two design choices of the PyTorch port's scan path
(cockroach_tpu_torch) on one CUDA card, at TPC-H SF 1, capacity 2^20.

    python3 scripts/torch_resident_ab.py [--pairs N] [--json FILE]

1. The prefetch thread on the streaming path. Each query's flow streams
   (every ScanOp packs and copies each run: not resident, no cache key)
   with ScanOp's packing on the `_prefetch` producer thread ("thread")
   and inline in the consumer ("inline": `_prefetch` replaced by the
   identity), in N alternating pairs (thread, inline, then inline,
   thread, ...), after one unclocked run of each arm.
2. The stacked join build against the chunked build over the same
   resident images. Every ScanOp of each join query is resident; after a
   cold and a warm run, the whole query is timed with JoinOp's
   `_try_stacked_build` on ("stacked") and off ("chunked": the chunked
   build reads the same image chunk by chunk), and each JoinOp whose build
   side is MapOp* -> ScanOp has its `_materialize_build` timed alone both
   ways, in N alternating pairs.

Both comparisons run the streaming tier (`collect(..., fuse=False)`),
whose scan and build paths they time. Every run of an arm must equal the
first run of the other arm, array for array. Times are host wall-clock seconds to the end of the run after a
torch.cuda.synchronize(). Prints the card line, one line per query and
join with each arm's median and the median of the per-pair ratios, and
last a JSON object of every time.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

STREAMING = ("q1", "q6", "q12", "q14", "q3", "q9")
JOINS = ("q3", "q18", "q9", "q12", "q14", "q4", "q17", "q16", "q2", "q15",
         "q5", "q10", "q19")


def same(a: dict, b: dict, what: str) -> None:
    for c in a:
        if not np.array_equal(np.asarray(a[c]), np.asarray(b[c])):
            raise SystemExit(f"{what}: column {c} differs between the arms")


def paired(run_a, run_b, pairs: int):
    """N alternating pairs of two zero-argument timers. -> (times of a,
    times of b, per-pair b/a ratios)."""
    ta, tb = [], []
    for i in range(pairs):
        order = ((run_a, ta), (run_b, tb))
        for fn, out in (order if i % 2 == 0 else order[::-1]):
            out.append(fn())
    return ta, tb, [b / a for a, b in zip(ta, tb)]


def summary(label, ta, tb, ratios, arms) -> dict:
    print(f"  {label}: {arms[0]} median {statistics.median(ta) * 1e3:.2f} "
          f"ms, {arms[1]} median {statistics.median(tb) * 1e3:.2f} ms, "
          f"{arms[1]}/{arms[0]} per pair median "
          f"{statistics.median(ratios):.3f} (min {min(ratios):.3f}, max "
          f"{max(ratios):.3f})", flush=True)
    return {arms[0]: ta, arms[1]: tb, "ratio_median":
            statistics.median(ratios)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--json", metavar="FILE")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_resident_ab: no CUDA device is available",
              file=sys.stderr)
        return 1
    from cockroach_tpu_torch.exec import operators as ops
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
    from cockroach_tpu_torch.ops import cuda_kernels as ck
    from cockroach_tpu_torch.workload import tpch
    from cockroach_tpu_torch.workload import tpch_queries as tq

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    ck.build_all()
    gen = tpch.TPCH(sf=cs.SF)
    t0 = time.perf_counter()
    for t in cs.PHASE_TABLES[8]:
        gen.table(t)
    builders = cs.query_flows(gen)
    builders["q1"] = lambda: tq.q1(gen, cs.CAPACITY)
    print(f"datagen {time.perf_counter() - t0:.2f} s; {args.pairs} pairs "
          f"per comparison", flush=True)

    def fresh(name):
        flow = builders[name]()
        cs.feed_pregenerated(flow, gen, cs.CAPACITY)
        return flow

    def timer(flow, results):
        def run():
            t = time.perf_counter()
            res = ops.collect(flow, fuse=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            results.append(res)
            return dt
        return run

    out = {"card": cs.card_line(), "pairs": args.pairs, "streaming": {},
           "build": {}, "build_query": {}}
    prefetch = ops._prefetch
    stacked_build = ops.JoinOp._try_stacked_build

    print("[1] streaming: the prefetch thread against inline packing",
          flush=True)
    for name in STREAMING:
        flow = fresh(name)
        cs.make_streaming(flow)
        got_a, got_b = [], []
        run_t, run_i = timer(flow, got_a), timer(flow, got_b)

        def inline(run=run_i):
            ops._prefetch = lambda it, device: it
            try:
                return run()
            finally:
                ops._prefetch = prefetch
        run_t(), inline()  # unclocked: the first run of each arm
        ta, tb, ratios = paired(run_t, inline, args.pairs)
        for i, r in enumerate(got_a + got_b):
            same(got_a[0], r, f"{name} streaming run {i}")
        out["streaming"][name] = summary(name, ta, tb, ratios,
                                         ("thread", "inline"))

    print("[2] resident images: the stacked join build against the "
          "chunked build", flush=True)
    scan_image_cache().clear()
    for name in JOINS:
        flow = fresh(name)
        cs.make_resident(flow)
        ops.collect(flow, fuse=False)  # cold: pins every image
        joins = [j for j in ops.walk_operators(flow)
                 if isinstance(j, ops.JoinOp)
                 and ops._source_scan(j.build) is not None]
        got_a, got_b = [], []
        run_s, run_c = timer(flow, got_a), timer(flow, got_b)

        def chunked(run=run_c):
            ops.JoinOp._try_stacked_build = lambda self, device: None
            try:
                return run()
            finally:
                ops.JoinOp._try_stacked_build = stacked_build
        run_s(), chunked()
        ta, tb, ratios = paired(run_s, chunked, args.pairs)
        for i, r in enumerate(got_a + got_b):
            same(got_a[0], r, f"{name} resident run {i}")
        out["build_query"][name] = summary(
            f"{name} warm run ({len(joins)} stacked builds)", ta, tb, ratios,
            ("stacked", "chunked"))
        for k, j in enumerate(joins):
            def build(j=j, stacked=True):
                if not stacked:
                    j._try_stacked_build = lambda device: None
                try:
                    t = time.perf_counter()
                    b = j._materialize_build(dev)[1]
                    torch.cuda.synchronize()
                    return time.perf_counter() - t, b
                finally:
                    if not stacked:
                        del j._try_stacked_build
            bs, bc = build()[1], build(stacked=False)[1]
            tensors = [(n, t) for n, c in bs.columns.items()
                       for t in (c.values, c.validity)]
            other = [t for c in bc.columns.values()
                     for t in (c.values, c.validity)]
            for (col, a), b in zip(tensors + [("sel", bs.sel),
                                              ("length", bs.length)],
                                   other + [bc.sel, bc.length]):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise SystemExit(f"{name} join {k}: build {col} "
                                     f"differs between the arms")
            ta, tb, ratios = paired(lambda: build()[0],
                                    lambda: build(stacked=False)[0],
                                    args.pairs)
            scan = ops._source_scan(j.build)[1]
            out["build"][f"{name}.{k}"] = summary(
                f"{name} join {k} build over {scan.table} "
                f"({len(scan.stacked_image(dev).ms_host)} chunks)",
                ta, tb, ratios, ("stacked", "chunked"))
    scan_image_cache().clear()
    line = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

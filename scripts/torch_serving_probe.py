#!/usr/bin/env python3
"""Where a served statement's time goes, for the port's wire and serving
queue (sql/pgwire.py, sql/serving.py), over chip_smoke.py phase 16's
YCSB-E tables and read pools.

    python3 scripts/torch_serving_probe.py [--device cpu] [--records N]
        [--profile OPS] [--intervals 0.005,0.0005] [--pairs P]

--profile OPS: one wire client runs one pool range scan OPS times over
the simple protocol and OPS times through Parse/Bind/Execute; prints the
mean ms an op and, from cProfile (process-wide from Python 3.12: the
server's connection thread and the client), the cumulative seconds of
the wire's row encoding
(`_Conn._data_rows`, `_render`), the client's decoding
(`WireClient._read_result`), the serving dispatch (`ServingQueue._dispatch`)
and the Bind re-match (`match_bound_sql`).
--intervals: phase 16 (b)'s mixed run (16 clients x 200 ops) with
serving off and on under each `sys.setswitchinterval` value in turn,
`--pairs` times (the interpreter's GIL hand-off interval: does the
handoff or the CPU share bound the clients?); prints chip_smoke's
serve_line of each run and the device's name and power limit.
Runs on CUDA unless --device cpu."""

import argparse
import cProfile
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--records", type=int, default=None)
    ap.add_argument("--profile", type=int, default=0, metavar="OPS")
    ap.add_argument("--intervals", default="")
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args()

    import numpy as np

    import chip_smoke as cs
    from cockroach_tpu_torch import resolve_device
    from cockroach_tpu_torch.sql import pgwire
    from cockroach_tpu_torch.sql.session import SessionCatalog
    from cockroach_tpu_torch.storage import resident as _resident
    from cockroach_tpu_torch.storage.engine import NativeEngine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore
    from cockroach_tpu_torch.util.hlc import HLC
    from cockroach_tpu_torch.util.settings import Settings
    from cockroach_tpu_torch.workload import servebench as sb

    dev = resolve_device(args.device)
    if args.records:
        cs.SERVE_RECORDS = args.records
    print(cs.card_line() if dev.type == "cuda" else "cpu", flush=True)
    Settings().set(_resident.RESIDENT_SCAN, True)
    rng = np.random.default_rng(19940211)
    store = MVCCStore(engine=NativeEngine(), clock=HLC(), device=dev)
    cat = SessionCatalog(store)
    user, li, _ = cs.serve_tables(store, cat, rng)
    pools = cs.serve_pools(rng, user, li)
    srv = pgwire.PgServer(cat, capacity=cs.SERVE_CAPACITY,
                          device=dev).start()
    try:
        c = sb.WireClient(srv.addr)
        for cls in pools:
            for sql, ext, want in pools[cls]:
                for _ in range(2):
                    rows, code = c.query(sql)
                    assert code is None and rows == want, (sql, code)
        if args.profile:
            sql, ext, want = pools["scan"][0]
            prof = cProfile.Profile()
            per_op = {}
            for label, fn in (("simple", lambda: c.query(sql)),
                              ("extended", lambda: c.query_extended(*ext))):
                t0 = time.perf_counter()
                prof.enable()
                for _ in range(args.profile):
                    rows, code = fn()
                prof.disable()
                per_op[label] = (time.perf_counter() - t0) / args.profile
                assert code is None and rows == want
            print(f"one client, {len(want)} rows x {len(want[0])} columns "
                  f"an op: ms an op " + ", ".join(
                      f"{k} {v * 1e3:.3f}" for k, v in per_op.items()),
                  flush=True)
        c.close()
        for _ in range(args.pairs if args.intervals else 0):
            for iv in [float(x) for x in args.intervals.split(",")]:
                sys.setswitchinterval(iv)
                plans = cs.serve_mix(np.random.default_rng(7),
                                     cs.SERVE_CLIENTS, cs.SERVE_OPS, pools)
                for on in (False, True):
                    r = cs.serve_run(srv, plans, serving=on)
                    print(f"switch interval {iv} s:",
                          cs.serve_line("on" if on else "off", r),
                          flush=True)
    finally:
        srv.drain(timeout=10)
    if args.profile:
        stats = pstats.Stats(prof)
        names = {"_data_rows": "wire row encoding", "_render": "wire render",
                 "_read_result": "client decoding",
                 "_dispatch": "serving dispatch",
                 "match_bound_sql": "Bind re-match",
                 "execute": "Session.execute", "execute_spec":
                 "Session.execute_spec"}
        for (fname, _line, func), row in sorted(stats.stats.items()):
            if func in names and ("pgwire" in fname or "servebench" in fname
                                  or "serving" in fname
                                  or "session" in fname):
                print(f"  {names[func]} ({os.path.basename(fname)} "
                      f"{func}): {row[3]:.3f} s cumulative over "
                      f"{row[1]} calls", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

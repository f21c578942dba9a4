"""The port's concurrent serving bench (workload/servebench.py) on the
CPU: its pools are the JAX bench's, every pool query answers over the
port's wire as over the JAX package's (both servers over their own
`load_serving_catalog`, the same rows), the port's WireClient speaks to
the JAX server too, and `run` / `compare` at a small size verify every
answer with 0 mismatches and 0 errors, serving on and off."""

import pytest

from cockroach_tpu.sql.pgwire import PgServer as JPgServer
from cockroach_tpu.workload import servebench as jsb
from cockroach_tpu_torch.sql import serving
from cockroach_tpu_torch.sql.pgwire import PgServer
from cockroach_tpu_torch.util.settings import Settings
from cockroach_tpu_torch.workload import servebench as sb
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = ("ycsb", "agg", "topk", "execute", "tpch", "vector")


def test_pools_equal_jax():
    assert sb.query_pool() == jsb.query_pool()
    assert sb.execute_pool() == jsb.execute_pool()
    assert (sb.KV_ROWS, sb.LI_ROWS, sb.EMB_ROWS, sb.INSERT_BASE) == (
        jsb.KV_ROWS, jsb.LI_ROWS, jsb.EMB_ROWS, jsb.INSERT_BASE)


def test_pool_answers_equal_jax_over_the_wire():
    _js, jcat = jsb.load_serving_catalog()
    _ts, tcat = sb.load_serving_catalog(device="cpu")
    jsrv = JPgServer(jcat, capacity=256).start()
    try:
        tsrv = PgServer(tcat, capacity=256, device="cpu").start()
        try:
            jc, tc = sb.WireClient(jsrv.addr, timeout=30), \
                sb.WireClient(tsrv.addr, timeout=30)
            try:
                for _cls, sql in sb.query_pool():
                    want, got = jc.query(sql), tc.query(sql)
                    assert got == want and got[1] is None, sql
                for sql, tmpl, params in sb.execute_pool():
                    got = tc.query_extended(tmpl, params)
                    assert got == jc.query_extended(tmpl, params)
                    assert got == tc.query(sql)
            finally:
                jc.close()
                tc.close()
        finally:
            tsrv.drain(timeout=5)
    finally:
        jsrv.close()


@pytest.mark.parametrize("serving_on", [False, True])
def test_run_small_no_mismatches(serving_on):
    s = Settings()
    prev = s.get(serving.SERVING_ENABLED)
    r = sb.run(threads=3, ops_per_thread=8, serving=serving_on, seed=1,
               classes=CLASSES, device="cpu")
    assert s.get(serving.SERVING_ENABLED) == prev  # restored
    assert r["mismatches"] == 0 and r["errors"] == [], r
    assert r["ok"] == 24 and r["qps"] > 0
    assert set(r["latency"]) == set(CLASSES)
    if serving_on:
        sq = r["serving_queue"]
        assert sq["fallbacks"] == 0, sq
        assert sq["batched_dispatch_total"] >= 1, sq
    else:
        assert "serving_queue" not in r


def test_compare_small():
    out = sb.compare(threads=2, ops_per_thread=6, seed=2,
                     classes=("ycsb", "execute"), device="cpu")
    for side in ("unbatched", "batched"):
        assert out[side]["mismatches"] == 0 and out[side]["ok"] == 12
    assert out["speedup"] > 0

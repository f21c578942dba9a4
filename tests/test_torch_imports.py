"""The port stands alone: importing every module of cockroach_tpu_torch,
and chip_smoke.py, loads neither JAX, nor pyarrow, nor the JAX package
(chip_smoke.py imports the rest in main()); and an entry point
given no device raises when there is no CUDA device."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the modules of the sort-based GROUP BY, the joins, top-K, the
# expressions, DISTINCT, the planner (its statistics and
# decorrelation), the resident scan (memory accounting, the stopper
# of the prefetch threads, the scan-image cache), the fused runner
# (the group join, the bit-packing, the retry classifier and the
# breakers of the degradation ladder), the out-of-core paths and the
# invariants checker, and the SQL front end (parser, statement
# statistics, window functions, row engine, binder, cost model and
# placement, EXPLAIN, session, shell), and the storage layer (the
# clock, fault injection, the engines, the store, the resident tier
# and its visibility pass, YCSB), and the lifecycle seams (metrics,
# logging, tracing, cancellation, admission, the query registry,
# insights, the crdb_internal tables, the statement bundle), and
# streaming (rangefeeds, changefeeds, the view fold, materialized views)
# and vector search (the searchers, the vector bench): imported by name,
# so a module
# that goes missing fails here rather than being skipped by the package
# walk
SLICE_MODULES = ["ops.hash", "ops.prefix", "ops.search", "ops.rowmat",
                 "ops.hashtable", "ops.join", "ops.sortjoin", "ops.agg",
                 "ops.sort", "ops.expr", "ops.distinct", "exec.operators",
                 "sql.plan", "sql.stats", "workload.tpch_queries",
                 "util.mon", "util.stop", "exec.scan_cache",
                 "coldata.arrow", "util.settings", "ops.bitpack",
                 "ops.groupjoin", "exec.fused", "util.retry",
                 "util.circuit", "exec.spill", "exec.invariants",
                 "sql.parser", "sql.sqlstats", "ops.window",
                 "exec.rowexec", "sql.bind", "sql.cost",
                 "sql.plan_compile", "sql.explain", "sql.session", "cli",
                 "__main__", "util.hlc", "util.fault", "storage.engine",
                 "storage.mvcc", "storage.resident", "ops.mvcc_filter",
                 "workload.ycsb", "kv", "kv.txn", "kv.streamer", "server",
                 "server.jobs", "coldata.carry", "util.metric",
                 "util.log", "util.tracing", "util.cancel",
                 "util.admission", "server.registry", "sql.insights",
                 "sql.vtable", "server.debugzip", "kv.rangefeed",
                 "sql.changefeed", "ops.view_fold", "sql.matview",
                 "ops.vector", "workload.vectorbench"]


def test_port_imports_no_jax_pyarrow_or_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import cockroach_tpu_torch
        names = ["cockroach_tpu_torch"]
        names += ["cockroach_tpu_torch." + m for m in SLICE_MODULES]
        for m in pkgutil.walk_packages(cockroach_tpu_torch.__path__,
                                       "cockroach_tpu_torch."):
            names.append(m.name)
        names = list(dict.fromkeys(names))
        for n in names + ["chip_smoke"]:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pyarrow",
                                            "cockroach_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """).replace("SLICE_MODULES", repr(SLICE_MODULES))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 33, r.stdout


def test_collect_without_cuda_or_device_raises(monkeypatch):
    from cockroach_tpu_torch.exec import collect
    from cockroach_tpu_torch.workload.tpch import TPCH
    from cockroach_tpu_torch.workload.tpch_queries import q1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flow = q1(TPCH(sf=0.001), 1 << 12)
    with pytest.raises(RuntimeError, match="CUDA"):
        collect(flow)


def test_numpy_to_batch_without_cuda_or_device_raises(monkeypatch):
    import numpy as np

    from cockroach_tpu_torch.coldata.batch import INT, Field, Schema
    from cockroach_tpu_torch.coldata.arrow import numpy_to_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        numpy_to_batch({"a": np.arange(3)}, Schema([Field("a", INT)]))


def test_session_select_without_cuda_or_device_raises(monkeypatch):
    """A storage-backed session's DDL and DML are host work; its SELECT
    runs on the session's device, CUDA unless it was given one."""
    from cockroach_tpu_torch.sql.session import Session, SessionCatalog
    from cockroach_tpu_torch.storage.engine import PyEngine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sess = Session(SessionCatalog(MVCCStore(engine=PyEngine())))
    sess.execute("create table t (a int)")
    sess.execute("insert into t values (1)")
    with pytest.raises(RuntimeError, match="CUDA"):
        sess.execute("select a from t")


def test_tf32_is_off():
    import cockroach_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

"""Chaos on the port: TPC-H under seeded fault arming stays bit-exact.

The cases of tests/test_chaos.py at SF 0.01 on the CPU: Q1 under each
of `scan.transfer`, `scan.stack`, `fused.compile`, `fused.exec` and
`cache.insert` at probability 0.3, Q3 and Q18 under `scan.transfer` and
`fused.exec`, Q18's grace GROUP BY under the spill blocks' seams, a
forced fused out-of-memory and a one-shot streaming out-of-memory, each
result held to the JAX package's fault-free rows of the same query
(`collect(fuse=False)`, held bit for bit by tests/test_torch_q3_q18.py
and test_torch_q1.py). Where a point fired, in-place retries plus
ladder degradations are at least one (cache.insert is swallowed as a
miss by design). Every KNOWN_POINTS entry must have its `maybe_fail`
call in the port. The `cuda` twin runs the Q1 cases on a card."""

import os
import re

import numpy as np
import pytest
import torch

from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
from cockroach_tpu_torch.util import circuit
from cockroach_tpu_torch.util import retry
from cockroach_tpu_torch.util.fault import KNOWN_POINTS, registry
from cockroach_tpu_torch.util.metric import default_registry
from cockroach_tpu_torch.util.settings import WORKMEM, Settings
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from torch_threads import one_torch_thread  # noqa: F401

PROB = 0.3
SF = 0.01
CAPACITY = 1 << 13
Q18_THRESHOLD = 150
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _hygiene():
    """No sleeping through the backoffs; every case starts and ends with
    the breakers closed and nothing armed."""
    s = Settings()
    old = s.get(retry.RESILIENCE_INITIAL_BACKOFF)
    s.set(retry.RESILIENCE_INITIAL_BACKOFF, 0.0)
    circuit.reset_all()
    yield
    s.set(retry.RESILIENCE_INITIAL_BACKOFF, old)
    registry().disarm()
    circuit.reset_all()


def _flow(mod, gen, qn, capacity=CAPACITY):
    if qn == 18:
        return mod.q18(gen, Q18_THRESHOLD, capacity)
    return mod.QUERIES[qn](gen, capacity)


@pytest.fixture(scope="module")
def gens():
    return jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)


@pytest.fixture(scope="module")
def jax_rows(gens):
    """The JAX package's fault-free results."""
    return {qn: jcollect(_flow(jq, gens[0], qn), fuse=False)
            for qn in (1, 3, 18)}


def _assert_equal(want, got):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _counters():
    reg = default_registry()
    return (reg.counter("sql_resilience_retries_total").value(),
            reg.counter("sql_resilience_degradations_total").value())


def _chaos_run(make_flow, point, seed, device="cpu", prob=PROB, **kw):
    """(result under the armed point, fires, retries, degradations)."""
    reg = registry()
    reg.set_seed(seed)
    reg.arm(point, probability=prob, **kw)
    before = _counters()
    try:
        got = tcollect(make_flow(), device=device)
    finally:
        fires = reg.fires(point)
        reg.disarm(point)
    after = _counters()
    return got, fires, after[0] - before[0], after[1] - before[1]


Q1_POINTS = ["scan.transfer", "scan.stack", "fused.compile",
             "fused.exec", "cache.insert"]


@pytest.mark.parametrize("point", Q1_POINTS)
def test_q1_bit_exact_under_fault(gens, jax_rows, point):
    got, fires, retries, degr = _chaos_run(
        lambda: _flow(tq, gens[1], 1), point, seed=11)
    _assert_equal(jax_rows[1], got)
    if fires and point != "cache.insert":
        assert retries + degr >= 1
    if point == "cache.insert":
        return  # these flows carry no cache key: no insert
    # a one-shot fault on the seam's first pass: it must fire, be
    # absorbed, and leave the rows unchanged
    got, fires, retries, degr = _chaos_run(
        lambda: _flow(tq, gens[1], 1), point, seed=11, prob=0.0, after=0)
    _assert_equal(jax_rows[1], got)
    assert fires == 1 and retries + degr >= 1


@pytest.mark.parametrize("qn", [3, 18])
@pytest.mark.parametrize("point", ["scan.transfer", "fused.exec"])
def test_join_queries_bit_exact_under_fault(gens, jax_rows, qn, point):
    got, fires, retries, degr = _chaos_run(
        lambda: _flow(tq, gens[1], qn), point, seed=23 + qn)
    _assert_equal(jax_rows[qn], got)
    if fires:
        assert retries + degr >= 1
    got, fires, retries, degr = _chaos_run(
        lambda: _flow(tq, gens[1], qn), point, seed=23 + qn, prob=0.0,
        after=0)
    _assert_equal(jax_rows[qn], got)
    assert fires == 1 and retries + degr >= 1


@pytest.mark.parametrize("point", ["spill.block_write",
                                   "spill.block_read"])
def test_q18_grace_bit_exact_under_spill_fault(gens, jax_rows, point):
    """Q18 on the streaming tier under a 128 KiB workmem grace-spills; the
    block seams absorb their faults in place."""
    s = Settings()
    old = s.get(WORKMEM)
    s.set(WORKMEM, 1 << 17)
    try:
        with stats.query_stats() as col:
            reg = registry()
            reg.set_seed(42)
            reg.arm(point, probability=PROB)
            before = _counters()
            try:
                got = tcollect(_flow(tq, gens[1], 18), device="cpu",
                               fuse=False)
            finally:
                fires = reg.fires(point)
                reg.disarm(point)
    finally:
        s.set(WORKMEM, old)
    _assert_equal(jax_rows[18], got)
    assert "agg.grace_spill" in col.stages or \
        "join.grace_spill" in col.stages
    assert fires >= 1
    assert _counters()[0] - before[0] >= fires


def test_cache_insert_fault_is_a_miss(gens, jax_rows):
    """A failing insert leaves the scan's private image in place and
    counts `scan.cache_insert_fail`; the answer is unchanged."""
    from cockroach_tpu_torch.sql.plan import TPCHCatalog, build

    scan_image_cache().clear()
    cat = TPCHCatalog(gens[1])
    plan = tq.q1_plan(gens[1])
    registry().arm("cache.insert", probability=1.0)
    try:
        with stats.query_stats() as col:
            flow = build(plan, cat, CAPACITY)
            for op in _scans(flow):
                op.resident = True
            got = tcollect(flow, device="cpu")
    finally:
        fired = registry().fires("cache.insert")
        registry().disarm()
    assert fired >= 1
    assert col.stages["scan.cache_insert_fail"].events == fired
    assert len(scan_image_cache()) == 0
    _assert_equal(jax_rows[1], got)


def _scans(flow):
    from cockroach_tpu_torch.exec.operators import ScanOp, walk_operators

    return [op for op in walk_operators(flow) if isinstance(op, ScanOp)]


def _oom():
    return RuntimeError("RESOURCE_EXHAUSTED: injected device exhaustion")


def test_forced_fused_oom_degrades_and_completes(gens, jax_rows):
    """Every fused run runs out of device memory: the ladder steps down
    and the query completes on the streaming tier, never erroring."""
    registry().arm("fused.exec", probability=1.0, make=_oom)
    before = _counters()
    try:
        with stats.query_stats() as col:
            got = tcollect(_flow(tq, gens[1], 1), device="cpu")
    finally:
        registry().disarm()
    _assert_equal(jax_rows[1], got)
    assert "resilience.degrade.fused" in col.stages
    assert _counters()[1] - before[1] == 1


def test_forced_oom_completes_via_spill_tier(gens, jax_rows):
    """A one-shot out-of-memory in the streaming tier's first transfer
    steps the ladder down to the spill tier, which completes the query
    bit-exact."""
    scan_image_cache().clear()
    registry().arm("scan.transfer", after=0, make=_oom)
    before = _counters()
    try:
        with stats.query_stats() as col:
            got = tcollect(_flow(tq, gens[1], 18), device="cpu",
                           fuse=False)
    finally:
        fired = registry().fires("scan.transfer")
        registry().disarm()
    assert fired == 1
    _assert_equal(jax_rows[18], got)
    assert _counters()[1] - before[1] == 1
    assert "resilience.degrade.streaming" in col.stages


def test_known_points_are_wired():
    """Every KNOWN_POINTS entry has its maybe_fail call in the port."""
    src = []
    for root, _, files in os.walk(os.path.join(REPO,
                                               "cockroach_tpu_torch")):
        for f in files:
            if f.endswith(".py") and f != "fault.py":
                with open(os.path.join(root, f)) as fh:
                    src.append(fh.read())
    text = "\n".join(src)
    wired = set(re.findall(r'maybe_fail\("([a-z_.]+)"\)', text))
    assert set(KNOWN_POINTS) == wired
    assert len(KNOWN_POINTS) == 11


@pytest.mark.cuda
@pytest.mark.parametrize("point", Q1_POINTS)
def test_q1_bit_exact_under_fault_on_card(gens, point):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 14 runs the "
                    "chaos cases at SF 1 there)")
    want = tcollect(_flow(tq, gens[1], 1), device="cpu")
    got, fires, retries, degr = _chaos_run(
        lambda: _flow(tq, gens[1], 1), point, seed=11, device="cuda")
    _assert_equal(want, got)
    if fires and point != "cache.insert":
        assert retries + degr >= 1

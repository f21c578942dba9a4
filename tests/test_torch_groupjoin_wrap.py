"""Inputs on which the int-key GROUP BY and the group join once wrapped
(cockroach_tpu_torch/ops/groupjoin.py), through both tiers of the port.

- The running sums wrap: k = [0, 1, 2, 2], v = [2^62, 2^62, 1, 0].
  `int_key_aggregate` takes each group's total as its end lane's running
  sum less the one just before its run's head, exact mod 2^64, so group
  2 sums to 1. The JAX fused runner, whose previous end comes from a
  cummax over the running sums, gives another value there; nothing here
  is asserted about it.
- The key span wraps: keys spanning 2^63 or more make `khi - klo`
  negative in int64. The port raises the fallback flag (the ladder then
  restarts onto the general route), in the int-key GROUP BY (inputs 1
  and 2) and in the group join under a HashAggOp on an inner JoinOp
  (input 3). The JAX fused runner folds distinct keys together on these
  inputs; nothing here is asserted about it.

Each case runs `collect(fuse=True)` and `collect(fuse=False)` and holds
both to a numpy oracle, bit for bit; `cuda`-marked twins run the same
cases on a card and skip without one."""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.coldata.batch import INT, Field, Schema
from cockroach_tpu_torch.exec import collect
from cockroach_tpu_torch.exec import operators as ops
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.ops import groupjoin as gj
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.coldata.batch import Batch, Column
from torch_threads import one_torch_thread  # noqa: F401

MAX = (1 << 63) - 1

# (name, keys, values): SUM(v), COUNT(*) GROUP BY k
INT_KEY_CASES = [
    ("running_sum_wrap", [0, 1, 2, 2], [1 << 62, 1 << 62, 1, 0]),
    ("span_wrap_full", [-MAX, MAX, MAX], [1, 2, 4]),
    ("span_wrap_half", [-((1 << 62) + 5), (1 << 62) + 5, 0], [1, 2, 4]),
]
SPAN_WRAPS = {"span_wrap_full", "span_wrap_half"}


def _scan(data, capacity=8):
    n = len(next(iter(data.values())))
    cols = {k: np.asarray(v, dtype=np.int64) for k, v in data.items()}
    return ops.ScanOp(Schema([Field(k, INT) for k in cols]),
                      lambda: iter([cols]), max(capacity, n))


def _wrap64(x: int) -> int:
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def _oracle(rows):
    """{group key tuple: (sum mod 2^64 as int64, count)}."""
    out = {}
    for *key, v in rows:
        s, c = out.get(tuple(key), (0, 0))
        out[tuple(key)] = (s + v, c + 1)
    return {k: (_wrap64(s), c) for k, (s, c) in out.items()}


def _rows(res, keys):
    return {tuple(int(res[k][i]) for k in keys):
            (int(res["s"][i]), int(res["n"][i]))
            for i in range(len(res["s"]))}


def _int_key_flow(k, v):
    return ops.HashAggOp(_scan({"k": k, "v": v}), ["k"],
                         [AggSpec("sum", "v", "s"),
                          AggSpec("count_star", None, "n")])


def _join_flow():
    """Input 3: probe keys [-(2^63 - 1), 2^63 - 1, 2^63 - 1] with v =
    [1, 2, 4]; one build key, -(2^63 - 1), with its column `tag`."""
    probe = _scan({"fk": [-MAX, MAX, MAX], "v": [1, 2, 4]})
    build = _scan({"k": [-MAX], "tag": [7]})
    return ops.HashAggOp(
        ops.JoinOp(probe, build, ["fk"], ["k"], how="inner"),
        ["fk", "tag"],
        [AggSpec("sum", "v", "s"), AggSpec("count_star", None, "n")])


def _run_both_tiers(make_flow, device):
    """(fused rows, its restarts, its last routes, streaming rows)."""
    flow = make_flow()
    with stats.query_stats() as col:
        fused = collect(flow, device=device, fuse=True)
    st = col.stages.get("flow.restart")
    restarts = st.events if st else 0
    routes = dict(flow._fused_runner.last.get("routes", {}))
    streamed = collect(make_flow(), device=device, fuse=False)
    return fused, restarts, routes, streamed


def _check_int_key(name, k, v, device):
    fused, restarts, routes, streamed = _run_both_tiers(
        lambda: _int_key_flow(k, v), device)
    want = _oracle(list(zip(k, v)))
    assert _rows(fused, ["k"]) == want
    assert _rows(streamed, ["k"]) == want
    if name in SPAN_WRAPS:
        # the flag restarts the flow (u64 keys, then the route off)
        assert restarts >= 1 and "int_key" not in routes
    else:
        assert restarts == 0 and routes.get("int_key") == 1


def _check_join(device):
    fused, restarts, routes, streamed = _run_both_tiers(_join_flow, device)
    want = {(-MAX, 7): (1, 1)}
    assert _rows(fused, ["fk", "tag"]) == want
    assert _rows(streamed, ["fk", "tag"]) == want
    assert restarts >= 1 and "groupjoin" not in routes


@pytest.mark.parametrize("name,k,v", INT_KEY_CASES,
                         ids=[c[0] for c in INT_KEY_CASES])
def test_int_key_aggregate_both_tiers(name, k, v):
    _check_int_key(name, k, v, "cpu")


def test_groupjoin_span_wrap_both_tiers():
    _check_join("cpu")


@pytest.mark.parametrize("key64", [False, True], ids=["key32", "key64"])
@pytest.mark.parametrize("name,k,v", INT_KEY_CASES,
                         ids=[c[0] for c in INT_KEY_CASES])
def test_int_key_aggregate_flags(name, k, v, key64):
    """The function itself: the flag where the span wraps, and the
    oracle's sums where it does not."""
    b = Batch({"k": Column(torch.tensor(k, dtype=torch.int64), None),
               "v": Column(torch.tensor(v, dtype=torch.int64), None)},
              torch.ones(len(k), dtype=torch.bool),
              torch.tensor(len(k), dtype=torch.int32))
    res = gj.int_key_aggregate(b, "k", [AggSpec("sum", "v", "s"),
                                        AggSpec("count_star", None, "n")],
                               out_capacity=8, key64=key64)
    assert bool(res.fallback) == (name in SPAN_WRAPS)
    if name not in SPAN_WRAPS:
        out = res.batch
        got = {int(out.col("k").values[i]): (int(out.col("s").values[i]),
                                             int(out.col("n").values[i]))
               for i in range(out.capacity) if bool(out.sel[i])}
        assert got == {kk[0]: sv for kk, sv in
                       _oracle(list(zip(k, v))).items()}


@pytest.mark.parametrize("key64", [False, True], ids=["key32", "key64"])
def test_group_join_aggregate_flags_span_wrap(key64):
    def batch(cols):
        n = len(next(iter(cols.values())))
        return Batch({c: Column(torch.tensor(x, dtype=torch.int64), None)
                      for c, x in cols.items()},
                     torch.ones(n, dtype=torch.bool),
                     torch.tensor(n, dtype=torch.int32))

    res = gj.group_join_aggregate(
        batch({"fk": [-MAX, MAX, MAX], "v": [1, 2, 4]}),
        batch({"k": [-MAX], "tag": [7]}), "fk", "k", "fk", torch.int64,
        ["tag"], [AggSpec("sum", "v", "s")], 4, key64=key64)
    assert bool(res.fallback)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,v", INT_KEY_CASES,
                         ids=[c[0] for c in INT_KEY_CASES])
def test_int_key_aggregate_both_tiers_on_cuda(name, k, v):
    _need_card()
    _check_int_key(name, k, v, "cuda")


@pytest.mark.cuda
def test_groupjoin_span_wrap_both_tiers_on_cuda():
    _need_card()
    _check_join("cuda")

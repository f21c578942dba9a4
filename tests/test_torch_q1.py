"""TPC-H Q1 end to end: the port on the CPU against the JAX package.

The port's generator must equal the JAX package's array for array; the
port's Q1 (workload.tpch_queries.q1 -> exec.collect, device="cpu") must
equal the JAX collect and the numpy oracle in values, validity and row
order. Integer, decimal and dictionary-code columns match exactly; the
float32 avg columns match bit for bit too, since both packages divide
the same exact sums in the same order (sum / 10^scale, then / count)."""

import numpy as np
import pytest

from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 14


@pytest.fixture(scope="module")
def q1_results():
    jgen, tgen = jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)
    want = jcollect(jq.q1(jgen, CAPACITY), fuse=False)
    got = tcollect(tq.q1(tgen, CAPACITY), device="cpu", fuse=False)
    return want, got, jq.q1_oracle(jgen), tgen


@pytest.mark.parametrize("table", ["lineitem", "orders"])
def test_generator_matches_jax(table):
    jgen, tgen = jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)
    want, got = jgen.table(table), tgen.table(table)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert tgen.num_rows(table) == jgen.num_rows(table)
    js, ts = jgen.schema(table), tgen.schema(table)
    for jf, tf in zip(js, ts):
        assert (tf.name, tf.type.kind.value, tf.type.scale, tf.dict_ref,
                tf.wire) == (jf.name, jf.type.kind.value, jf.type.scale,
                             jf.dict_ref, jf.wire)
    for ref, d in js.dicts.items():
        np.testing.assert_array_equal(ts.dicts[ref], d)


def test_q1_matches_jax_collect(q1_results):
    want, got, _oracle, _gen = q1_results
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        # bit for bit: ints, decimals, dictionary codes, validity, and
        # the float32 averages
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        if got[name].dtype == np.float32:
            np.testing.assert_array_equal(got[name].view(np.int32),
                                          want[name].view(np.int32))


def test_q1_matches_oracle(q1_results):
    _want, got, oracle, gen = q1_results
    keys = [(int(a), int(b)) for a, b in zip(got["l_returnflag"],
                                             got["l_linestatus"])]
    assert sorted(keys) == sorted(oracle)
    rf = gen.schema("lineitem").dicts["l_returnflag"]
    ls = gen.schema("lineitem").dicts["l_linestatus"]
    assert keys == sorted(keys, key=lambda k: (rf[k[0]], ls[k[1]]))
    for i, k in enumerate(keys):
        o = oracle[k]
        assert (int(got["sum_qty"][i]), int(got["sum_base_price"][i]),
                int(got["sum_disc_price"][i]), int(got["sum_charge"][i]),
                int(got["count_order"][i])) == (o[0], o[1], o[2], o[3], o[7])
        # float32 mean of exact sums vs the float64 oracle mean
        for j, col in enumerate(("avg_qty", "avg_price", "avg_disc")):
            assert got[col][i] == pytest.approx(o[4 + j], rel=1e-6)
    for name, v in got.items():
        if name.endswith("__valid"):
            assert v.all(), name


def test_q1_oracle_columnar_matches_jax():
    jgen, tgen = jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)
    assert tq.q1_oracle_columnar(tgen) == jq.q1_oracle_columnar(jgen)


def test_q1_operator_tree():
    from cockroach_tpu_torch.exec.operators import (
        HashAggOp, MapOp, ScanOp, SortOp, walk_operators,
    )

    flow = tq.q1(ttpch.TPCH(sf=SF), CAPACITY)
    kinds = [type(op) for op in walk_operators(flow)]
    assert kinds == [SortOp, HashAggOp, MapOp, MapOp, ScanOp]
    assert flow.child.dense_sizes == [4, 3]


def test_q1_wide_sum_recombines(monkeypatch):
    """Past SF 40 the plan asks for the wide (hi/lo) charge sum; the port
    recombines it exactly. Forced here at SF 0.01 by the plan's rule."""
    gen = ttpch.TPCH(sf=SF)
    plain = tcollect(tq.q1(gen, CAPACITY), device="cpu", fuse=False)
    monkeypatch.setattr(gen, "sf", 41.0)
    wide = tcollect(tq.q1(gen, CAPACITY), device="cpu", fuse=False)
    assert [int(x) for x in wide["sum_charge"]] == \
        [int(x) for x in plain["sum_charge"]]

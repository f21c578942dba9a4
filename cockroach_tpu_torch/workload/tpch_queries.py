"""TPC-H queries as logical plans (sql/plan.py) + numpy oracles.

Counterpart of cockroach_tpu/workload/tpch_queries.py, for Q1: its plan,
its builder and its two numpy oracles. The oracles compute reference
answers on the same generated data.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cockroach_tpu_torch.coldata.batch import DECIMAL, INT
from cockroach_tpu_torch.exec.operators import Operator
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.ops.expr import BinOp, Cmp, Col, Lit
from cockroach_tpu_torch.ops.sort import SortKey
from cockroach_tpu_torch.sql.plan import (
    Aggregate, Filter, OrderBy, Project, Scan, TPCHCatalog, build,
)
from cockroach_tpu_torch.workload.tpch import TPCH, _days


def _build(gen: TPCH, plan, capacity: int, catalog=None) -> Operator:
    return build(plan, catalog or TPCHCatalog(gen), capacity)


# ------------------------------------------------------------------- Q1 ---

Q1_CUTOFF = _days(1998, 12, 1) - 90


def q1_plan(gen: TPCH):
    one = Lit(1.0, DECIMAL(2))
    disc_price = BinOp("*", Col("l_extendedprice"),
                       BinOp("-", one, Col("l_discount")))
    charge = BinOp("*", disc_price, BinOp("+", one, Col("l_tax")))
    line = Scan("lineitem", ("l_returnflag", "l_linestatus", "l_quantity",
                             "l_extendedprice", "l_discount", "l_tax",
                             "l_shipdate"))
    proj = Project(
        Filter(line, Cmp("<=", Col("l_shipdate"), Lit(Q1_CUTOFF, INT))),
        (("l_returnflag", Col("l_returnflag")),
         ("l_linestatus", Col("l_linestatus")),
         ("l_quantity", Col("l_quantity")),
         ("l_extendedprice", Col("l_extendedprice")),
         ("disc_price", disc_price),
         ("charge", charge),
         ("l_discount", Col("l_discount"))))
    # planner precision rule: charge (scale 6, ~1e11/row) overflows an
    # int64 group sum past SF~50 — wide (two-lane exact) accumulation
    # when the scale factor demands it (ops/agg.py)
    wide = gen.sf > 40
    agg = Aggregate(proj, ("l_returnflag", "l_linestatus"), (
        AggSpec("sum", "l_quantity", "sum_qty"),
        AggSpec("sum", "l_extendedprice", "sum_base_price"),
        AggSpec("sum", "disc_price", "sum_disc_price"),
        AggSpec("sum", "charge", "sum_charge", wide=wide),
        AggSpec("avg", "l_quantity", "avg_qty"),
        AggSpec("avg", "l_extendedprice", "avg_price"),
        AggSpec("avg", "l_discount", "avg_disc"),
        AggSpec("count_star", None, "count_order")))
    return OrderBy(agg, (SortKey("l_returnflag"), SortKey("l_linestatus")))


def q1(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q1_plan(gen), capacity, catalog)


def q1_oracle(gen: TPCH) -> Dict[tuple, tuple]:
    t = gen.table("lineitem")
    keep = t["l_shipdate"] <= Q1_CUTOFF
    rf, ls = t["l_returnflag"][keep], t["l_linestatus"][keep]
    qty = t["l_quantity"][keep].astype(np.int64)
    px = t["l_extendedprice"][keep].astype(np.int64)
    disc = t["l_discount"][keep].astype(np.int64)
    tax = t["l_tax"][keep].astype(np.int64)
    disc_price = px * (100 - disc)          # scale 4
    charge = disc_price * (100 + tax)       # scale 6
    out = {}
    for key in {(int(a), int(b)) for a, b in zip(rf, ls)}:
        m = (rf == key[0]) & (ls == key[1])
        out[key] = (
            int(qty[m].sum()), int(px[m].sum()), int(disc_price[m].sum()),
            int(charge[m].sum()),
            qty[m].mean() / 100, px[m].mean() / 100, disc[m].mean() / 100,
            int(m.sum()),
        )
    return out


def q1_oracle_columnar(gen: TPCH, chunks=None):
    """Vectorized numpy Q1 — the single-thread CPU columnar baseline
    (exact int64 sums; bincount-free because charge sums exceed float64's
    exact-integer range at SF>=1)."""
    if chunks is None:
        chunks = [gen.table("lineitem")]
    acc: Dict[tuple, list] = {}
    for c in chunks:
        keep = c["l_shipdate"] <= Q1_CUTOFF
        rf = c["l_returnflag"][keep]
        ls = c["l_linestatus"][keep]
        qty = c["l_quantity"][keep].astype(np.int64)
        px = c["l_extendedprice"][keep].astype(np.int64)
        disc = c["l_discount"][keep].astype(np.int64)
        tax = c["l_tax"][keep].astype(np.int64)
        disc_price = px * (100 - disc)
        charge = disc_price * (100 + tax)
        for a in np.unique(rf):
            for b in np.unique(ls):
                m = (rf == a) & (ls == b)
                if not m.any():
                    continue
                row = acc.setdefault((int(a), int(b)), [0] * 7)
                row[0] += int(qty[m].sum())
                row[1] += int(px[m].sum())
                row[2] += int(disc_price[m].sum())
                row[3] += int(charge[m].sum())
                row[4] += int(disc[m].sum())
                row[5] += int(m.sum())
    return {
        k: (v[0], v[1], v[2], v[3], v[0] / v[5] / 100, v[1] / v[5] / 100,
            v[4] / v[5] / 100, v[5])
        for k, v in sorted(acc.items())
    }

"""TPC-H queries as logical plans (sql/plan.py) + numpy oracles.

Counterpart of cockroach_tpu/workload/tpch_queries.py, for its fifteen
queries (QUERIES, PLANS): Q1, Q2, Q3, Q4, Q5, Q6, Q9, Q10, Q12, Q14,
Q15, Q16, Q17, Q18 and Q19. Each has its plan, its builder and its numpy
oracle; those whose row loop walks lineitem (Q1, Q3, Q5, Q9, Q10, Q12,
Q14, Q15, Q17, Q18) have a vectorized (columnar) oracle too. The oracles
compute reference answers on the same generated data; the columnar ones
run in seconds at SF 1, where the row loops take much longer.
"""

from __future__ import annotations

import datetime
import re
from typing import Dict

import numpy as np

from cockroach_tpu_torch.coldata.batch import DECIMAL, INT
from cockroach_tpu_torch.exec.operators import Operator
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.ops.expr import (
    BinOp, BoolOp, Case, Cmp, Col, Extract, InList, Like, Lit,
)
from cockroach_tpu_torch.ops.sort import SortKey
from cockroach_tpu_torch.sql.plan import (
    Aggregate, Apply, Distinct, Filter, Join, Limit, OrderBy, Project, Scan,
    TPCHCatalog, build,
)
from cockroach_tpu_torch.workload.tpch import TPCH, _days


def _build(gen: TPCH, plan, capacity: int, catalog=None) -> Operator:
    return build(plan, catalog or TPCHCatalog(gen), capacity)


def _code(gen: TPCH, table: str, col: str, value: str) -> int:
    """Dictionary code of a string literal (oracle-side pool lookup)."""
    pool = np.asarray(gen.schema(table).dicts[col], dtype=object)
    return int(np.nonzero(pool == value)[0][0])


def _rev_expr():
    """l_extendedprice * (1 - l_discount), the scale-4 revenue term."""
    return BinOp("*", Col("l_extendedprice"),
                 BinOp("-", Lit(1.0, DECIMAL(2)), Col("l_discount")))


def _lookup(keys: np.ndarray, values: np.ndarray, probe: np.ndarray):
    """values[i] where keys[i] == probe, for probe keys that all exist."""
    order = np.argsort(keys)
    return values[order][np.searchsorted(keys[order], probe)]


def _group_sums(keys: np.ndarray, values: np.ndarray) -> Dict[int, int]:
    """{key: exact int64 sum of its values}."""
    uk, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uk), np.int64)
    np.add.at(sums, inv, values)
    return {int(k): int(v) for k, v in zip(uk, sums)}


def name_rank(gen: TPCH, table: str, col: str) -> np.ndarray:
    """Each dictionary code's rank in name order: the order ORDER BY
    gives a dictionary column (ops/sort.py)."""
    d = gen.schema(table).dicts[col]
    return np.argsort(np.argsort(np.asarray(d).astype(str)))


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


# ------------------------------------------------------------------- Q6 ---

def q6_plan():
    line = Scan("lineitem", ("l_shipdate", "l_discount", "l_quantity",
                             "l_extendedprice"))
    filt = Filter(line, BoolOp("and", (
        Cmp(">=", Col("l_shipdate"), Lit(_days(1994, 1, 1), INT)),
        Cmp("<", Col("l_shipdate"), Lit(_days(1995, 1, 1), INT)),
        Cmp(">=", Col("l_discount"), Lit(0.05, DECIMAL(2))),
        Cmp("<=", Col("l_discount"), Lit(0.07, DECIMAL(2))),
        Cmp("<", Col("l_quantity"), Lit(24.0, DECIMAL(2))))))
    proj = Project(filt, (("rev", BinOp("*", Col("l_extendedprice"),
                                        Col("l_discount"))),))
    return Aggregate(proj, (), (AggSpec("sum", "rev", "revenue"),))


def q6(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q6_plan(), capacity, catalog)


def q6_oracle(gen: TPCH) -> int:
    t = gen.table("lineitem")
    keep = ((t["l_shipdate"] >= _days(1994, 1, 1))
            & (t["l_shipdate"] < _days(1995, 1, 1))
            & (t["l_discount"] >= 5) & (t["l_discount"] <= 7)
            & (t["l_quantity"] < 2400))
    return int((t["l_extendedprice"][keep] * t["l_discount"][keep]).sum())


# ------------------------------------------------------------------- Q3 ---

Q3_DATE = _days(1995, 3, 15)


def q3_plan():
    # filters written ABOVE the joins: normalize pushes each conjunct to
    # its side of the join and down to its scan
    cust = Project(Scan("customer", ("c_custkey", "c_mktsegment")),
                   (("c_custkey", Col("c_custkey")),
                    ("c_mktsegment", Col("c_mktsegment"))))
    orders = Scan("orders", ("o_orderkey", "o_custkey", "o_orderdate",
                             "o_shippriority"))
    orders_b = Filter(
        Join(orders, Filter(cust, Cmp("==", Col("c_mktsegment"),
                                      Lit("BUILDING"))),
             ("o_custkey",), ("c_custkey",), how="semi"),
        Cmp("<", Col("o_orderdate"), Lit(Q3_DATE, INT)))
    line = Project(
        Filter(Scan("lineitem", ("l_orderkey", "l_extendedprice",
                                 "l_discount", "l_shipdate")),
               Cmp(">", Col("l_shipdate"), Lit(Q3_DATE, INT))),
        (("l_orderkey", Col("l_orderkey")),
         ("rev", BinOp("*", Col("l_extendedprice"),
                       BinOp("-", Lit(1.0, DECIMAL(2)),
                             Col("l_discount"))))))
    joined = Join(line, orders_b, ("l_orderkey",), ("o_orderkey",))
    agg = Aggregate(joined,
                    ("l_orderkey", "o_orderdate", "o_shippriority"),
                    (AggSpec("sum", "rev", "revenue"),))
    return Limit(OrderBy(agg, (SortKey("revenue", descending=True),
                               SortKey("o_orderdate"))), 10)


def q3(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q3_plan(), capacity, catalog)


def q3_oracle(gen: TPCH):
    """[(l_orderkey, revenue, o_orderdate)] of the top 10, by row loops."""
    c = gen.table("customer")
    o = gen.table("orders")
    l = gen.table("lineitem")
    seg = gen.schema("customer").dicts["c_mktsegment"]
    seg_code = int(np.nonzero(seg == "BUILDING")[0][0])
    bcust = set(c["c_custkey"][c["c_mktsegment"] == seg_code].tolist())
    okeep = (o["o_orderdate"] < Q3_DATE) & np.isin(
        o["o_custkey"], np.fromiter(bcust, dtype=np.int64))
    odate = dict(zip(o["o_orderkey"][okeep].tolist(),
                     o["o_orderdate"][okeep].tolist()))
    lkeep = l["l_shipdate"] > Q3_DATE
    rev: Dict[int, int] = {}
    for ok, px, dc in zip(l["l_orderkey"][lkeep], l["l_extendedprice"][lkeep],
                          l["l_discount"][lkeep]):
        if int(ok) in odate:
            rev[int(ok)] = rev.get(int(ok), 0) + int(px) * (100 - int(dc))
    rows = [(-r, odate[k], k) for k, r in rev.items()]
    rows.sort()
    return [(k, -nr, od) for nr, od, k in rows[:10]]


def q3_oracle_columnar(gen: TPCH):
    """Vectorized numpy Q3: [(l_orderkey, revenue, o_orderdate,
    o_shippriority)] of the top 10 (searchsorted joins, exact int64 group
    sums)."""
    c, o, l = gen.table("customer"), gen.table("orders"), gen.table("lineitem")
    seg = gen.schema("customer").dicts["c_mktsegment"]
    code = int(np.nonzero(seg == "BUILDING")[0][0])
    bc = c["c_custkey"][c["c_mktsegment"] == code]
    o_keep = (o["o_orderdate"] < Q3_DATE) & np.isin(o["o_custkey"], bc)
    okey = o["o_orderkey"][o_keep]
    order = np.argsort(okey)
    okey_s = okey[order]
    odate_s = o["o_orderdate"][o_keep][order]
    oprio_s = o["o_shippriority"][o_keep][order]
    lk = l["l_shipdate"] > Q3_DATE
    lkey = l["l_orderkey"][lk]
    pos = np.searchsorted(okey_s, lkey)
    pos_c = np.minimum(pos, max(len(okey_s) - 1, 0))
    m = (okey_s[pos_c] == lkey) if len(okey_s) else np.zeros(len(lkey), bool)
    rev = (l["l_extendedprice"][lk][m].astype(np.int64)
           * (100 - l["l_discount"][lk][m].astype(np.int64)))
    uk, inv = np.unique(lkey[m], return_inverse=True)
    sums = np.zeros(len(uk), np.int64)
    np.add.at(sums, inv, rev)
    p2 = np.searchsorted(okey_s, uk)
    od, opr = odate_s[p2], oprio_s[p2]
    top = np.lexsort((uk, od, -sums))[:10]
    return [(int(uk[i]), int(sums[i]), int(od[i]), int(opr[i])) for i in top]


# ------------------------------------------------------------------ Q18 ---

def q18_plan(threshold: int = 300):
    big = Project(
        Filter(Aggregate(Scan("lineitem", ("l_orderkey", "l_quantity")),
                         ("l_orderkey",),
                         (AggSpec("sum", "l_quantity", "qty"),)),
               Cmp(">", Col("qty"), Lit(float(threshold), DECIMAL(2)))),
        (("big_okey", Col("l_orderkey")),))
    o_big = Join(Scan("orders", ("o_orderkey", "o_custkey", "o_orderdate",
                                 "o_totalprice")),
                 big, ("o_orderkey",), ("big_okey",), how="semi")
    oc = Join(o_big, Scan("customer", ("c_custkey", "c_name")),
              ("o_custkey",), ("c_custkey",))
    ol = Join(Scan("lineitem", ("l_orderkey", "l_quantity")), oc,
              ("l_orderkey",), ("o_orderkey",))
    agg = Aggregate(ol, ("c_name", "c_custkey", "o_orderkey",
                         "o_orderdate", "o_totalprice"),
                    (AggSpec("sum", "l_quantity", "sum_qty"),))
    return Limit(OrderBy(agg, (SortKey("o_totalprice", descending=True),
                               SortKey("o_orderdate"))), 100)


def q18(gen: TPCH, threshold: int = 300,
        capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q18_plan(threshold), capacity, catalog)


def q18_oracle(gen: TPCH, threshold: int = 300):
    """[(c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
    sum_qty)] of the top 100, by row loops."""
    o = gen.table("orders")
    l = gen.table("lineitem")
    c = gen.table("customer")
    qty: Dict[int, int] = {}
    for ok, q in zip(l["l_orderkey"].tolist(), l["l_quantity"].tolist()):
        qty[ok] = qty.get(ok, 0) + int(q)
    big = {k for k, v in qty.items() if v > threshold * 100}
    cname = dict(zip(c["c_custkey"].tolist(), c["c_name"].tolist()))
    rows = []
    for i in range(len(o["o_orderkey"])):
        ok = int(o["o_orderkey"][i])
        if ok in big:
            ck = int(o["o_custkey"][i])
            rows.append((-int(o["o_totalprice"][i]), int(o["o_orderdate"][i]),
                         int(cname[ck]), ck, ok, qty[ok]))
    rows.sort()
    return [(cn, ck, ok, od, -ntp, q)
            for ntp, od, cn, ck, ok, q in rows[:100]]


def q18_oracle_columnar(gen: TPCH, threshold: int = 300):
    """Vectorized numpy Q18, in q18_oracle's row form (exact int64
    quantity sums)."""
    o, l, c = gen.table("orders"), gen.table("lineitem"), gen.table("customer")
    lkeys = l["l_orderkey"]
    qty = np.zeros(int(lkeys.max()) + 1 if len(lkeys) else 0, np.int64)
    np.add.at(qty, lkeys, l["l_quantity"].astype(np.int64))
    okeys = o["o_orderkey"]
    in_range = okeys < len(qty)
    oq = np.zeros(len(okeys), np.int64)
    oq[in_range] = qty[okeys[in_range]]
    keep = oq > threshold * 100
    co = np.argsort(c["c_custkey"])
    cname = c["c_name"][co][
        np.searchsorted(c["c_custkey"][co], o["o_custkey"][keep])]
    ck = o["o_custkey"][keep]
    tp, od = o["o_totalprice"][keep], o["o_orderdate"][keep]
    ok, q = okeys[keep], oq[keep]
    top = np.lexsort((ok, ck, cname, od, -tp))[:100]
    return [(int(cname[i]), int(ck[i]), int(ok[i]), int(od[i]), int(tp[i]),
             int(q[i])) for i in top]


# ------------------------------------------------------------------- Q9 ---

def q9_plan():
    part = Project(Filter(Scan("part", ("p_partkey", "p_name")),
                          Like(Col("p_name"), "%green%")),
                   (("p_partkey", Col("p_partkey")),))
    l1 = Join(Scan("lineitem", ("l_orderkey", "l_partkey", "l_suppkey",
                                "l_quantity", "l_extendedprice",
                                "l_discount")),
              part, ("l_partkey",), ("p_partkey",), how="semi")
    l2 = Join(l1, Scan("supplier", ("s_suppkey", "s_nationkey")),
              ("l_suppkey",), ("s_suppkey",))
    l3 = Join(l2, Scan("partsupp", ("ps_partkey", "ps_suppkey",
                                    "ps_supplycost")),
              ("l_suppkey", "l_partkey"), ("ps_suppkey", "ps_partkey"))
    l4 = Join(l3, Scan("orders", ("o_orderkey", "o_orderdate")),
              ("l_orderkey",), ("o_orderkey",))
    l5 = Join(l4, Scan("nation", ("n_nationkey", "n_name")),
              ("s_nationkey",), ("n_nationkey",))
    # amount = l_extendedprice*(1-l_discount) - ps_supplycost*l_quantity
    # (both products are scale 2+2=4, so the subtraction aligns exactly)
    amount = BinOp("-",
                   BinOp("*", Col("l_extendedprice"),
                         BinOp("-", Lit(1.0, DECIMAL(2)),
                               Col("l_discount"))),
                   BinOp("*", Col("ps_supplycost"), Col("l_quantity")))
    proj = Project(l5, (("n_name", Col("n_name")),
                        ("o_year", Extract("year", Col("o_orderdate"))),
                        ("amount", amount)))
    agg = Aggregate(proj, ("n_name", "o_year"),
                    (AggSpec("sum", "amount", "sum_profit"),))
    return OrderBy(agg, (SortKey("n_name"),
                         SortKey("o_year", descending=True)))


def q9(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q9_plan(), capacity, catalog)


def q9_oracle(gen: TPCH):
    """{(nation name, year): scale-4 profit}, by row loops."""
    p = gen.table("part")
    s = gen.table("supplier")
    ps = gen.table("partsupp")
    o = gen.table("orders")
    l = gen.table("lineitem")
    pn = gen.schema("part").dicts["p_name"]
    green = np.array(["green" in str(x) for x in pn])
    greenparts = set(p["p_partkey"][green[p["p_name"]]].tolist())
    snation = dict(zip(s["s_suppkey"].tolist(), s["s_nationkey"].tolist()))
    pscost = {(int(a), int(b)): int(c) for a, b, c in
              zip(ps["ps_partkey"], ps["ps_suppkey"], ps["ps_supplycost"])}
    oyear = {}
    epoch = datetime.date(1970, 1, 1)
    for ok, od in zip(o["o_orderkey"].tolist(), o["o_orderdate"].tolist()):
        oyear[ok] = (epoch + datetime.timedelta(days=int(od))).year
    nnames = gen.schema("nation").dicts["n_name"]
    out: Dict[tuple, int] = {}
    for i in range(len(l["l_orderkey"])):
        pk = int(l["l_partkey"][i])
        if pk not in greenparts:
            continue
        sk = int(l["l_suppkey"][i])
        nat = str(nnames[snation[sk]])
        yr = oyear[int(l["l_orderkey"][i])]
        amt = (int(l["l_extendedprice"][i]) * (100 - int(l["l_discount"][i]))
               - pscost[(pk, sk)] * int(l["l_quantity"][i]))
        out[(nat, yr)] = out.get((nat, yr), 0) + amt
    return out


def q9_oracle_columnar(gen: TPCH):
    """Vectorized numpy Q9, in q9_oracle's form (exact int64 sums)."""
    p, s = gen.table("part"), gen.table("supplier")
    ps, o, l = gen.table("partsupp"), gen.table("orders"), gen.table("lineitem")
    pn = gen.schema("part").dicts["p_name"]
    green = np.array(["green" in str(x) for x in pn])
    greenp = p["p_partkey"][green[p["p_name"]]]
    lk = np.isin(l["l_partkey"], greenp)
    lpk, lsk = l["l_partkey"][lk], l["l_suppkey"][lk]
    nat = _lookup(s["s_suppkey"], s["s_nationkey"], lsk)
    pskey = ps["ps_partkey"].astype(np.int64) * (1 << 22) + ps["ps_suppkey"]
    cost = _lookup(pskey, ps["ps_supplycost"],
                   lpk.astype(np.int64) * (1 << 22) + lsk)
    odate = _lookup(o["o_orderkey"], o["o_orderdate"], l["l_orderkey"][lk])
    year = (odate.astype("datetime64[D]").astype("datetime64[Y]")
            .astype(np.int64) + 1970)
    amt = (l["l_extendedprice"][lk].astype(np.int64)
           * (100 - l["l_discount"][lk].astype(np.int64))
           - cost.astype(np.int64) * l["l_quantity"][lk].astype(np.int64))
    uk, inv = np.unique(nat.astype(np.int64) * 10000 + year,
                        return_inverse=True)
    sums = np.zeros(len(uk), np.int64)
    np.add.at(sums, inv, amt)
    nnames = gen.schema("nation").dicts["n_name"]
    return {(str(nnames[int(k // 10000)]), int(k % 10000)): int(v)
            for k, v in zip(uk, sums)}


# ------------------------------------------------------------------ Q12 ---
# Shipping modes and order priority: InList filter + CASE counts.

Q12_LO, Q12_HI = _days(1994, 1, 1), _days(1995, 1, 1)
_Q12_MODES = ("MAIL", "SHIP")
_Q12_URGENT = ("1-URGENT", "2-HIGH")


def q12_plan():
    line = Filter(
        Scan("lineitem", ("l_orderkey", "l_shipmode", "l_shipdate",
                          "l_commitdate", "l_receiptdate")),
        BoolOp("and", (InList(Col("l_shipmode"), _Q12_MODES),
                       Cmp("<", Col("l_commitdate"), Col("l_receiptdate")),
                       Cmp("<", Col("l_shipdate"), Col("l_commitdate")),
                       Cmp(">=", Col("l_receiptdate"), Lit(Q12_LO, INT)),
                       Cmp("<", Col("l_receiptdate"), Lit(Q12_HI, INT)))))
    joined = Join(line, Scan("orders", ("o_orderkey", "o_orderpriority")),
                  ("l_orderkey",), ("o_orderkey",))
    urgent = InList(Col("o_orderpriority"), _Q12_URGENT)
    proj = Project(joined, (
        ("l_shipmode", Col("l_shipmode")),
        ("high_line", Case(((urgent, Lit(1)),), otherwise=Lit(0))),
        ("low_line", Case(((urgent, Lit(0)),), otherwise=Lit(1)))))
    agg = Aggregate(proj, ("l_shipmode",),
                    (AggSpec("sum", "high_line", "high_line_count"),
                     AggSpec("sum", "low_line", "low_line_count")))
    return OrderBy(agg, (SortKey("l_shipmode"),))


def q12(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q12_plan(), capacity, catalog)


def _q12_keep(gen: TPCH, l):
    modes = [_code(gen, "lineitem", "l_shipmode", m) for m in _Q12_MODES]
    return (np.isin(l["l_shipmode"], np.asarray(modes, np.int64))
            & (l["l_commitdate"] < l["l_receiptdate"])
            & (l["l_shipdate"] < l["l_commitdate"])
            & (l["l_receiptdate"] >= Q12_LO)
            & (l["l_receiptdate"] < Q12_HI))


def q12_oracle(gen: TPCH) -> Dict[int, tuple]:
    """{l_shipmode code: (high_line_count, low_line_count)}, by row
    loops."""
    o, l = gen.table("orders"), gen.table("lineitem")
    urgent = {_code(gen, "orders", "o_orderpriority", p)
              for p in _Q12_URGENT}
    oprio = dict(zip(o["o_orderkey"].tolist(),
                     o["o_orderpriority"].tolist()))
    keep = _q12_keep(gen, l)
    out: Dict[int, list] = {}
    for ok, sm in zip(l["l_orderkey"][keep].tolist(),
                      l["l_shipmode"][keep].tolist()):
        row = out.setdefault(sm, [0, 0])
        row[0 if oprio[ok] in urgent else 1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def q12_oracle_columnar(gen: TPCH) -> Dict[int, tuple]:
    """Vectorized numpy Q12, in q12_oracle's form."""
    o, l = gen.table("orders"), gen.table("lineitem")
    urgent = [_code(gen, "orders", "o_orderpriority", p) for p in _Q12_URGENT]
    keep = _q12_keep(gen, l)
    prio = _lookup(o["o_orderkey"], o["o_orderpriority"],
                   l["l_orderkey"][keep])
    high = np.isin(prio, np.asarray(urgent, np.int64))
    mode = l["l_shipmode"][keep]
    return {int(m): (int((high & (mode == m)).sum()),
                     int((~high & (mode == m)).sum()))
            for m in np.unique(mode)}


# ------------------------------------------------------------------ Q14 ---
# Promotion effect: join + CASE'd conditional sum. The final percentage
# is left to the caller (sum ratios divide two scale-4 totals).

Q14_LO, Q14_HI = _days(1995, 9, 1), _days(1995, 10, 1)


def q14_plan():
    line = Filter(Scan("lineitem", ("l_partkey", "l_shipdate",
                                    "l_extendedprice", "l_discount")),
                  BoolOp("and", (Cmp(">=", Col("l_shipdate"),
                                     Lit(Q14_LO, INT)),
                                 Cmp("<", Col("l_shipdate"),
                                     Lit(Q14_HI, INT)))))
    joined = Join(line, Scan("part", ("p_partkey", "p_type")),
                  ("l_partkey",), ("p_partkey",))
    rev = _rev_expr()
    proj = Project(joined, (
        ("promo_rev", Case(((Like(Col("p_type"), "PROMO%"), rev),),
                           otherwise=Lit(0.0, DECIMAL(4)))),
        ("total_rev", rev)))
    return Aggregate(proj, (),
                     (AggSpec("sum", "promo_rev", "promo_revenue"),
                      AggSpec("sum", "total_rev", "total_revenue")))


def q14(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q14_plan(), capacity, catalog)


def _q14_promo(gen: TPCH) -> np.ndarray:
    types = np.asarray(gen.schema("part").dicts["p_type"], dtype=object)
    return np.array([str(t).startswith("PROMO") for t in types])


def q14_oracle(gen: TPCH) -> tuple:
    """(promo revenue, total revenue), scale 4, by row loops."""
    l, p = gen.table("lineitem"), gen.table("part")
    promo = _q14_promo(gen)
    ptype = dict(zip(p["p_partkey"].tolist(), p["p_type"].tolist()))
    keep = (l["l_shipdate"] >= Q14_LO) & (l["l_shipdate"] < Q14_HI)
    promo_rev = total = 0
    for pk, px, dc in zip(l["l_partkey"][keep].tolist(),
                          l["l_extendedprice"][keep].tolist(),
                          l["l_discount"][keep].tolist()):
        r = int(px) * (100 - int(dc))
        total += r
        if promo[ptype[pk]]:
            promo_rev += r
    return promo_rev, total


def q14_oracle_columnar(gen: TPCH) -> tuple:
    """Vectorized numpy Q14, in q14_oracle's form (exact int64 sums)."""
    l, p = gen.table("lineitem"), gen.table("part")
    keep = (l["l_shipdate"] >= Q14_LO) & (l["l_shipdate"] < Q14_HI)
    rev = (l["l_extendedprice"][keep].astype(np.int64)
           * (100 - l["l_discount"][keep].astype(np.int64)))
    ptype = _lookup(p["p_partkey"], p["p_type"], l["l_partkey"][keep])
    return int(rev[_q14_promo(gen)[ptype]].sum()), int(rev.sum())


# ------------------------------------------------------------------- Q2 ---
# Minimum-cost supplier: the canonical CORRELATED SCALAR subquery
# (ps_supplycost = MIN over the same partsupp join restricted to the
# part). Written as an Apply node; decorrelate() rewrites it into the
# join+aggregate form, and CSE dedups the shared partsupp subtree.

Q2_SIZE = 15


def q2_plan():
    europe = Project(Filter(Scan("region", ("r_regionkey", "r_name")),
                            Cmp("==", Col("r_name"), Lit("EUROPE"))),
                     (("r_regionkey", Col("r_regionkey")),))
    nations = Join(Scan("nation", ("n_nationkey", "n_name", "n_regionkey")),
                   europe, ("n_regionkey",), ("r_regionkey",), how="semi")
    supp = Join(Scan("supplier", ("s_suppkey", "s_name", "s_nationkey",
                                  "s_acctbal")),
                nations, ("s_nationkey",), ("n_nationkey",))
    ps = Join(Scan("partsupp", ("ps_partkey", "ps_suppkey",
                                "ps_supplycost")),
              supp, ("ps_suppkey",), ("s_suppkey",))
    parts = Filter(Scan("part", ("p_partkey", "p_mfgr", "p_size", "p_type")),
                   BoolOp("and", (Cmp("==", Col("p_size"), Lit(Q2_SIZE)),
                                  Like(Col("p_type"), "%BRASS"))))
    outer = Join(ps, parts, ("ps_partkey",), ("p_partkey",))
    sub = Project(ps, (("ps_partkey_", Col("ps_partkey")),
                       ("cost_", Col("ps_supplycost"))))
    ap = Apply(outer, sub, (("p_partkey", "ps_partkey_"),), kind="scalar",
               scalar=AggSpec("min", "cost_", "min_cost"))
    best = Filter(ap, Cmp("==", Col("ps_supplycost"), Col("min_cost")))
    proj = Project(best, (("s_acctbal", Col("s_acctbal")),
                          ("s_name", Col("s_name")),
                          ("n_name", Col("n_name")),
                          ("p_partkey", Col("p_partkey")),
                          ("p_mfgr", Col("p_mfgr")),
                          ("ps_supplycost", Col("ps_supplycost")),
                          ("s_suppkey", Col("s_suppkey"))))
    # s_suppkey appended to the spec's sort keys: (p_partkey, s_suppkey)
    # is unique, so the LIMIT boundary is deterministic vs the oracle
    return Limit(OrderBy(proj, (SortKey("s_acctbal", descending=True),
                                SortKey("n_name"), SortKey("s_name"),
                                SortKey("p_partkey"),
                                SortKey("s_suppkey"))), 100)


def q2(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q2_plan(), capacity, catalog)


def q2_oracle(gen: TPCH):
    """[(s_acctbal, s_name, n_name, p_partkey, p_mfgr, ps_supplycost,
    s_suppkey)] of the top 100, by row loops; n_name and s_name order by
    name, as ORDER BY orders a dictionary column."""
    r, n = gen.table("region"), gen.table("nation")
    s, ps, p = gen.table("supplier"), gen.table("partsupp"), gen.table("part")
    eu = _code(gen, "region", "r_name", "EUROPE")
    eu_reg = set(r["r_regionkey"][r["r_name"] == eu].tolist())
    eu_nat = {int(k) for k, rk in zip(n["n_nationkey"], n["n_regionkey"])
              if int(rk) in eu_reg}
    nname = dict(zip(n["n_nationkey"].tolist(), n["n_name"].tolist()))
    s_nat = dict(zip(s["s_suppkey"].tolist(), s["s_nationkey"].tolist()))
    s_bal = dict(zip(s["s_suppkey"].tolist(), s["s_acctbal"].tolist()))
    s_nm = dict(zip(s["s_suppkey"].tolist(), s["s_name"].tolist()))
    types = np.asarray(gen.schema("part").dicts["p_type"], dtype=object)
    brass = np.array([str(t).endswith("BRASS") for t in types])
    keepp = (p["p_size"] == Q2_SIZE) & brass[p["p_type"]]
    pmfgr = dict(zip(p["p_partkey"][keepp].tolist(),
                     p["p_mfgr"][keepp].tolist()))
    mincost: Dict[int, int] = {}
    for pk, sk, cost in zip(ps["ps_partkey"].tolist(),
                            ps["ps_suppkey"].tolist(),
                            ps["ps_supplycost"].tolist()):
        if s_nat[sk] in eu_nat:
            mincost[pk] = min(mincost.get(pk, 1 << 62), cost)
    nrank = name_rank(gen, "nation", "n_name")
    srank = name_rank(gen, "supplier", "s_name")
    rows = []
    for pk, sk, cost in zip(ps["ps_partkey"].tolist(),
                            ps["ps_suppkey"].tolist(),
                            ps["ps_supplycost"].tolist()):
        nk = s_nat[sk]
        if nk not in eu_nat or pk not in pmfgr or cost != mincost[pk]:
            continue
        nn, snm = nname[nk], s_nm[sk]
        rows.append((-s_bal[sk], nrank[nn], srank[snm], pk, sk, nn, snm,
                     cost))
    rows.sort()
    return [(-nb, snm, nn, pk, pmfgr[pk], cost, sk)
            for nb, _nr, _sr, pk, sk, nn, snm, cost in rows[:100]]


# ------------------------------------------------------------------- Q4 ---
# Order priority checking: EXISTS correlated subquery -> Apply node ->
# decorrelated into a SEMI join.

Q4_LO, Q4_HI = _days(1993, 7, 1), _days(1993, 10, 1)


def q4_plan():
    orders = Filter(
        Scan("orders", ("o_orderkey", "o_orderdate", "o_orderpriority")),
        BoolOp("and", (Cmp(">=", Col("o_orderdate"), Lit(Q4_LO, INT)),
                       Cmp("<", Col("o_orderdate"), Lit(Q4_HI, INT)))))
    late = Project(
        Filter(Scan("lineitem", ("l_orderkey", "l_commitdate",
                                 "l_receiptdate")),
               Cmp("<", Col("l_commitdate"), Col("l_receiptdate"))),
        (("l_orderkey", Col("l_orderkey")),))
    ap = Apply(orders, late, (("o_orderkey", "l_orderkey"),), kind="exists")
    agg = Aggregate(ap, ("o_orderpriority",),
                    (AggSpec("count_star", None, "order_count"),))
    # priority dict pool is ordered 1-URGENT..5-LOW: code order == text order
    return OrderBy(agg, (SortKey("o_orderpriority"),))


def q4(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q4_plan(), capacity, catalog)


def q4_oracle(gen: TPCH) -> Dict[int, int]:
    """{o_orderpriority code: order_count}, by row loops."""
    o, l = gen.table("orders"), gen.table("lineitem")
    late = set(l["l_orderkey"][
        l["l_commitdate"] < l["l_receiptdate"]].tolist())
    keep = (o["o_orderdate"] >= Q4_LO) & (o["o_orderdate"] < Q4_HI)
    out: Dict[int, int] = {}
    for ok, pr in zip(o["o_orderkey"][keep].tolist(),
                      o["o_orderpriority"][keep].tolist()):
        if ok in late:
            out[pr] = out.get(pr, 0) + 1
    return out


# ------------------------------------------------------------------- Q5 ---
# Local supplier volume: 6-way join where the c_nationkey==s_nationkey
# constraint rides as a second hash-join key pair.

Q5_LO, Q5_HI = _days(1994, 1, 1), _days(1995, 1, 1)


def q5_plan():
    asia = Project(Filter(Scan("region", ("r_regionkey", "r_name")),
                          Cmp("==", Col("r_name"), Lit("ASIA"))),
                   (("r_regionkey", Col("r_regionkey")),))
    nations = Join(Scan("nation", ("n_nationkey", "n_name", "n_regionkey")),
                   asia, ("n_regionkey",), ("r_regionkey",), how="semi")
    supp = Join(Scan("supplier", ("s_suppkey", "s_nationkey")), nations,
                ("s_nationkey",), ("n_nationkey",))
    orders = Filter(Scan("orders", ("o_orderkey", "o_custkey",
                                    "o_orderdate")),
                    BoolOp("and", (Cmp(">=", Col("o_orderdate"),
                                       Lit(Q5_LO, INT)),
                                   Cmp("<", Col("o_orderdate"),
                                       Lit(Q5_HI, INT)))))
    co = Join(orders, Scan("customer", ("c_custkey", "c_nationkey")),
              ("o_custkey",), ("c_custkey",))
    lo = Join(Scan("lineitem", ("l_orderkey", "l_suppkey",
                                "l_extendedprice", "l_discount")),
              co, ("l_orderkey",), ("o_orderkey",))
    # local-supplier constraint: join on BOTH suppkey and nationkey
    joined = Join(lo, supp, ("l_suppkey", "c_nationkey"),
                  ("s_suppkey", "s_nationkey"))
    proj = Project(joined, (("n_name", Col("n_name")),
                            ("rev", _rev_expr())))
    agg = Aggregate(proj, ("n_name",), (AggSpec("sum", "rev", "revenue"),))
    return OrderBy(agg, (SortKey("revenue", descending=True),
                         SortKey("n_name")))


def q5(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q5_plan(), capacity, catalog)


def q5_oracle(gen: TPCH) -> Dict[int, int]:
    """{n_name code: revenue}, scale 4, by row loops."""
    r, n, s = gen.table("region"), gen.table("nation"), gen.table("supplier")
    c, o, l = gen.table("customer"), gen.table("orders"), gen.table("lineitem")
    asia = _code(gen, "region", "r_name", "ASIA")
    regs = set(r["r_regionkey"][r["r_name"] == asia].tolist())
    nset = {int(k) for k, rk in zip(n["n_nationkey"], n["n_regionkey"])
            if int(rk) in regs}
    nname = dict(zip(n["n_nationkey"].tolist(), n["n_name"].tolist()))
    snat = dict(zip(s["s_suppkey"].tolist(), s["s_nationkey"].tolist()))
    cnat = dict(zip(c["c_custkey"].tolist(), c["c_nationkey"].tolist()))
    okeep = (o["o_orderdate"] >= Q5_LO) & (o["o_orderdate"] < Q5_HI)
    ocust = dict(zip(o["o_orderkey"][okeep].tolist(),
                     o["o_custkey"][okeep].tolist()))
    out: Dict[int, int] = {}
    for ok, sk, px, dc in zip(l["l_orderkey"].tolist(),
                              l["l_suppkey"].tolist(),
                              l["l_extendedprice"].tolist(),
                              l["l_discount"].tolist()):
        ck = ocust.get(int(ok))
        if ck is None:
            continue
        nk = snat[int(sk)]
        if nk not in nset or cnat[ck] != nk:
            continue
        key = int(nname[nk])
        out[key] = out.get(key, 0) + int(px) * (100 - int(dc))
    return out


def q5_oracle_columnar(gen: TPCH) -> Dict[int, int]:
    """Vectorized numpy Q5, in q5_oracle's form (exact int64 sums)."""
    r, n, s = gen.table("region"), gen.table("nation"), gen.table("supplier")
    c, o, l = gen.table("customer"), gen.table("orders"), gen.table("lineitem")
    asia = _code(gen, "region", "r_name", "ASIA")
    regs = r["r_regionkey"][r["r_name"] == asia]
    nset = n["n_nationkey"][np.isin(n["n_regionkey"], regs)]
    okeep = (o["o_orderdate"] >= Q5_LO) & (o["o_orderdate"] < Q5_HI)
    lo = np.isin(l["l_orderkey"], o["o_orderkey"][okeep])
    cust = _lookup(o["o_orderkey"], o["o_custkey"], l["l_orderkey"][lo])
    cnat = _lookup(c["c_custkey"], c["c_nationkey"], cust)
    snat = _lookup(s["s_suppkey"], s["s_nationkey"], l["l_suppkey"][lo])
    keep = (cnat == snat) & np.isin(snat, nset)
    rev = (l["l_extendedprice"][lo][keep].astype(np.int64)
           * (100 - l["l_discount"][lo][keep].astype(np.int64)))
    names = _lookup(n["n_nationkey"], n["n_name"], snat[keep])
    return _group_sums(names, rev)


# ------------------------------------------------------------------ Q10 ---
# Returned-item reporting: 4-way join + grouped agg + top-20.

Q10_LO, Q10_HI = _days(1993, 10, 1), _days(1994, 1, 1)


def q10_plan():
    orders = Filter(Scan("orders", ("o_orderkey", "o_custkey",
                                    "o_orderdate")),
                    BoolOp("and", (Cmp(">=", Col("o_orderdate"),
                                       Lit(Q10_LO, INT)),
                                   Cmp("<", Col("o_orderdate"),
                                       Lit(Q10_HI, INT)))))
    line = Filter(Scan("lineitem", ("l_orderkey", "l_returnflag",
                                    "l_extendedprice", "l_discount")),
                  Cmp("==", Col("l_returnflag"), Lit("R")))
    lo = Join(line, orders, ("l_orderkey",), ("o_orderkey",))
    cust = Join(Scan("customer", ("c_custkey", "c_name", "c_acctbal",
                                  "c_nationkey")),
                Scan("nation", ("n_nationkey", "n_name")),
                ("c_nationkey",), ("n_nationkey",))
    joined = Join(lo, cust, ("o_custkey",), ("c_custkey",))
    proj = Project(joined, (("c_custkey", Col("c_custkey")),
                            ("c_name", Col("c_name")),
                            ("c_acctbal", Col("c_acctbal")),
                            ("n_name", Col("n_name")),
                            ("rev", _rev_expr())))
    agg = Aggregate(proj, ("c_custkey", "c_name", "c_acctbal", "n_name"),
                    (AggSpec("sum", "rev", "revenue"),))
    # c_custkey tiebreak: group keys are unique per custkey, so the
    # LIMIT boundary is deterministic
    return Limit(OrderBy(agg, (SortKey("revenue", descending=True),
                               SortKey("c_custkey"))), 20)


def q10(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q10_plan(), capacity, catalog)


def q10_oracle(gen: TPCH):
    """[(c_custkey, c_name, c_acctbal, n_name, revenue)] of the top 20,
    by row loops."""
    c, o = gen.table("customer"), gen.table("orders")
    l, n = gen.table("lineitem"), gen.table("nation")
    rcode = _code(gen, "lineitem", "l_returnflag", "R")
    okeep = (o["o_orderdate"] >= Q10_LO) & (o["o_orderdate"] < Q10_HI)
    ocust = dict(zip(o["o_orderkey"][okeep].tolist(),
                     o["o_custkey"][okeep].tolist()))
    rev: Dict[int, int] = {}
    lkeep = l["l_returnflag"] == rcode
    for ok, px, dc in zip(l["l_orderkey"][lkeep].tolist(),
                          l["l_extendedprice"][lkeep].tolist(),
                          l["l_discount"][lkeep].tolist()):
        ck = ocust.get(int(ok))
        if ck is not None:
            rev[ck] = rev.get(ck, 0) + int(px) * (100 - int(dc))
    cinfo = {int(k): (int(nm), int(ab), int(nk)) for k, nm, ab, nk in
             zip(c["c_custkey"], c["c_name"], c["c_acctbal"],
                 c["c_nationkey"])}
    nname = dict(zip(n["n_nationkey"].tolist(), n["n_name"].tolist()))
    rows = sorted((-r, ck) for ck, r in rev.items())[:20]
    return [(ck, cinfo[ck][0], cinfo[ck][1], nname[cinfo[ck][2]], -nr)
            for nr, ck in rows]


def q10_oracle_columnar(gen: TPCH):
    """Vectorized numpy Q10, in q10_oracle's form (exact int64 sums)."""
    c, o = gen.table("customer"), gen.table("orders")
    l, n = gen.table("lineitem"), gen.table("nation")
    rcode = _code(gen, "lineitem", "l_returnflag", "R")
    okeep = (o["o_orderdate"] >= Q10_LO) & (o["o_orderdate"] < Q10_HI)
    lk = (l["l_returnflag"] == rcode) & np.isin(l["l_orderkey"],
                                                o["o_orderkey"][okeep])
    cust = _lookup(o["o_orderkey"], o["o_custkey"], l["l_orderkey"][lk])
    rev = (l["l_extendedprice"][lk].astype(np.int64)
           * (100 - l["l_discount"][lk].astype(np.int64)))
    sums = _group_sums(cust, rev)
    ck = np.fromiter(sums, dtype=np.int64, count=len(sums))
    tot = np.fromiter(sums.values(), dtype=np.int64, count=len(sums))
    top = np.lexsort((ck, -tot))[:20]
    ck, tot = ck[top], tot[top]
    name = _lookup(c["c_custkey"], c["c_name"], ck)
    bal = _lookup(c["c_custkey"], c["c_acctbal"], ck)
    nat = _lookup(n["n_nationkey"], n["n_name"],
                  _lookup(c["c_custkey"], c["c_nationkey"], ck))
    return [(int(a), int(b), int(x), int(y), int(z))
            for a, b, x, y, z in zip(ck, name, bal, nat, tot)]


# ------------------------------------------------------------------ Q15 ---
# Top supplier: UNCORRELATED scalar subquery (max over the revenue view)
# via an Apply with empty correlation; CSE builds the revenue aggregate
# ONCE for both the outer reference and the max.

Q15_LO, Q15_HI = _days(1996, 1, 1), _days(1996, 4, 1)


def q15_plan():
    rev = Aggregate(
        Project(Filter(Scan("lineitem", ("l_suppkey", "l_shipdate",
                                         "l_extendedprice", "l_discount")),
                       BoolOp("and", (Cmp(">=", Col("l_shipdate"),
                                          Lit(Q15_LO, INT)),
                                      Cmp("<", Col("l_shipdate"),
                                          Lit(Q15_HI, INT))))),
                (("l_suppkey", Col("l_suppkey")), ("rev", _rev_expr()))),
        ("l_suppkey",), (AggSpec("sum", "rev", "total_revenue"),))
    best = Apply(rev, rev, (), kind="scalar",
                 scalar=AggSpec("max", "total_revenue", "max_rev"))
    top = Filter(best, Cmp("==", Col("total_revenue"), Col("max_rev")))
    joined = Join(Scan("supplier", ("s_suppkey", "s_name")), top,
                  ("s_suppkey",), ("l_suppkey",))
    proj = Project(joined, (("s_suppkey", Col("s_suppkey")),
                            ("s_name", Col("s_name")),
                            ("total_revenue", Col("total_revenue"))))
    return OrderBy(proj, (SortKey("s_suppkey"),))


def q15(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q15_plan(), capacity, catalog)


def q15_oracle(gen: TPCH):
    """[(s_suppkey, s_name, total_revenue)] of the top suppliers, by
    row loops."""
    l, s = gen.table("lineitem"), gen.table("supplier")
    keep = (l["l_shipdate"] >= Q15_LO) & (l["l_shipdate"] < Q15_HI)
    rev: Dict[int, int] = {}
    for sk, px, dc in zip(l["l_suppkey"][keep].tolist(),
                          l["l_extendedprice"][keep].tolist(),
                          l["l_discount"][keep].tolist()):
        rev[sk] = rev.get(sk, 0) + int(px) * (100 - int(dc))
    best = max(rev.values())
    sname = dict(zip(s["s_suppkey"].tolist(), s["s_name"].tolist()))
    return sorted((sk, sname[sk], r) for sk, r in rev.items() if r == best)


def q15_oracle_columnar(gen: TPCH):
    """Vectorized numpy Q15, in q15_oracle's form (exact int64 sums)."""
    l, s = gen.table("lineitem"), gen.table("supplier")
    keep = (l["l_shipdate"] >= Q15_LO) & (l["l_shipdate"] < Q15_HI)
    rev = (l["l_extendedprice"][keep].astype(np.int64)
           * (100 - l["l_discount"][keep].astype(np.int64)))
    sums = _group_sums(l["l_suppkey"][keep], rev)
    best = max(sums.values())
    sk = np.asarray(sorted(k for k, v in sums.items() if v == best),
                    dtype=np.int64)
    names = _lookup(s["s_suppkey"], s["s_name"], sk)
    return [(int(k), int(nm), best) for k, nm in zip(sk, names)]


# ------------------------------------------------------------------ Q16 ---
# Parts/supplier relationship: NOT LIKE, anti join against complaining
# suppliers, and COUNT(DISTINCT) via an explicit Distinct node.

_Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)


def q16_plan():
    parts = Filter(
        Scan("part", ("p_partkey", "p_brand", "p_type", "p_size")),
        BoolOp("and", (Cmp("!=", Col("p_brand"), Lit("Brand#45")),
                       Like(Col("p_type"), "MEDIUM POLISHED%", negate=True),
                       InList(Col("p_size"), _Q16_SIZES))))
    bad = Project(Filter(Scan("supplier", ("s_suppkey", "s_comment")),
                         Like(Col("s_comment"), "%Customer%Complaints%")),
                  (("bad_sk", Col("s_suppkey")),))
    ps = Join(Scan("partsupp", ("ps_partkey", "ps_suppkey")), bad,
              ("ps_suppkey",), ("bad_sk",), how="anti")
    joined = Join(ps, parts, ("ps_partkey",), ("p_partkey",))
    dist = Distinct(joined, ("p_brand", "p_type", "p_size", "ps_suppkey"))
    agg = Aggregate(dist, ("p_brand", "p_type", "p_size"),
                    (AggSpec("count_star", None, "supplier_cnt"),))
    return OrderBy(agg, (SortKey("supplier_cnt", descending=True),
                         SortKey("p_brand"), SortKey("p_type"),
                         SortKey("p_size")))


def q16(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q16_plan(), capacity, catalog)


def q16_oracle(gen: TPCH) -> Dict[tuple, int]:
    """{(p_brand, p_type, p_size): supplier_cnt}, by row loops."""
    p, ps, s = gen.table("part"), gen.table("partsupp"), gen.table("supplier")
    b45 = _code(gen, "part", "p_brand", "Brand#45")
    types = np.asarray(gen.schema("part").dicts["p_type"], dtype=object)
    medpol = np.array([str(t).startswith("MEDIUM POLISHED") for t in types])
    keepp = ((p["p_brand"] != b45) & ~medpol[p["p_type"]]
             & np.isin(p["p_size"], np.asarray(_Q16_SIZES)))
    pinfo = {int(pk): (int(b), int(t), int(z)) for pk, b, t, z in
             zip(p["p_partkey"][keepp], p["p_brand"][keepp],
                 p["p_type"][keepp], p["p_size"][keepp])}
    comments = np.asarray(gen.schema("supplier").dicts["s_comment"],
                          dtype=object)
    badc = np.array([re.search("Customer.*Complaints", str(x)) is not None
                     for x in comments])
    bad = set(s["s_suppkey"][badc[s["s_comment"]]].tolist())
    seen = set()
    for pk, sk in zip(ps["ps_partkey"].tolist(), ps["ps_suppkey"].tolist()):
        if sk in bad:
            continue
        info = pinfo.get(pk)
        if info is not None:
            seen.add((info, sk))
    out: Dict[tuple, int] = {}
    for info, _sk in seen:
        out[info] = out.get(info, 0) + 1
    return out


# ------------------------------------------------------------------ Q17 ---
# Small-quantity-order revenue: correlated AVG rewritten exactly in
# integers — qty < 0.2*avg(qty)  <=>  5*qty*count < sum(qty) — so the
# decorrelated join+agg form needs no division and stays bit-exact.

def q17_plan():
    parts = Project(
        Filter(Scan("part", ("p_partkey", "p_brand", "p_container")),
               BoolOp("and", (Cmp("==", Col("p_brand"), Lit("Brand#23")),
                              Cmp("==", Col("p_container"),
                                  Lit("MED BOX"))))),
        (("p_partkey", Col("p_partkey")),))
    line = Join(Scan("lineitem", ("l_partkey", "l_quantity",
                                  "l_extendedprice")),
                parts, ("l_partkey",), ("p_partkey",), how="semi")
    per_part = Project(
        Aggregate(Scan("lineitem", ("l_partkey", "l_quantity")),
                  ("l_partkey",),
                  (AggSpec("sum", "l_quantity", "qty_sum"),
                   AggSpec("count_star", None, "qty_n"))),
        (("pp_partkey", Col("l_partkey")), ("qty_sum", Col("qty_sum")),
         ("qty_n", Col("qty_n"))))
    joined = Join(line, per_part, ("l_partkey",), ("pp_partkey",))
    small = Filter(joined,
                   Cmp("<", BinOp("*", BinOp("*", Lit(5),
                                              Col("l_quantity")),
                                  Col("qty_n")),
                       Col("qty_sum")))
    return Aggregate(small, (),
                     (AggSpec("sum", "l_extendedprice", "sum_price"),))


def q17(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q17_plan(), capacity, catalog)


def q17_oracle(gen: TPCH) -> int:
    """sum(l_extendedprice), scale 2, by row loops."""
    l, p = gen.table("lineitem"), gen.table("part")
    b = _code(gen, "part", "p_brand", "Brand#23")
    cont = _code(gen, "part", "p_container", "MED BOX")
    target = set(p["p_partkey"][(p["p_brand"] == b)
                                & (p["p_container"] == cont)].tolist())
    qsum: Dict[int, int] = {}
    qn: Dict[int, int] = {}
    for pk, q in zip(l["l_partkey"].tolist(), l["l_quantity"].tolist()):
        qsum[pk] = qsum.get(pk, 0) + int(q)
        qn[pk] = qn.get(pk, 0) + 1
    tot = 0
    for pk, q, px in zip(l["l_partkey"].tolist(), l["l_quantity"].tolist(),
                         l["l_extendedprice"].tolist()):
        if pk in target and 5 * int(q) * qn[pk] < qsum[pk]:
            tot += int(px)
    return tot


def q17_oracle_columnar(gen: TPCH) -> int:
    """Vectorized numpy Q17, q17_oracle's sum."""
    l, p = gen.table("lineitem"), gen.table("part")
    b = _code(gen, "part", "p_brand", "Brand#23")
    cont = _code(gen, "part", "p_container", "MED BOX")
    target = p["p_partkey"][(p["p_brand"] == b) & (p["p_container"] == cont)]
    pk = l["l_partkey"].astype(np.int64)
    q = l["l_quantity"].astype(np.int64)
    qsum = np.zeros(int(pk.max()) + 1 if len(pk) else 0, np.int64)
    np.add.at(qsum, pk, q)
    qn = np.bincount(pk, minlength=len(qsum)).astype(np.int64)
    keep = np.isin(pk, target) & (5 * q * qn[pk] < qsum[pk])
    return int(l["l_extendedprice"][keep].astype(np.int64).sum())


# ------------------------------------------------------------------ Q19 ---
# Discounted revenue: the big disjunctive (OR-of-ANDs) predicate over a
# join — one fused filter, no plan-level union.

def q19_plan():
    line = Filter(
        Scan("lineitem", ("l_partkey", "l_quantity", "l_extendedprice",
                          "l_discount", "l_shipmode", "l_shipinstruct")),
        BoolOp("and", (InList(Col("l_shipmode"), ("AIR", "REG AIR")),
                       Cmp("==", Col("l_shipinstruct"),
                           Lit("DELIVER IN PERSON")))))
    joined = Join(line, Scan("part", ("p_partkey", "p_brand",
                                      "p_container", "p_size")),
                  ("l_partkey",), ("p_partkey",))

    def branch(brand, conts, qlo, qhi, smax):
        return BoolOp("and", (
            Cmp("==", Col("p_brand"), Lit(brand)),
            InList(Col("p_container"), conts),
            Cmp(">=", Col("l_quantity"), Lit(float(qlo), DECIMAL(2))),
            Cmp("<=", Col("l_quantity"), Lit(float(qhi), DECIMAL(2))),
            Cmp(">=", Col("p_size"), Lit(1)),
            Cmp("<=", Col("p_size"), Lit(smax))))

    filt = Filter(joined, BoolOp("or", (
        branch("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
               1, 11, 5),
        branch("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
               10, 20, 10),
        branch("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
               20, 30, 15))))
    proj = Project(filt, (("rev", _rev_expr()),))
    return Aggregate(proj, (), (AggSpec("sum", "rev", "revenue"),))


def q19(gen: TPCH, capacity: int = 1 << 17, catalog=None) -> Operator:
    return _build(gen, q19_plan(), capacity, catalog)


def q19_oracle(gen: TPCH) -> int:
    """The revenue sum, scale 4 (vectorized: one pass over lineitem)."""
    l, p = gen.table("lineitem"), gen.table("part")
    modes = {_code(gen, "lineitem", "l_shipmode", m)
             for m in ("AIR", "REG AIR")}
    instr = _code(gen, "lineitem", "l_shipinstruct", "DELIVER IN PERSON")
    po = np.argsort(p["p_partkey"])
    idx = np.searchsorted(p["p_partkey"][po], l["l_partkey"])
    brand = p["p_brand"][po][idx]
    cont = p["p_container"][po][idx]
    size = p["p_size"][po][idx]
    qty = l["l_quantity"]

    def codes(col, names):
        return np.asarray([_code(gen, "part", col, nm) for nm in names])

    b12 = _code(gen, "part", "p_brand", "Brand#12")
    b23 = _code(gen, "part", "p_brand", "Brand#23")
    b34 = _code(gen, "part", "p_brand", "Brand#34")
    sm = codes("p_container", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"))
    med = codes("p_container", ("MED BAG", "MED BOX", "MED PKG",
                                "MED PACK"))
    lg = codes("p_container", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))
    common = (np.isin(l["l_shipmode"],
                      np.fromiter(modes, dtype=np.int64))
              & (l["l_shipinstruct"] == instr))
    k1 = ((brand == b12) & np.isin(cont, sm)
          & (qty >= 100) & (qty <= 1100) & (size >= 1) & (size <= 5))
    k2 = ((brand == b23) & np.isin(cont, med)
          & (qty >= 1000) & (qty <= 2000) & (size >= 1) & (size <= 10))
    k3 = ((brand == b34) & np.isin(cont, lg)
          & (qty >= 2000) & (qty <= 3000) & (size >= 1) & (size <= 15))
    keep = common & (k1 | k2 | k3)
    return int((l["l_extendedprice"][keep].astype(np.int64)
                * (100 - l["l_discount"][keep].astype(np.int64))).sum())


QUERIES = {1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 9: q9, 10: q10,
           12: q12, 14: q14, 15: q15, 16: q16, 17: q17, 18: q18, 19: q19}

# logical-plan constructors, one gen -> Plan signature for all
PLANS = {
    1: q1_plan,
    2: lambda gen: q2_plan(),
    3: lambda gen: q3_plan(),
    4: lambda gen: q4_plan(),
    5: lambda gen: q5_plan(),
    6: lambda gen: q6_plan(),
    9: lambda gen: q9_plan(),
    10: lambda gen: q10_plan(),
    12: lambda gen: q12_plan(),
    14: lambda gen: q14_plan(),
    15: lambda gen: q15_plan(),
    16: lambda gen: q16_plan(),
    17: lambda gen: q17_plan(),
    18: lambda gen: q18_plan(),
    19: lambda gen: q19_plan(),
}


# ---------------------------------------------------------------- SQL text
# The SQL texts the port's front end runs (sql/bind.py run_sql,
# sql/session.py Session). SQL[q] binds and runs: the texts of Q1, Q3,
# Q6, Q9 and Q18 are tests/test_sql.py's module constants, those of Q5,
# Q10, Q12 and Q14 the `sql` strings of tests/test_sql_more.py, letter
# for letter (Q18's threshold is a {threshold} field), and Q16's is the
# standard TPC-H text. SQL_REJECTED[q] is standard TPC-H text that the
# binder rejects, as the JAX package's does: Q2's correlated MIN and
# Q17's correlated AVG do not parse, Q4's EXISTS and Q19's join inside
# an OR do not bind, and Q15's WITH view does not parse.

SQL = {
    1: """
select l_returnflag, l_linestatus,
       sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty,
       avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc,
       count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    3: """
select l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
""",
    5: """
    select n_name,
           sum(l_extendedprice * (1 - l_discount)) as revenue
    from customer, orders, lineitem, supplier, nation, region
    where c_custkey = o_custkey
      and l_orderkey = o_orderkey
      and l_suppkey = s_suppkey
      and c_nationkey = s_nationkey
      and s_nationkey = n_nationkey
      and n_regionkey = r_regionkey
      and r_name = 'ASIA'
      and o_orderdate >= date '1994-01-01'
      and o_orderdate < date '1995-01-01'
    group by n_name
    order by revenue desc
    """,
    6: """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
""",
    9: """
select n_name as nation,
       extract(year from o_orderdate) as o_year,
       sum(l_extendedprice * (1 - l_discount)
           - ps_supplycost * l_quantity) as sum_profit
from part, supplier, lineitem, partsupp, orders, nation
where s_suppkey = l_suppkey
  and ps_suppkey = l_suppkey
  and ps_partkey = l_partkey
  and p_partkey = l_partkey
  and o_orderkey = l_orderkey
  and s_nationkey = n_nationkey
  and p_name like '%green%'
group by nation, o_year
order by nation, o_year desc
""",
    10: """
    select c_custkey, c_name,
           sum(l_extendedprice * (1 - l_discount)) as revenue,
           c_acctbal, n_name
    from customer, orders, lineitem, nation
    where c_custkey = o_custkey
      and l_orderkey = o_orderkey
      and o_orderdate >= date '1993-10-01'
      and o_orderdate < date '1994-01-01'
      and l_returnflag = 'R'
      and c_nationkey = n_nationkey
    group by c_custkey, c_name, c_acctbal, n_name
    order by revenue desc
    limit 20
    """,
    12: """
    select l_shipmode,
           sum(case when o_orderpriority = '1-URGENT'
                     or o_orderpriority = '2-HIGH'
                    then 1 else 0 end) as high_line_count,
           sum(case when o_orderpriority <> '1-URGENT'
                    and o_orderpriority <> '2-HIGH'
                    then 1 else 0 end) as low_line_count
    from orders, lineitem
    where o_orderkey = l_orderkey
      and l_shipmode in ('MAIL', 'SHIP')
      and l_commitdate < l_receiptdate
      and l_shipdate < l_commitdate
      and l_receiptdate >= date '1994-01-01'
      and l_receiptdate < date '1995-01-01'
    group by l_shipmode
    order by l_shipmode
    """,
    14: """
    select sum(case when p_type like 'PROMO%'
                    then l_extendedprice * (1 - l_discount)
                    else 0 end) as promo,
           sum(l_extendedprice * (1 - l_discount)) as total
    from lineitem, part
    where l_partkey = p_partkey
      and l_shipdate >= date '1995-09-01'
      and l_shipdate < date '1995-10-01'
    """,
    16: """
select p_brand, p_type, p_size,
       count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey
  and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
        select s_suppkey from supplier
        where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
""",
    18: """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity) as sum_qty
from customer, orders, lineitem
where o_orderkey in (
        select l_orderkey from lineitem
        group by l_orderkey having sum(l_quantity) > {threshold})
  and c_custkey = o_custkey
  and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
""",
}

SQL_REJECTED = {
    2: """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
       s_phone, s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey
  and s_suppkey = ps_suppkey
  and p_size = 15
  and p_type like '%BRASS'
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (
        select min(ps_supplycost)
        from partsupp, supplier, nation, region
        where p_partkey = ps_partkey
          and s_suppkey = ps_suppkey
          and s_nationkey = n_nationkey
          and n_regionkey = r_regionkey
          and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
""",
    4: """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (
        select * from lineitem
        where l_orderkey = o_orderkey
          and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
""",
    15: """
with revenue0 as (
        select l_suppkey as supplier_no,
               sum(l_extendedprice * (1 - l_discount)) as total_revenue
        from lineitem
        where l_shipdate >= date '1996-01-01'
          and l_shipdate < date '1996-01-01' + interval '3' month
        group by l_suppkey)
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue0
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue0)
order by s_suppkey
""",
    17: """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey
  and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity < (
        select 0.2 * avg(l_quantity)
        from lineitem
        where l_partkey = p_partkey)
""",
    19: """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey
       and p_brand = 'Brand#12'
       and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       and l_quantity >= 1 and l_quantity <= 1 + 10
       and p_size between 1 and 5
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey
       and p_brand = 'Brand#23'
       and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       and l_quantity >= 10 and l_quantity <= 10 + 10
       and p_size between 1 and 10
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey
       and p_brand = 'Brand#34'
       and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       and l_quantity >= 20 and l_quantity <= 20 + 10
       and p_size between 1 and 15
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
""",
}

"""TPC-H queries as logical plans (sql/plan.py) + numpy oracles.

Counterpart of cockroach_tpu/workload/tpch_queries.py, for Q1, Q3, Q6,
Q9, Q12, Q14 and Q18: each query's plan, its builder, its numpy oracle
and, for all but Q6, its vectorized (columnar) numpy oracle. The oracles
compute reference answers on the same generated data; the columnar ones
run in seconds at SF 1, where the row loops take much longer.
"""

from __future__ import annotations

import datetime
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
    Aggregate, Filter, Join, Limit, OrderBy, Project, Scan, TPCHCatalog,
    build,
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

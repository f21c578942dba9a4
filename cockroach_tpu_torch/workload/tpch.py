"""TPC-H data generator — dbgen-equivalent, chunked, deterministic.

A copy of cockroach_tpu/workload/tpch.py with its MVCC loader
(mvcc_load) and without cluster_load, which waits for the distributed
store (ROADMAP.md queue 1, item 7): numpy only, and bit-identical in its
output.

Reference: pkg/workload/tpch (the reference's Go dbgen port; queries in
pkg/workload/tpch/queries.go). This generator is built for the streaming
scan path: every value is a pure function of (seed, table, row index) via a
counter-based splitmix64 hash, so ANY row range of ANY table can be
generated independently and in parallel — no sequential RNG state. That is
what lets SF100 scans stream chunk-by-chunk through the flow runtime
without ever materializing a table host-side (SURVEY.md P6/P11).

Fidelity notes (deviations from pristine dbgen, all benchmark-neutral and
oracle-validated since correctness tests recompute answers on the same
data): free-text columns (names/addresses/comments) draw from bounded
pools instead of unique-per-row text, preserving LIKE selectivities;
orderkeys are dense; o_totalprice is independent noise (output-only in our
target queries). Distributions, correlations (ship/commit/receipt dates,
returnflag vs receiptdate, partsupp FK structure, retailprice formula) and
cardinalities follow the spec.

Decimals are scaled int64 (scale 2), dates are int32 days since epoch.
"""

from __future__ import annotations

import datetime
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from cockroach_tpu_torch.coldata.batch import (
    DATE, DECIMAL, Field, INT, Schema, STRING,
)

# --- deterministic counter-based randomness --------------------------------

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    return x ^ (x >> np.uint64(31))


def _h(rows: np.ndarray, seed: int, tag: int) -> np.ndarray:
    """uint64 hash of row indices, keyed by (seed, tag)."""
    with np.errstate(over="ignore"):
        x = rows.astype(np.uint64) + _GOLDEN * np.uint64(1 + tag) \
            + np.uint64(seed) * _M2
        return _mix(x)


def _uniform_int(rows, seed, tag, lo, hi):
    """ints uniform in [lo, hi] inclusive (lo may be negative)."""
    span = (_h(rows, seed, tag) % np.uint64(hi - lo + 1)).astype(np.int64)
    return np.int64(lo) + span


def _uniform_float(rows, seed, tag):
    return (_h(rows, seed, tag) >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


STARTDATE = _days(1992, 1, 1)
CURRENTDATE = _days(1995, 6, 17)
ENDDATE = _days(1998, 12, 31)

# --- string pools (the 5.2.2 word lists, abbreviated but selectivity-true) --

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["O", "F"]
ORDERSTATUS = ["F", "O", "P"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hot pink", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
    "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white",
    "yellow",
]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

# comment pool: bounded, with the phrases Q13/Q16/etc. filter on
_COMMENT_WORDS = COLORS[:40] + ["special", "requests", "pending", "deposits",
                                "accounts", "packages", "express", "unusual",
                                "Customer", "Complaints", "furiously", "quickly"]


def _cross(*pools: List[str]) -> List[str]:
    out = [""]
    for p in pools:
        out = [a + (" " if a else "") + b for a in out for b in p]
    return out


_TYPES = _cross(TYPE_S1, TYPE_S2, TYPE_S3)          # 150
_CONTAINERS = _cross(CONTAINER_S1, CONTAINER_S2)    # 40
_BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
_MFGRS = [f"Manufacturer#{i}" for i in range(1, 6)]

_rng_pool = np.random.default_rng(424242)
_PNAMES = np.array([
    " ".join(_rng_pool.choice(COLORS, size=5, replace=False))
    for _ in range(4096)
], dtype=object)
_COMMENTS = np.array([
    " ".join(_rng_pool.choice(_COMMENT_WORDS, size=6))
    for _ in range(4096)
], dtype=object)

# table id tags for hashing
_T = {"region": 1, "nation": 2, "supplier": 3, "customer": 4, "part": 5,
      "partsupp": 6, "orders": 7, "lineitem": 8}


class TPCH:
    """Deterministic chunked TPC-H generator at scale factor `sf`."""

    def __init__(self, sf: float = 1.0, seed: int = 19940211):
        self.sf = sf
        self.seed = seed
        self.n_supplier = int(10_000 * sf)
        self.n_customer = int(150_000 * sf)
        self.n_part = int(200_000 * sf)
        self.n_partsupp = self.n_part * 4
        self.n_orders = int(1_500_000 * sf)
        # lineitems per order in [1,7] from a per-order hash => ~4 avg
        self._order_rows = np.arange(self.n_orders, dtype=np.int64)
        self._nlines = _uniform_int(self._order_rows, seed, 900, 1, 7)
        self._line_starts = np.concatenate(
            [[0], np.cumsum(self._nlines)]).astype(np.int64)
        self.n_lineitem = int(self._line_starts[-1])

    # -- cardinalities ------------------------------------------------------

    def num_rows(self, table: str) -> int:
        return {
            "region": 5, "nation": 25, "supplier": self.n_supplier,
            "customer": self.n_customer, "part": self.n_part,
            "partsupp": self.n_partsupp, "orders": self.n_orders,
            "lineitem": self.n_lineitem,
        }[table]

    # -- schemas ------------------------------------------------------------

    # Narrow transport dtypes (Field.wire): every bound is a TPC-H spec
    # guarantee (scaled decimals; dict codes bounded by pool size; dates in
    # [1992-01-01, 1998-12-31] => day numbers < 2^15; keys < 2^31 through
    # SF1000). Wire width sets the tunnel scan rate — see Field.wire.
    _WIRES = {
        "s_suppkey": "i4", "s_nationkey": "i1", "s_acctbal": "i4",
        "s_name": "i2", "s_address": "i2", "s_phone": "i2", "s_comment": "i2",
        "c_custkey": "i4", "c_nationkey": "i1", "c_acctbal": "i4",
        "c_name": "i2", "c_address": "i2", "c_phone": "i2",
        "c_mktsegment": "i1", "c_comment": "i2",
        "p_partkey": "i4", "p_name": "i2", "p_mfgr": "i1", "p_brand": "i1",
        "p_type": "i2", "p_size": "i1", "p_container": "i1",
        "p_retailprice": "i4", "p_comment": "i2",
        "ps_partkey": "i4", "ps_suppkey": "i4", "ps_availqty": "i2",
        "ps_supplycost": "i4", "ps_comment": "i2",
        "o_orderkey": "i4", "o_custkey": "i4", "o_orderstatus": "i1",
        "o_totalprice": "i4", "o_orderdate": "i2", "o_orderpriority": "i1",
        "o_clerk": "i2", "o_shippriority": "i1", "o_comment": "i2",
        "l_orderkey": "i4", "l_partkey": "i4", "l_suppkey": "i4",
        "l_linenumber": "i1", "l_quantity": "i2", "l_extendedprice": "i4",
        "l_discount": "i1", "l_tax": "i1", "l_returnflag": "i1",
        "l_linestatus": "i1", "l_shipdate": "i2", "l_commitdate": "i2",
        "l_receiptdate": "i2", "l_shipinstruct": "i1", "l_shipmode": "i1",
        "l_comment": "i2",
    }

    def schema(self, table: str) -> Schema:
        S = lambda name, pool: Field(name, STRING, dict_ref=name)
        D2 = DECIMAL(2)
        defs = {
            "region": ([Field("r_regionkey", INT), S("r_name", REGIONS),
                        S("r_comment", _COMMENTS)],
                       {"r_name": REGIONS, "r_comment": _COMMENTS}),
            "nation": ([Field("n_nationkey", INT), S("n_name", None),
                        Field("n_regionkey", INT), S("n_comment", None)],
                       {"n_name": [n for n, _ in NATIONS],
                        "n_comment": _COMMENTS}),
            "supplier": ([Field("s_suppkey", INT), S("s_name", None),
                          S("s_address", None), Field("s_nationkey", INT),
                          S("s_phone", None), Field("s_acctbal", D2),
                          S("s_comment", None)],
                         {"s_name": _COMMENTS, "s_address": _COMMENTS,
                          "s_phone": _COMMENTS, "s_comment": _COMMENTS}),
            "customer": ([Field("c_custkey", INT), S("c_name", None),
                          S("c_address", None), Field("c_nationkey", INT),
                          S("c_phone", None), Field("c_acctbal", D2),
                          S("c_mktsegment", None), S("c_comment", None)],
                         {"c_name": _COMMENTS, "c_address": _COMMENTS,
                          "c_phone": _COMMENTS, "c_mktsegment": SEGMENTS,
                          "c_comment": _COMMENTS}),
            "part": ([Field("p_partkey", INT), S("p_name", None),
                      S("p_mfgr", None), S("p_brand", None),
                      S("p_type", None), Field("p_size", INT),
                      S("p_container", None), Field("p_retailprice", D2),
                      S("p_comment", None)],
                     {"p_name": _PNAMES, "p_mfgr": _MFGRS,
                      "p_brand": _BRANDS, "p_type": _TYPES,
                      "p_container": _CONTAINERS, "p_comment": _COMMENTS}),
            "partsupp": ([Field("ps_partkey", INT), Field("ps_suppkey", INT),
                          Field("ps_availqty", INT),
                          Field("ps_supplycost", D2), S("ps_comment", None)],
                         {"ps_comment": _COMMENTS}),
            "orders": ([Field("o_orderkey", INT), Field("o_custkey", INT),
                        S("o_orderstatus", None), Field("o_totalprice", D2),
                        Field("o_orderdate", DATE), S("o_orderpriority", None),
                        S("o_clerk", None), Field("o_shippriority", INT),
                        S("o_comment", None)],
                       {"o_orderstatus": ORDERSTATUS,
                        "o_orderpriority": PRIORITIES, "o_clerk": _COMMENTS,
                        "o_comment": _COMMENTS}),
            "lineitem": ([Field("l_orderkey", INT), Field("l_partkey", INT),
                          Field("l_suppkey", INT), Field("l_linenumber", INT),
                          Field("l_quantity", D2),
                          Field("l_extendedprice", D2),
                          Field("l_discount", D2), Field("l_tax", D2),
                          S("l_returnflag", None), S("l_linestatus", None),
                          Field("l_shipdate", DATE),
                          Field("l_commitdate", DATE),
                          Field("l_receiptdate", DATE),
                          S("l_shipinstruct", None), S("l_shipmode", None),
                          S("l_comment", None)],
                         {"l_returnflag": RETURNFLAGS,
                          "l_linestatus": LINESTATUS,
                          "l_shipinstruct": INSTRUCTIONS,
                          "l_shipmode": SHIPMODES, "l_comment": _COMMENTS}),
        }
        fields, dicts = defs[table]
        fields = [
            Field(f.name, f.type, f.dict_ref, self._WIRES.get(f.name))
            for f in fields
        ]
        return Schema(fields, {k: np.asarray(v, dtype=object)
                               for k, v in dicts.items()})

    # -- generation ---------------------------------------------------------

    def table(self, name: str) -> Dict[str, np.ndarray]:
        """Full table, memoized: callers (oracles, bench numpy baselines)
        must see datagen cost once, not once per timed run."""
        cache = getattr(self, "_table_cache", None)
        if cache is None:
            cache = self._table_cache = {}
        if name not in cache:
            cache[name] = self.rows(name, 0, self.num_rows(name))
        return cache[name]

    def chunks(self, name: str, chunk_rows: int,
               lo: int = 0, hi: Optional[int] = None
               ) -> Iterator[Dict[str, np.ndarray]]:
        hi = self.num_rows(name) if hi is None else hi
        for a in range(lo, hi, chunk_rows):
            yield self.rows(name, a, min(a + chunk_rows, hi))

    def mvcc_load(self, store, tables: Sequence[str]):
        """Ingest generated tables into an MVCC store (bulk eng_ingest,
        the AddSSTable path) and return an MVCCCatalog over them — the
        TPC-H-through-the-storage-engine configuration (reference
        pkg/storage/col_mvcc.go:391 feeding colfetcher). Table i gets
        id 10 + i and its statistics are sampled from the loaded arrays
        (the reference runs automatic stats after bulk ingest)."""
        from cockroach_tpu_torch.sql.plan import _TPCH_PKS, MVCCCatalog
        from cockroach_tpu_torch.sql.stats import sample_stats

        mapping = {}
        rows = {}
        stats = {}
        for i, name in enumerate(tables):
            tid = 10 + i
            schema = self.schema(name)
            cols = self.table(name)
            ordered = {f.name: np.asarray(cols[f.name], dtype=np.int64)
                       for f in schema}
            n = self.num_rows(name)
            store.ingest_table(tid, np.arange(n, dtype=np.int64), ordered)
            mapping[name] = (tid, schema)
            rows[name] = n
            stats[name] = sample_stats([ordered])
            stats[name].row_count = n
        return MVCCCatalog(store, mapping, rows=rows,
                           pks={t: _TPCH_PKS[t] for t in tables
                                if t in _TPCH_PKS},
                           stats=stats)

    def rows(self, name: str, lo: int, hi: int) -> Dict[str, np.ndarray]:
        r = np.arange(lo, hi, dtype=np.int64)
        s, t = self.seed, _T[name]
        u = lambda tag, a, b: _uniform_int(r, s, t * 100 + tag, a, b)
        if name == "region":
            return {"r_regionkey": r, "r_name": r.astype(np.int32),
                    "r_comment": u(1, 0, len(_COMMENTS) - 1).astype(np.int32)}
        if name == "nation":
            return {"n_nationkey": r, "n_name": r.astype(np.int32),
                    "n_regionkey": np.array([nr for _, nr in NATIONS],
                                            dtype=np.int64)[r],
                    "n_comment": u(1, 0, len(_COMMENTS) - 1).astype(np.int32)}
        if name == "supplier":
            return {
                "s_suppkey": r + 1,
                "s_name": u(1, 0, 4095).astype(np.int32),
                "s_address": u(2, 0, 4095).astype(np.int32),
                "s_nationkey": u(3, 0, 24),
                "s_phone": u(4, 0, 4095).astype(np.int32),
                "s_acctbal": u(5, -99999, 999999),
                "s_comment": u(6, 0, 4095).astype(np.int32),
            }
        if name == "customer":
            return {
                "c_custkey": r + 1,
                "c_name": u(1, 0, 4095).astype(np.int32),
                "c_address": u(2, 0, 4095).astype(np.int32),
                "c_nationkey": u(3, 0, 24),
                "c_phone": u(4, 0, 4095).astype(np.int32),
                "c_acctbal": u(5, -99999, 999999),
                "c_mktsegment": u(6, 0, 4).astype(np.int32),
                "c_comment": u(7, 0, 4095).astype(np.int32),
            }
        if name == "part":
            pk = r + 1
            return {
                "p_partkey": pk,
                "p_name": u(1, 0, len(_PNAMES) - 1).astype(np.int32),
                "p_mfgr": u(2, 0, 4).astype(np.int32),
                "p_brand": u(3, 0, 24).astype(np.int32),
                "p_type": u(4, 0, len(_TYPES) - 1).astype(np.int32),
                "p_size": u(5, 1, 50),
                "p_container": u(6, 0, len(_CONTAINERS) - 1).astype(np.int32),
                "p_retailprice": self._retailprice(pk),
                "p_comment": u(7, 0, 4095).astype(np.int32),
            }
        if name == "partsupp":
            pk = r // 4 + 1
            i = r % 4
            return {
                "ps_partkey": pk,
                "ps_suppkey": self._psupp(pk, i),
                "ps_availqty": u(1, 1, 9999),
                "ps_supplycost": u(2, 100, 100000),
                "ps_comment": u(3, 0, 4095).astype(np.int32),
            }
        if name == "orders":
            odate = u(1, STARTDATE, ENDDATE - 151)
            return {
                "o_orderkey": r + 1,
                "o_custkey": u(2, 1, self.n_customer),
                "o_orderstatus": u(3, 0, 2).astype(np.int32),
                "o_totalprice": u(4, 100000, 50000000),
                "o_orderdate": odate.astype(np.int32),
                "o_orderpriority": u(5, 0, 4).astype(np.int32),
                "o_clerk": u(6, 0, 4095).astype(np.int32),
                "o_shippriority": np.zeros(len(r), dtype=np.int64),
                "o_comment": u(7, 0, 4095).astype(np.int32),
            }
        if name == "lineitem":
            # map lineitem rows to their order via the cumulative starts
            o = np.searchsorted(self._line_starts, r, side="right") - 1
            okey = o + 1
            linenumber = r - self._line_starts[o] + 1
            odate = _uniform_int(o, s, 701, STARTDATE, ENDDATE - 151)
            qty = u(1, 1, 50)
            pk = u(2, 1, self.n_part)
            ship = odate + u(5, 1, 121)
            commit = odate + u(6, 30, 90)
            receipt = ship + u(7, 1, 30)
            rf = np.where(
                receipt <= CURRENTDATE, u(8, 0, 1),  # R or A
                np.full(len(r), 2),                  # N
            )
            ls = np.where(ship > CURRENTDATE, 0, 1)  # O else F
            return {
                "l_orderkey": okey,
                "l_partkey": pk,
                "l_suppkey": self._psupp(pk, u(3, 0, 3)),
                "l_linenumber": linenumber,
                "l_quantity": qty * 100,                       # scale 2
                "l_extendedprice": qty * self._retailprice(pk),
                "l_discount": u(9, 0, 10),
                "l_tax": u(10, 0, 8),
                "l_returnflag": rf.astype(np.int32),
                "l_linestatus": ls.astype(np.int32),
                "l_shipdate": ship.astype(np.int32),
                "l_commitdate": commit.astype(np.int32),
                "l_receiptdate": receipt.astype(np.int32),
                "l_shipinstruct": u(11, 0, 3).astype(np.int32),
                "l_shipmode": u(12, 0, 6).astype(np.int32),
                "l_comment": u(13, 0, 4095).astype(np.int32),
            }
        raise KeyError(name)

    def _retailprice(self, partkey: np.ndarray) -> np.ndarray:
        """Spec 4.2.3: (90000 + ((partkey/10) mod 20001) + 100*(partkey mod
        1000)) / 100, here kept scale-2."""
        return (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)).astype(np.int64)

    def _psupp(self, partkey: np.ndarray, i: np.ndarray) -> np.ndarray:
        """Spec 4.2.3 partsupp supplier spread: part p's i-th supplier."""
        S = self.n_supplier
        return ((partkey + i * (S // 4 + (partkey - 1) // S)) % S) + 1

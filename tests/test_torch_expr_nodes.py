"""The port's Case, Cast, InList, Like, Extract and ScalarFunc
(cockroach_tpu_torch/ops/expr.py) against the JAX package's eval_expr
under jit, bit for bit in values and validity, over their edge cases:
NULLs, NaN, +-inf and out-of-range float -> integer casts (XLA
saturates), subnormal floats, dates before 1970, `mod` by 0 and by -1,
decimal scales, string and decimal IN lists, negated LIKE. The nodes the
port does not evaluate yet raise, naming their ROADMAP item."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.ops import expr as jx
from cockroach_tpu_torch.ops import expr as tx
from test_torch_expr import assert_same_column, port_batch, port_schema
from torch_threads import one_torch_thread  # noqa: F401

N = 512
_I64 = np.iinfo(np.int64)

_INTS = [0, 1, -1, 7, -7, 2, -2, 5, 100, -100, _I64.max, _I64.min,
         _I64.min + 1, 1 << 40, -(1 << 40)]
_DIVISORS = [0, 2, -2, 3, -3, 1, -1, 0, 7, -7, 1, -1, 2, 5, -5]
_FLOATS = [np.nan, np.inf, -np.inf, 3e19, -3e19, 9.3e18, -9.3e18,
           2.0 ** 63, -(2.0 ** 63), 2.0 ** 31, -(2.0 ** 31) - 256.0, 1e-45,
           -1e-45, 1e-40, 0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.25,
           -0.125, 0.005, 0.015, 123.456, -123.456, 1e-20, 3e-38]
# days since 1970-01-01, before and after: 0000-03-01, 1600/1700/1900
# boundaries, leap days, the epoch and its eve, 2000 and later
_DATES = [-719468, -719469, -141427, -135140, -25567, -25568, -25509,
          -1, 0, 1, 58, 59, 60, 789, 10956, 10957, 11016, 11017, 47541,
          -36525, -146097, 2932896]
_WORDS = np.array(["almond", "antique", "a_c", "abc", "a%c", "", "x",
                   "PROMO BRUSHED", "promo", "STANDARD PROMO", "MAIL",
                   "SHIP", "forest green", "green", "gree", "a.c",
                   "line\nbreak"], dtype=object)


def _cycle(values, n, rng, fill):
    out = np.array([values[k % len(values)] for k in range(n)])
    tail = n - 3 * len(values)
    if tail > 0:  # past three rounds of the edge cases: random lanes
        out[-tail:] = fill(rng, tail)
    return out


def _batch():
    rng = np.random.default_rng(20261017)
    F = jbatch.Field
    js = jbatch.Schema([
        F("i", jbatch.INT), F("j", jbatch.INT), F("f", jbatch.FLOAT),
        F("g", jbatch.FLOAT), F("d", jbatch.DECIMAL(2)),
        F("e", jbatch.DECIMAL(4)), F("dt", jbatch.DATE),
        F("s", jbatch.STRING, dict_ref="w"), F("b", jbatch.BOOL)],
        {"w": _WORDS})
    ints = _cycle(_INTS, N, rng, lambda r, k: r.integers(-1000, 1000, k))
    divs = _cycle(_DIVISORS, N, rng, lambda r, k: r.integers(-9, 9, k))
    floats = _cycle(_FLOATS, N, rng,
                    lambda r, k: r.normal(0, 1e3, k)).astype(np.float32)
    g = np.roll(floats, 7)
    g[::9] = 0.0
    decs = _cycle(_INTS[:11] + [149, -150, 250, -251, 12345, -99999], N,
                  rng, lambda r, k: r.integers(-10 ** 6, 10 ** 6, k))
    dates = _cycle(_DATES, N, rng,
                   lambda r, k: r.integers(-800000, 3000000, k))
    codes = _cycle(list(range(-1, len(_WORDS))), N, rng,
                   lambda r, k: r.integers(0, len(_WORDS), k))

    def col(v, dtype, null_frac=0.0):
        m = None if not null_frac else jnp.asarray(rng.random(N) > null_frac)
        return jbatch.Column(jnp.asarray(np.asarray(v).astype(dtype)), m)

    cols = {
        "i": col(ints, np.int64, 0.15), "j": col(divs, np.int64, 0.1),
        "f": col(floats, np.float32, 0.1), "g": col(g, np.float32),
        "d": col(decs, np.int64, 0.1),
        "e": col(decs[::-1] * 7 + 5, np.int64),
        "dt": col(dates, np.int32, 0.05), "s": col(codes, np.int32, 0.1),
        "b": col(rng.random(N) > 0.5, np.bool_, 0.2),
    }
    sel = rng.random(N) > 0.05
    return jbatch.Batch(cols, jnp.asarray(sel),
                        jnp.int32(int(sel.sum()))), js


def to_port(e):
    """A JAX expression tree rebuilt from the port's node classes."""
    if isinstance(e, jx.Expr):
        cls = getattr(tx, type(e).__name__)
        return cls(**{f.name: to_port(getattr(e, f.name))
                      for f in dataclasses.fields(e)})
    if isinstance(e, tuple):
        return tuple(to_port(x) for x in e)
    if isinstance(e, jbatch.ColType):
        return port_schema(jbatch.Schema(
            [jbatch.Field("_", e)])).field("_").type
    return e


def _exprs():
    C, L = jx.Col, jx.Lit
    i, j, f, g, d, e, dt, s, b = (C(n) for n in
                                  ("i", "j", "f", "g", "d", "e", "dt", "s",
                                   "b"))
    INT, FLOAT, DATE, BOOL = (jbatch.INT, jbatch.FLOAT, jbatch.DATE,
                              jbatch.BOOL)
    D2, D4 = jbatch.DECIMAL(2), jbatch.DECIMAL(4)
    SF = jx.ScalarFunc
    return {
        # CASE: first-match wins, no ELSE -> NULL, mixed branch types
        # converted to the first branch's (float -> int saturates)
        "case_int": jx.Case(((jx.Cmp(">", i, L(0)), i),), L(-1)),
        "case_no_else": jx.Case(((jx.Cmp(">", f, L(0.0)), L(1)),
                                 (jx.IsNull(d), L(2)))),
        "case_float_to_int": jx.Case(((b, L(7)),), f),
        "case_int_to_float": jx.Case(((b, f),), i),
        "case_decimal": jx.Case(((jx.Like(s, "%a%"), d),), L(0.0, D2)),
        "case_null_branch": jx.Case(((b, L(None, INT)),), i),
        "case_bool": jx.Case(((jx.Cmp("<", j, L(0)), b),
                              (jx.Cmp(">", j, L(0)), jx.Not(b))), L(False)),
        # CAST
        "cast_f_int": jx.Cast(f, INT),
        "cast_f_date": jx.Cast(f, DATE),
        "cast_f_dec2": jx.Cast(f, D2),
        "cast_f_dec4": jx.Cast(f, D4),
        "cast_f_bool": jx.Cast(f, BOOL),
        "cast_d_float": jx.Cast(d, FLOAT),
        "cast_d_dec4": jx.Cast(d, D4),
        "cast_e_dec2": jx.Cast(e, D2),
        "cast_e_dec0": jx.Cast(e, jbatch.DECIMAL(0)),
        "cast_i_dec2": jx.Cast(i, D2),
        "cast_i_float": jx.Cast(i, FLOAT),
        "cast_i_date": jx.Cast(i, DATE),
        "cast_dt_int": jx.Cast(dt, INT),
        "cast_b_int": jx.Cast(b, INT),
        "cast_d_int": jx.Cast(d, INT),
        "cast_i_bool": jx.Cast(i, BOOL),
        # IN
        "in_string": jx.InList(s, ("MAIL", "SHIP", "absent")),
        "in_string_none": jx.InList(s, ("absent",)),
        "in_int": jx.InList(i, (1, -7, 100, int(_I64.min))),
        "in_decimal": jx.InList(d, (1.5, -2.25, 0.07, 100)),
        "in_float": jx.InList(f, (1.5, 0.0, -2.5, 0.25)),
        "in_date": jx.InList(dt, (0, -1, 10957)),
        "in_int_float_lit": jx.InList(i, (1.5, 7.9)),
        # LIKE
        "like_contains": jx.Like(s, "%a%"),
        "like_prefix": jx.Like(s, "PROMO%"),
        "like_underscore": jx.Like(s, "a_c"),
        "like_specials": jx.Like(s, "a%c"),
        "like_dot": jx.Like(s, "a.c"),
        "like_empty": jx.Like(s, ""),
        "like_all": jx.Like(s, "%"),
        "like_newline": jx.Like(s, "line%"),
        "not_like": jx.Like(s, "%green%", negate=True),
        # EXTRACT
        "year": jx.Extract("year", dt),
        "month": jx.Extract("month", dt),
        "day": jx.Extract("day", dt),
        # scalar functions
        "abs_i": SF("abs", (i,)),
        "abs_f": SF("abs", (f,)),
        "abs_d": SF("abs", (d,)),
        "sign_i": SF("sign", (i,)),
        "sign_f": SF("sign", (f,)),
        "mod_i": SF("mod", (i, j)),
        "mod_f": SF("mod", (f, g)),
        "mod_f_i": SF("mod", (f, j)),
        "mod_d_i": SF("mod", (d, j)),
        "floor_d": SF("floor", (d,)),
        "ceil_d": SF("ceil", (d,)),
        "floor_e": SF("floor", (e,)),
        "ceil_e": SF("ceil", (e,)),
        "floor_f": SF("floor", (f,)),
        "ceil_f": SF("ceil", (f,)),
        "floor_i": SF("floor", (i,)),
        "coalesce_int": SF("coalesce", (i, j, L(0))),
        "coalesce_f_i": SF("coalesce", (f, i)),
        "coalesce_i_f": SF("coalesce", (i, f)),
        "nullif_i": SF("nullif", (i, j)),
        "nullif_f": SF("nullif", (f, g)),
        "greatest_i": SF("greatest", (i, j)),
        "least_f": SF("least", (f, g)),
        "greatest_f": SF("greatest", (f, g, L(0.0))),
        "least_null": SF("least", (i, j, L(None, INT))),
        "length": SF("length", (s,),
                     table=tuple(len(w) for w in _WORDS)),
        # nodes inside other nodes, and inside a filter-shaped BoolOp
        "nested": jx.BoolOp("and", (
            jx.InList(s, ("MAIL", "SHIP")),
            jx.Cmp(">=", jx.Extract("year", dt), L(1970)),
            jx.Cmp("<", SF("mod", (i, L(3))), L(2)))),
        "q12_high": jx.Case(((jx.InList(s, ("MAIL", "x")), L(1)),), L(0)),
        "q14_promo": jx.Case(((jx.Like(s, "PROMO%"),
                               jx.BinOp("*", d, jx.BinOp(
                                   "-", L(1.0, D2), d))),), L(0.0, D4)),
    }


@pytest.fixture(scope="module")
def batch():
    jb, js = _batch()
    return jb, js, port_batch(jb), port_schema(js)


@pytest.mark.parametrize("name", sorted(_exprs()))
def test_node_matches_jax_under_jit(batch, name):
    jb, js, tb, ts = batch
    e = _exprs()[name]
    want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
    got = tx.eval_expr(to_port(e), tb, ts, {})
    assert_same_column(want, got, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_exprs()))
def test_node_matches_jax_on_card(batch, name):
    """The same cases on a CUDA batch: the card's float -> integer
    conversion, fmod and subnormal arithmetic differ from the CPU's, and
    the port must equal the JAX package on both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jb, js, _tb, ts = batch
    e = _exprs()[name]
    want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
    got = tx.eval_expr(to_port(e), port_batch(jb, "cuda"), ts, {})
    assert got.values.is_cuda
    assert_same_column(want, got, name)


def test_casts_saturate_as_xla_does():
    """The fault PyTorch's own conversion has: NaN, +-inf and 3e19 to
    int64 give INT_MIN there, and [0, max, min, max] in the JAX
    package."""
    F = jbatch.Field
    js = jbatch.Schema([F("f", jbatch.FLOAT)])
    v = np.array([np.nan, np.inf, -np.inf, 3e19], np.float32)
    jb = jbatch.Batch.from_columns({"f": jbatch.Column(jnp.asarray(v))})
    e = jx.Cast(jx.Col("f"), jbatch.INT)
    want = np.asarray(jax.jit(lambda b: jx.eval_expr(e, b, js))(jb).values)
    assert want.tolist() == [0, _I64.max, _I64.min, _I64.max]
    got = tx.eval_expr(to_port(e), port_batch(jb), port_schema(js), {})
    assert got.values.tolist() == want.tolist()


def test_extract_before_1970():
    """Floor division in the civil calendar: 1969-12-31 and 1600-03-01."""
    F = jbatch.Field
    js = jbatch.Schema([F("dt", jbatch.DATE)])
    days = np.array([-1, -135080, -719468], np.int32)
    jb = jbatch.Batch.from_columns({"dt": jbatch.Column(jnp.asarray(days))})
    got = [tx.eval_expr(to_port(jx.Extract(p, jx.Col("dt"))),
                        port_batch(jb), port_schema(js), {}).values.tolist()
           for p in ("year", "month", "day")]
    assert list(zip(*got)) == [(1969, 12, 31), (1600, 3, 1), (0, 3, 1)]


def test_dictionary_tables_are_built_once_per_operator(batch):
    """With a tables dict kept across batches, LIKE's table and an IN
    list's codes are resolved once: the second batch finds them."""
    jb, js, tb, ts = batch
    e = to_port(jx.BoolOp("and", (jx.Like(jx.Col("s"), "%a%"),
                                  jx.InList(jx.Col("s"), ("MAIL",)))))
    tables = {}
    first = tx.filter_mask(e, tb, ts, tables)
    assert len(tables) == 2
    kept = dict(tables)
    again = tx.filter_mask(e, tb, ts, tables)
    assert tables.keys() == kept.keys()
    assert all(tables[k] is kept[k] for k in kept)
    assert torch.equal(first, again)


@pytest.mark.parametrize("node,item", [
    (jx.VecLit((1.0, 2.0, -0.5)), "item 8"),
    (jx.VecDistance("l2", jx.Col("v"), jx.VecLit((1.0, 2.0, -0.5))),
     "item 8"),
])
def test_unported_nodes_name_their_roadmap_item(node, item):
    """The vector nodes that waited for ROADMAP.md queue 1, item 8 (8c)
    now evaluate as the JAX package's under jit, on a VECTOR(3) batch
    with NULL lanes: the broadcast literal bit for bit, the distances
    (l2 and cos) within 1e-5 relative and with the same validity."""
    rng = np.random.default_rng(8)
    js = jbatch.Schema([jbatch.Field("v", jbatch.ColType(jbatch.Kind.VECTOR,
                                                          3))])
    vals = rng.normal(size=(N, 3)).astype(np.float32)
    vals[5] = 0.0  # the cosine guard
    jb = jbatch.Batch({"v": jbatch.Column(
        jnp.asarray(vals), jnp.asarray(rng.random(N) > 0.2))},
        jnp.asarray(rng.random(N) > 0.05), jnp.int32(N))
    tb, ts = port_batch(jb), port_schema(js)
    nodes = [node]
    if isinstance(node, jx.VecDistance):
        nodes.append(jx.VecDistance("cos", node.left, node.right))
    for e in nodes:
        want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
        got = tx.eval_expr(to_port(e), tb, ts, {})
        if isinstance(e, jx.VecLit):
            assert_same_column(want, got, item)
            continue
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(want.values), rtol=1e-5,
                                   atol=1e-6)
        assert np.array_equal(got.validity.numpy(),
                              np.asarray(want.validity))


def test_strfunc_is_not_evaluated_on_the_device(batch):
    """A computed string is the row engine's (exec/rowexec.py): eval_expr
    refuses StrFunc with the JAX package's error."""
    jb, js, tb, ts = batch
    with pytest.raises(TypeError) as want:
        jx.eval_expr(jx.StrFunc("upper", (jx.Col("s"),)), jb, js)
    with pytest.raises(TypeError) as got:
        tx.eval_expr(tx.StrFunc("upper", (tx.Col("s"),)), tb, ts, {})
    assert str(got.value) == str(want.value)


def _folds():
    """Float BinOps with a constant operand. Under jax.jit XLA's algebraic
    simplifier removes the first group, so their subnormal operand lanes
    pass through unflushed (and -0.0 + 0.0 stays -0.0); the second group
    keeps its operation, and its flush."""
    C, L = jx.Col, jx.Lit
    f, i, d = C("f"), C("i"), C("d")
    FLOAT = jbatch.FLOAT
    zero, one = L(0.0), L(1.0)
    B = jx.BinOp
    return {
        # removed: x + 0, 0 + x, x - 0, x * 1, 1 * x, x / 1
        "f+0.0": B("+", f, zero), "0.0+f": B("+", zero, f),
        "f-0.0": B("-", f, zero), "f*1.0": B("*", f, one),
        "1.0*f": B("*", one, f), "f/1.0": B("/", f, one),
        "f+0": B("+", f, L(0)), "0+f": B("+", L(0), f),
        "f-0": B("-", f, L(0)), "f*1": B("*", f, L(1)),
        "1*f": B("*", L(1), f), "f/1": B("/", f, L(1)),
        # the other zero, a zero divisor (NULL lanes divide by 1), a NULL
        # literal (zero lanes), constant subtrees, a decimal constant
        "f+-0.0": B("+", f, L(-0.0)), "-0.0+f": B("+", L(-0.0), f),
        "f--0.0": B("-", f, L(-0.0)), "f/0.0": B("/", f, zero),
        "f/0": B("/", f, L(0)), "f+null": B("+", f, L(None, FLOAT)),
        "null+f": B("+", L(None, FLOAT), f),
        "f/null": B("/", f, L(None, FLOAT)),
        "f+cast(0)": B("+", f, jx.Cast(L(0), FLOAT)),
        "f*(2.0-1.0)": B("*", f, B("-", L(2.0), one)),
        "f/1.00": B("/", f, L(1.0, jbatch.DECIMAL(2))),
        "(f*g)+0.0": B("+", B("*", f, C("g")), zero),
        "(f+0.0)*1.0": B("*", B("+", f, zero), one),
        # removed into a negation: x * -1, -1 * x, x / -1, -0.0 - x
        "f*-1.0": B("*", f, L(-1.0)), "-1.0*f": B("*", L(-1.0), f),
        "f/-1.0": B("/", f, L(-1.0)), "f*-1": B("*", f, L(-1)),
        "-0.0-f": B("-", L(-0.0), f),
        "f/-1.00": B("/", f, L(-1.0, jbatch.DECIMAL(2))),
        # kept, and flushed
        "0.0-f": B("-", zero, f), "null-f": B("-", L(None, FLOAT), f),
        "f*2.0": B("*", f, L(2.0)), "f/2.0": B("/", f, L(2.0)),
        "f+1.0": B("+", f, one), "0.0/f": B("/", zero, f),
        "1.0/f": B("/", one, f), "f*0.0": B("*", f, zero),
        "f+g": B("+", f, C("g")), "f*g": B("*", f, C("g")),
        # an integer or decimal operand: never subnormal either way
        "i+0.0": B("+", i, zero), "i*-1.0": B("*", i, L(-1.0)),
        "d/1.0": B("/", d, one),
    }


def _assert_same_bits(want, got, what):
    """Equal values and validity, and equal sign bits on the lanes that
    are not NaN (so -0.0 and 0.0 differ)."""
    assert_same_column(want, got, what)
    w, g = np.asarray(want.values), got.values.cpu().numpy()
    real = ~np.isnan(w)
    np.testing.assert_array_equal(np.signbit(g[real]), np.signbit(w[real]),
                                  err_msg=what)


@pytest.mark.parametrize("name", sorted(_folds()))
def test_xla_folds_match_jax_under_jit(batch, name):
    """The forms XLA removes leave their operand's bits as they are, where
    the port's float arithmetic otherwise flushes subnormals (_ftz)."""
    jb, js, tb, ts = batch
    e = _folds()[name]
    want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
    got = tx.eval_expr(to_port(e), tb, ts, {})
    _assert_same_bits(want, got, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_folds()))
def test_xla_folds_match_jax_on_card(batch, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jb, js, _tb, ts = batch
    e = _folds()[name]
    want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
    got = tx.eval_expr(to_port(e), port_batch(jb, "cuda"), ts, {})
    assert got.values.is_cuda
    _assert_same_bits(want, got, name)


def _fma_batch():
    """Float columns f, g, h of random normal values with the subnormal,
    tiny, huge and non-finite edge cases, an int and a decimal column,
    and two lanes where rounding a float64 sum to float32 would round
    twice: (1 + 2^-23)(1 - 2^-24) + 2^-47(1 + 2^-23) is just above the
    midpoint between 1 and its float32 successor, and the same with the
    addend's sign flipped just below it."""
    n = 2048
    edge = np.array([3e-38, -3e-38, 1e-45, 1e-40, 0.0, -0.0, 1.0, np.inf,
                     np.nan, 1.5, 3e38, -3e38, 1.1754944e-38], np.float32)
    rng = np.random.default_rng(6)

    def floats():
        v = (rng.normal(0, 1, n)
             * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
        v[:13 * len(edge)] = np.tile(edge, 13)
        return v

    f, g, h = floats(), floats(), floats()
    g[:13 * len(edge)] = np.repeat(edge, 13)
    h[:169], h[169:338] = 0.0, -0.0
    one_up, one_down = np.float32(1 + 2.0 ** -23), np.float32(1 - 2.0 ** -24)
    f[-2:], g[-2:] = one_up, one_down
    h[-2:] = [2.0 ** -47 * (1 + 2.0 ** -23), -(2.0 ** -47) * (1 - 2.0 ** -23)]
    F = jbatch.Field
    js = jbatch.Schema([F("f", jbatch.FLOAT), F("g", jbatch.FLOAT),
                        F("h", jbatch.FLOAT), F("i", jbatch.INT),
                        F("d", jbatch.DECIMAL(2))])
    cols = {"f": f, "g": g, "h": h.astype(np.float32),
            "i": rng.integers(-1000, 1000, n),
            "d": rng.integers(-10 ** 6, 10 ** 6, n)}
    jb = jbatch.Batch({k: jbatch.Column(jnp.asarray(v))
                       for k, v in cols.items()},
                      jnp.ones(n, jnp.bool_), jnp.int32(n))
    return jb, js


def _contractions():
    """Float forms XLA's CPU backend rewrites under jit, each found by
    probing jax.jit(eval_expr): a product feeding + or - contracts into
    a fused multiply-add (one rounding, so 0.0 - f * f keeps the sign
    of an underflowing product); x / c is x * fl(1 / c), so a subnormal
    literal divisor leaves its lanes valid and divides by zero on the
    device; constant multipliers merge; a float operand of decimal
    arithmetic truncates to int64 saturating."""
    C, L, B = jx.Col, jx.Lit, jx.BinOp
    f, g, h, i, d = (C(n) for n in "fghid")
    fg = B("*", f, g)
    FLOAT = jbatch.FLOAT
    return {
        # the four shapes, 0.0 - f*f, and casts and folds
        # between the product and the add
        "h-f*g": B("-", h, fg), "f*g-h": B("-", fg, h),
        "h+f*g": B("+", h, fg), "f*g+h": B("+", fg, h),
        "0.0-f*f": B("-", L(0.0), B("*", f, f)),
        "h-cast(f*g)": B("-", h, jx.Cast(fg, FLOAT)),
        "0.0-cast(f*g)": B("-", L(0.0), jx.Cast(fg, FLOAT)),
        "h-(f*g+0.0)": B("-", h, B("+", fg, L(0.0))),
        "h-(f*g)*1.0": B("-", h, B("*", fg, L(1.0))),
        "h-(-1.0*(f*g))": B("-", h, B("*", L(-1.0), fg)),
        "(h-f*g)*1.0": B("*", B("-", h, fg), L(1.0)),
        # both operands products: the left one contracts
        "f*g+h*f": B("+", fg, B("*", h, f)),
        "f*g-h*f": B("-", fg, B("*", h, f)),
        # the product's operands: an int, a product, a constant
        "h-i*f": B("-", h, B("*", i, f)),
        "h-(f*g)*h": B("-", h, B("*", fg, h)),
        "(f*g+h)*2.0+h": B("+", B("*", B("+", fg, h), L(2.0)), h),
        # a decimal's conversion to float is a product too
        "h+cast(d)": B("+", h, jx.Cast(d, FLOAT)),
        "cast(d)-h": B("-", jx.Cast(d, FLOAT), h),
        "d/1.0+h": B("+", B("/", d, L(1.0)), h),
        # division by a constant: the reciprocal, merged and contracted
        "f/3.0": B("/", f, L(3.0)), "h+f/3.0": B("+", h, B("/", f, L(3.0))),
        "d/3.0": B("/", d, L(3.0)), "h-d/7.0": B("-", h, B("/", d, L(7.0))),
        "(f*3.0)/7.0": B("/", B("*", f, L(3.0)), L(7.0)),
        "((f/7.0)*3.0)*5.0": B("*", B("*", B("/", f, L(7.0)), L(3.0)),
                               L(5.0)),
        "(d/7.0)*3.0": B("*", B("/", d, L(7.0)), L(3.0)),
        "h-i/3.0": B("-", h, B("/", i, L(3.0))),
        # a subnormal literal divisor: valid lanes, inf or NaN values
        "f/1e-45": B("/", f, L(1e-45)), "f/-1e-45": B("/", f, L(-1e-45)),
        "h-f/1e-45": B("-", h, B("/", f, L(1e-45))),
        # a NULL constant or a zero divisor inside a rewritten form
        "h-(f*g)/0.0": B("-", h, B("/", fg, L(0.0))),
        "(f*3.0)/0.0": B("/", B("*", f, L(3.0)), L(0.0)),
        "h+(f*g+null)": B("+", h, B("+", fg, L(None, FLOAT))),
        # decimal arithmetic with a float operand
        "f+d": B("+", f, d), "d-f": B("-", d, f), "f*d": B("*", f, d),
        "i+d*f": B("+", i, B("*", d, f)),
    }


@pytest.fixture(scope="module")
def fma_batch():
    jb, js = _fma_batch()
    return jb, js, port_batch(jb), port_schema(js)


def test_fma_batch_has_double_rounding_lanes(fma_batch):
    """The last two lanes of f * g + h round to 1 + 2^-23 and 1 under
    jit: one rounding. Rounding their float64 sums to float32 gives 1
    for both."""
    jb, js, tb, ts = fma_batch
    e = _contractions()["f*g+h"]
    want = np.asarray(jax.jit(lambda b: jx.eval_expr(e, b, js))(jb).values)
    assert want[-2:].tolist() == [np.float32(1 + 2.0 ** -23), 1.0]
    f, g, h = (np.asarray(jb.columns[c].values)[-2:].astype(np.float64)
               for c in "fgh")
    assert (f * g + h).astype(np.float32).tolist() == [1.0, 1.0]
    got = tx.eval_expr(to_port(e), tb, ts, {})
    assert got.values[-2:].tolist() == want[-2:].tolist()


@pytest.mark.parametrize("name", sorted(_contractions()))
def test_xla_contractions_match_jax_under_jit(fma_batch, name):
    jb, js, tb, ts = fma_batch
    e = _contractions()[name]
    want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
    got = tx.eval_expr(to_port(e), tb, ts, {})
    if np.asarray(want.values).dtype == np.float32:
        _assert_same_bits(want, got, name)
    else:
        assert_same_column(want, got, name)


@pytest.mark.parametrize("name, calls", [
    ("((f/7.0)*3.0)*5.0", 2), ("(f*g+h)*2.0+h", 6), ("h-(f*g)*h", 6),
    ("h+cast(d)", 3), ("f/1e-45", 2)])
def test_rewritten_forms_evaluate_each_node_once(fma_batch, monkeypatch,
                                                 name, calls):
    """A rewritten float form evaluates only the nodes it reads, each
    once: ((f/7.0)*3.0)*5.0 reads f alone, (f*g+h)*2.0+h contracts
    twice over f, g, h and h, so nested chains and contractions cost no
    more than their leaves (h-(f*g)*h evaluates f*g once, as a plain
    product, and each of its two h nodes)."""
    jb, js, tb, ts = fma_batch
    e = to_port(_contractions()[name])
    seen = []
    inner = tx.eval_expr

    def counted(expr, batch, *args):
        if batch is tb:  # not the host's evaluation of a constant
            seen.append(expr)
        return inner(expr, batch, *args)

    monkeypatch.setattr(tx, "eval_expr", counted)
    got = tx.eval_expr(e, tb, ts, {})
    assert len(seen) == calls, [type(x).__name__ for x in seen]
    want = jax.jit(lambda b: jx.eval_expr(_contractions()[name], b, js))(jb)
    _assert_same_bits(want, got, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_contractions()))
def test_xla_contractions_match_jax_on_card(fma_batch, name):
    """On the card separate multiply and add kernels never contract, so
    the port's explicit one-rounding form must hold there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jb, js, _tb, ts = fma_batch
    e = _contractions()[name]
    want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
    got = tx.eval_expr(to_port(e), port_batch(jb, "cuda"), ts, {})
    assert got.values.is_cuda
    if np.asarray(want.values).dtype == np.float32:
        _assert_same_bits(want, got, name)
    else:
        assert_same_column(want, got, name)

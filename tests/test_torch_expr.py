"""The port's expression evaluation (cockroach_tpu_torch/ops/expr.py)
against the JAX package's eval_expr/filter_mask, bit for bit: Q1's
filter and decimal projections, _rescale's rounding, and three-valued
logic with NULLs. The JAX side runs under jit, as its MapOp runs it:
XLA compiles a float division by a constant into a multiplication by the
reciprocal, and the port rounds as that compiled program does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.ops import expr as jx
from cockroach_tpu.workload.tpch import TPCH as JTPCH
from cockroach_tpu.workload.tpch_queries import Q1_CUTOFF
from cockroach_tpu_torch.coldata.carry import batch_from_arrays, schema_from_spec
from cockroach_tpu_torch.ops import expr as tx


def port_schema(js):
    spec = [(f.name, f.type.kind.value, f.type.scale, f.dict_ref, f.wire,
             f.nullable) for f in js]
    return schema_from_spec(spec, js.dicts)


def port_batch(jb):
    cols = {n: (np.asarray(c.values),
                None if c.validity is None else np.asarray(c.validity))
            for n, c in jb.columns.items()}
    return batch_from_arrays(cols, np.asarray(jb.sel), int(jb.length), "cpu")


def to_port_expr(e):
    """Rebuild a JAX expression tree from the port's node classes."""
    if isinstance(e, jx.Col):
        return tx.Col(e.name)
    if isinstance(e, jx.Lit):
        ty = None if e.ty is None else port_schema(
            jbatch.Schema([jbatch.Field("_", e.ty)])).field("_").type
        return tx.Lit(e.value, ty)
    if isinstance(e, jx.BinOp):
        return tx.BinOp(e.op, to_port_expr(e.left), to_port_expr(e.right))
    if isinstance(e, jx.Cmp):
        return tx.Cmp(e.op, to_port_expr(e.left), to_port_expr(e.right))
    if isinstance(e, jx.BoolOp):
        return tx.BoolOp(e.op, tuple(to_port_expr(a) for a in e.args))
    if isinstance(e, jx.Not):
        return tx.Not(to_port_expr(e.arg))
    if isinstance(e, jx.IsNull):
        return tx.IsNull(to_port_expr(e.arg), e.negate)
    raise TypeError(type(e))


def assert_same_column(jc, tc, what):
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values),
                                  err_msg=what)
    assert tc.values.dtype == torch.from_numpy(
        np.zeros(0, np.asarray(jc.values).dtype)).dtype, what
    jv = None if jc.validity is None else np.asarray(jc.validity)
    tv = None if tc.validity is None else tc.validity.numpy()
    assert (jv is None) == (tv is None), what
    if jv is not None:
        np.testing.assert_array_equal(tv, jv, err_msg=what)


def _lineitem_batch():
    gen = JTPCH(sf=0.01)
    js = gen.schema("lineitem")
    cols = gen.rows("lineitem", 0, 4096)
    jb = jbatch.Batch.from_columns(
        {f.name: jbatch.Column(jnp.asarray(
            cols[f.name].astype(np.dtype(f.type.dtype)))) for f in js})
    return jb, js


def _q1_exprs():
    one = jx.Lit(1.0, jbatch.DECIMAL(2))
    disc_price = jx.BinOp("*", jx.Col("l_extendedprice"),
                          jx.BinOp("-", one, jx.Col("l_discount")))
    charge = jx.BinOp("*", disc_price,
                      jx.BinOp("+", one, jx.Col("l_tax")))
    return {
        "shipdate_le": jx.Cmp("<=", jx.Col("l_shipdate"),
                              jx.Lit(Q1_CUTOFF, jbatch.INT)),
        "disc_price": disc_price,
        "charge": charge,
        "one_minus_disc": jx.BinOp("-", one, jx.Col("l_discount")),
        # scale 2 + scale 4: the scale-2 side rescales up
        "qty_plus_disc_price": jx.BinOp("+", jx.Col("l_quantity"),
                                        disc_price),
        "price_per_qty": jx.BinOp("/", jx.Col("l_extendedprice"),
                                  jx.Col("l_quantity")),
        "rf_eq": jx.Cmp("==", jx.Col("l_returnflag"), jx.Lit("N")),
        "rf_lt": jx.Cmp("<", jx.Col("l_returnflag"), jx.Lit("R")),
    }


@pytest.mark.parametrize("name", sorted(_q1_exprs()))
def test_q1_expressions_match_jax(name):
    jb, js = _lineitem_batch()
    e = _q1_exprs()[name]
    want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
    got = tx.eval_expr(to_port_expr(e), port_batch(jb), port_schema(js))
    assert_same_column(want, got, name)


def test_q1_filter_mask_matches_jax():
    jb, js = _lineitem_batch()
    e = _q1_exprs()["shipdate_le"]
    want = jax.jit(lambda b: jx.filter_mask(e, b, js))(jb)
    got = tx.filter_mask(to_port_expr(e), port_batch(jb), port_schema(js))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_RESCALE_VALUES = np.array(
    [0, 1, -1, 49, 50, 51, -49, -50, -51, 149, 150, 151, -149, -150, -151,
     250, -250, 9999, -9999, 10050, -10050, 123456789, -123456789,
     (1 << 62), -(1 << 62), np.iinfo(np.int64).max,
     np.iinfo(np.int64).min + 1], dtype=np.int64)


@pytest.mark.parametrize("from_scale,to_scale",
                         [(4, 2), (6, 2), (2, 0), (3, 1), (2, 4), (2, 2)])
def test_rescale_matches_jax(from_scale, to_scale):
    want = jx._rescale(jnp.asarray(_RESCALE_VALUES), from_scale, to_scale)
    got = tx._rescale(torch.from_numpy(_RESCALE_VALUES), from_scale, to_scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rescale_rounds_half_away_from_zero():
    v = torch.tensor([150, 149, -150, -149, 250, -250], dtype=torch.int64)
    assert tx._rescale(v, 2, 0).tolist() == [2, 1, -2, -1, 3, -3]


def _null_batch():
    rng = np.random.default_rng(5)
    n = 512
    F = jbatch.Field
    js = jbatch.Schema([F("p", jbatch.BOOL), F("q", jbatch.BOOL),
                        F("d", jbatch.DECIMAL(2)), F("e", jbatch.DECIMAL(4)),
                        F("i", jbatch.INT)])
    cols = {
        "p": jbatch.Column(jnp.asarray(rng.random(n) > 0.5),
                           jnp.asarray(rng.random(n) > 0.3)),
        "q": jbatch.Column(jnp.asarray(rng.random(n) > 0.5),
                           jnp.asarray(rng.random(n) > 0.3)),
        "d": jbatch.Column(jnp.asarray(rng.integers(-5000, 5000, n)),
                           jnp.asarray(rng.random(n) > 0.2)),
        "e": jbatch.Column(jnp.asarray(rng.integers(-500000, 500000, n))),
        "i": jbatch.Column(jnp.asarray(rng.integers(-9, 9, n))),
    }
    sel = rng.random(n) > 0.1
    return jbatch.Batch(cols, jnp.asarray(sel), jnp.int32(int(sel.sum()))), js


def _null_exprs():
    p, q, d, e, i = (jx.Col(c) for c in "pqdei")
    return {
        "and": jx.BoolOp("and", (p, q)),
        "or": jx.BoolOp("or", (p, q)),
        "and3": jx.BoolOp("and", (p, q, jx.Cmp(">", d, jx.Lit(0.5, jbatch.DECIMAL(2))))),
        "not": jx.Not(p),
        "is_null": jx.IsNull(d),
        "is_not_null": jx.IsNull(d, negate=True),
        "dec_cmp_mixed_scale": jx.Cmp("<", d, e),
        "dec_minus_mixed_scale": jx.BinOp("-", d, e),
        "dec_div": jx.BinOp("/", e, d),
        "int_arith": jx.BinOp("*", jx.BinOp("+", i, jx.Lit(3)), i),
        "null_lit": jx.BinOp("+", i, jx.Lit(None, jbatch.INT)),
    }


@pytest.mark.parametrize("name", sorted(_null_exprs()))
def test_three_valued_logic_matches_jax(name):
    jb, js = _null_batch()
    e = _null_exprs()[name]
    want = jax.jit(lambda b: jx.eval_expr(e, b, js))(jb)
    got = tx.eval_expr(to_port_expr(e), port_batch(jb), port_schema(js))
    assert_same_column(want, got, name)


def test_unported_node_names_its_roadmap_item():
    class Other(tx.Expr):
        pass

    jb, js = _null_batch()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tx.eval_expr(Other(), port_batch(jb), port_schema(js))

"""The port's columnar format (cockroach_tpu_torch/coldata) against the
JAX package's: the packed ingest format and its unpack, compact,
concat_batches and mask_padding. Inputs come from numpy with a fixed
seed; both packages get the same arrays (coldata/carry.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cockroach_tpu.coldata import arrow as jarrow
from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu_torch.coldata import arrow as tarrow
from cockroach_tpu_torch.coldata import batch as tbatch
from cockroach_tpu_torch.coldata.carry import batch_from_arrays, schema_from_spec


def port_schema(js):
    spec = [(f.name, f.type.kind.value, f.type.scale, f.dict_ref, f.wire,
             f.nullable) for f in js]
    return schema_from_spec(spec, js.dicts)


def port_batch(jb):
    cols = {n: (np.asarray(c.values),
                None if c.validity is None else np.asarray(c.validity))
            for n, c in jb.columns.items()}
    return batch_from_arrays(cols, np.asarray(jb.sel), int(jb.length), "cpu")


def assert_same(jb, tb, names=None):
    """Values, validity, sel and length, bit for bit."""
    np.testing.assert_array_equal(tb.sel.numpy(), np.asarray(jb.sel))
    assert int(tb.length) == int(jb.length)
    for n in names or jb.names():
        jc, tc = jb.col(n), tb.col(n)
        np.testing.assert_array_equal(tc.values.numpy(),
                                      np.asarray(jc.values), err_msg=n)
        assert (tc.validity is None) == (jc.validity is None), n
        if jc.validity is not None:
            np.testing.assert_array_equal(tc.validity.numpy(),
                                          np.asarray(jc.validity), err_msg=n)


def _ingest_schema():
    F = jbatch.Field
    return jbatch.Schema([
        F("k", jbatch.INT, wire="i2"),
        F("price", jbatch.DECIMAL(2), wire="i4"),
        F("day", jbatch.DATE, wire="i2"),
        F("flag", jbatch.STRING, dict_ref="flag", wire="i1"),
        F("b", jbatch.BOOL),
        F("x", jbatch.FLOAT),
        F("n", jbatch.INT, nullable=True),
        F("m", jbatch.DECIMAL(2), wire="i4", nullable=True),
    ], {"flag": np.asarray(["R", "A", "N"], dtype=object)})


def _ingest_chunk(rng, n):
    return {
        "k": rng.integers(-30000, 30000, n),
        "price": rng.integers(-(1 << 30), 1 << 30, n),
        "day": rng.integers(8000, 11000, n).astype(np.int32),
        "flag": rng.integers(0, 3, n).astype(np.int32),
        "b": rng.random(n) > 0.5,
        "x": rng.standard_normal(n).astype(np.float32),
        "n": rng.integers(-(1 << 62), 1 << 62, n),
        "n__valid": (rng.random(n) > 0.3).astype(np.uint8),
        "m": rng.integers(0, 1 << 20, n),
        # no "m__valid": the packer defaults the lane to all-valid
    }


@pytest.mark.parametrize("n,cap", [(1000, 1024), (1024, 1024), (1, 64)])
def test_pack_unpack_matches_jax(n, cap):
    rng = np.random.default_rng(7)
    js = _ingest_schema()
    ts = port_schema(js)
    chunk = _ingest_chunk(rng, n)
    jbuf, jn = jarrow.pack_chunk(chunk, js, cap)
    tbuf, tn = tarrow.pack_chunk(chunk, ts, cap)
    assert tn == jn == n
    np.testing.assert_array_equal(tbuf, jbuf)
    jb = jarrow.make_unpack(js, cap)(jnp.asarray(jbuf), jn)
    tb = tarrow.make_unpack(ts, cap)(torch.from_numpy(tbuf), tn)
    assert_same(jb, tb)
    for f in ts:
        assert tb.col(f.name).values.dtype == f.type.dtype, f.name


def test_pack_into_reused_buffer_clears_old_rows():
    rng = np.random.default_rng(8)
    ts = port_schema(_ingest_schema())
    cap = 256
    buf = np.full(tarrow.pack_layout(ts, cap)[1], 0xAB, dtype=np.uint8)
    tarrow.pack_into(buf, _ingest_chunk(rng, cap), ts, cap)
    small = _ingest_chunk(rng, 10)
    m = tarrow.pack_into(buf, small, ts, cap)
    fresh, _ = tarrow.pack_chunk(small, ts, cap)
    layout, _total = tarrow.pack_layout(ts, cap)
    for _name, _dt, off, nbytes in layout:
        np.testing.assert_array_equal(buf[off:off + nbytes],
                                      fresh[off:off + nbytes])
    assert m == 10


def _random_jax_batch(rng, cap, null_rate=0.3, sel_rate=0.6):
    sel = rng.random(cap) < sel_rate
    return jbatch.Batch({
        "a": jbatch.Column(jnp.asarray(rng.integers(-1000, 1000, cap))),
        "f": jbatch.Column(jnp.asarray(
            rng.standard_normal(cap).astype(np.float32))),
        "s": jbatch.Column(jnp.asarray(
            rng.integers(0, 5, cap).astype(np.int32)),
            jnp.asarray(rng.random(cap) > null_rate)),
        "t": jbatch.Column(jnp.asarray(rng.random(cap) > 0.5)),
    }, jnp.asarray(sel), jnp.int32(int(sel.sum())))


@pytest.mark.parametrize("cap", [1, 37, 1024])
def test_compact_matches_jax(cap):
    jb = _random_jax_batch(np.random.default_rng(cap), cap)
    assert_same(jb.compact(), port_batch(jb).compact())


def test_concat_batches_matches_jax():
    rng = np.random.default_rng(11)
    jbs = [_random_jax_batch(rng, cap) for cap in (16, 100, 3)]
    # a column without validity in one batch and with it in another
    jbs[1] = jbs[1].with_column(
        "a", jbatch.Column(jbs[1].col("a").values,
                           jnp.asarray(rng.random(100) > 0.5)))
    want = jbatch.concat_batches(jbs)
    got = tbatch.concat_batches([port_batch(b) for b in jbs])
    assert_same(want, got)


def test_concat_batches_rejects_mixed_dictionaries():
    F = tbatch.Field
    s1 = tbatch.Schema([F("c", tbatch.STRING, "d1")],
                       {"d1": np.asarray(["x"], dtype=object)})
    s2 = tbatch.Schema([F("c", tbatch.STRING, "d2")],
                       {"d2": np.asarray(["y"], dtype=object)})
    b = tbatch.Batch.from_columns({"c": tbatch.Column(torch.zeros(2, dtype=torch.int32))})
    with pytest.raises(ValueError):
        tbatch.concat_batches([b, b], [s1, s2])


def test_mask_padding_matches_jax():
    rng = np.random.default_rng(12)
    jb = _random_jax_batch(rng, 300)
    keep = rng.random(300) > 0.5
    want = jbatch.mask_padding(jb.columns, jnp.asarray(keep))
    got = tbatch.mask_padding(port_batch(jb).columns, torch.from_numpy(keep))
    for n in want:
        np.testing.assert_array_equal(got[n].values.numpy(),
                                      np.asarray(want[n].values), err_msg=n)
        assert (got[n].validity is None) == (want[n].validity is None)
        if want[n].validity is not None:
            np.testing.assert_array_equal(got[n].validity.numpy(),
                                          np.asarray(want[n].validity))


def test_numpy_to_batch_matches_jax():
    rng = np.random.default_rng(13)
    js = jbatch.Schema([jbatch.Field("a", jbatch.INT),
                        jbatch.Field("d", jbatch.DATE)])
    data = {"a": rng.integers(0, 99, 50), "d": rng.integers(0, 99, 50)}
    want = jarrow.numpy_to_batch(data, js, capacity=64)
    got = tarrow.numpy_to_batch(data, port_schema(js), capacity=64,
                                device="cpu")
    assert_same(want, got)

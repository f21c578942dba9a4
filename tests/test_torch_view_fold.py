"""The port's ops/view_fold.py against the JAX package's, bit for bit.

The same numpy deltas fold through both packages' GroupState; after
every fold the whole device state (every capacity slot of the counts and
of the per-input count, sum, min and max lanes), the host key vector,
the counters and `read()` must be equal. The sequences cover inserts,
retractions (overwrites and deletes as sign -1), growth past several
pow2 capacities, min/max, deltas of every padding shape around the
64-lane bucket, and int64 wrap of the sums. Then `pack_keys` /
`unpack_keys` at the 32-bit edges, each FoldUnsupported case, `avg_f32`,
`warm_fold` (no state change) and `carry_group_state`. The card's
twin is in tests/test_torch_stream_vector_cuda.py, which imports no
JAX."""

import numpy as np
import pytest
import torch

from cockroach_tpu.ops import view_fold as jvf
from cockroach_tpu_torch.coldata.carry import carry_group_state
from cockroach_tpu_torch.ops import view_fold as tvf
from torch_threads import one_torch_thread  # noqa: F401

LANES = ("counts", "acnt", "asum", "amin", "amax")


def _assert_same(js, ts):
    assert np.array_equal(np.asarray(js.keys), ts.keys)
    assert js.gcap == ts.gcap
    assert (js.folds, js.generation) == (ts.folds, ts.generation)
    for name in LANES:
        j = np.asarray(getattr(js, name))
        t = getattr(ts, name).cpu().numpy()
        assert j.dtype == t.dtype == np.int64, name
        assert j.shape == t.shape, name
        assert np.array_equal(j, t), name
    jr, tr = js.read(), ts.read()
    assert jr.keys() == tr.keys()
    for k in jr:
        assert np.array_equal(np.asarray(jr[k]), tr[k]), k
    assert js.counts_consistent() == ts.counts_consistent()
    assert js.nbytes() == ts.nbytes()


def _delta(rng, n, n_inputs, key_hi, p_retract=0.0, wide=False):
    packed = rng.integers(-key_hi, key_hi, n).astype(np.int64)
    sign = np.where(rng.random(n) < p_retract, -1, 1).astype(np.int64)
    if wide:
        vals = rng.integers(-(2**62), 2**62, (n_inputs, n)).astype(
            np.int64) * 3
    else:
        vals = rng.integers(-1000, 1000, (n_inputs, n)).astype(np.int64)
    valid = rng.random((n_inputs, n)) < 0.85
    return packed, sign, vals, valid


def _both(n_inputs):
    return jvf.GroupState(n_inputs), tvf.GroupState(n_inputs, "cpu")


# delta lengths around the 64-lane bucket and past it
SIZES = [1, 2, 63, 64, 65, 127, 128, 129, 300]


@pytest.mark.parametrize("n_inputs", [1, 3])
def test_fold_sequence_bit_exact(n_inputs):
    rng = np.random.default_rng(11 + n_inputs)
    js, ts = _both(n_inputs)
    _assert_same(js, ts)
    # growth: key span widens every round, crossing several pow2 caps
    for i, n in enumerate(SIZES):
        d = _delta(rng, n, n_inputs, key_hi=2 + 4 * i,
                   p_retract=0.0 if i < 3 else 0.3)
        js.fold(*d)
        ts.fold(*d)
        _assert_same(js, ts)
    assert ts.gcap >= 32


def test_fold_inserts_then_exact_retractions():
    """Insert rows, then retract a subset: the state equals the state of
    the rows that remain (count-per-group retraction), and groups that
    empty drop out of read()."""
    rng = np.random.default_rng(5)
    js, ts = _both(2)
    packed, sign, vals, valid = _delta(rng, 200, 2, key_hi=9)
    js.fold(packed, sign, vals, valid)
    ts.fold(packed, sign, vals, valid)
    drop = rng.random(200) < 0.5
    neg = -np.ones(int(drop.sum()), np.int64)
    js.fold(packed[drop], neg, vals[:, drop], valid[:, drop])
    ts.fold(packed[drop], neg, vals[:, drop], valid[:, drop])
    _assert_same(js, ts)
    # the same rows folded fresh give the same counts and sums
    fresh = tvf.GroupState(2, "cpu")
    keep = ~drop
    fresh.fold(packed[keep], np.ones(int(keep.sum()), np.int64),
               vals[:, keep], valid[:, keep])
    got, want = ts.read(), fresh.read()
    for k in ("keys", "counts", "acnt", "asum"):
        assert np.array_equal(got[k], want[k]), k


def test_fold_sums_wrap_mod_2_64():
    rng = np.random.default_rng(6)
    js, ts = _both(2)
    for _ in range(4):
        d = _delta(rng, 100, 2, key_hi=3, wide=True)
        js.fold(*d)
        ts.fold(*d)
    _assert_same(js, ts)


def test_minmax_and_padding_lanes_are_noops():
    """A delta of one row pads to 64 lanes (index 0, sign 0, valid
    False): slot 0's min and max must not take the padding's zeros."""
    js, ts = _both(1)
    for st in (js, ts):
        st.fold(np.array([5, 9], np.int64), np.array([1, 1], np.int64),
                np.array([[70, -3]], np.int64),
                np.array([[True, True]]))
        st.fold(np.array([5], np.int64), np.array([1], np.int64),
                np.array([[40]], np.int64), np.array([[True]]))
    _assert_same(js, ts)
    snap = ts.read()
    assert snap["amin"].tolist() == [[40, -3]]
    assert snap["amax"].tolist() == [[70, -3]]
    # an invalid input lane leaves min/max and the valid count alone
    for st in (js, ts):
        st.fold(np.array([9], np.int64), np.array([1], np.int64),
                np.array([[-100]], np.int64), np.array([[False]]))
    _assert_same(js, ts)
    assert ts.read()["amin"].tolist() == [[40, -3]]


def test_unabsorbed_retraction_is_inconsistent():
    js, ts = _both(1)
    for st in (js, ts):
        st.fold(np.array([1], np.int64), np.array([1], np.int64),
                np.array([[3]], np.int64), np.array([[True]]))
        st.fold(np.array([2], np.int64), np.array([-1], np.int64),
                np.array([[3]], np.int64), np.array([[True]]))
    _assert_same(js, ts)
    assert not ts.counts_consistent()


@pytest.mark.parametrize("k0,k1", [
    (0, 0), (2**31 - 1, 2**31 - 1), (-(2**31 - 1), -(2**31 - 1)),
    (2**31 - 1, -(2**31 - 1)), (-1, 1), (123456, -7)])
def test_pack_unpack_32_bit_edges(k0, k1):
    cols = [np.array([k0, 0, -5], np.int64), np.array([k1, -1, 5],
                                                      np.int64)]
    jp, tp = jvf.pack_keys(cols), tvf.pack_keys(cols)
    assert np.array_equal(jp, tp)
    for a, b in zip(jvf.unpack_keys(jp, 2), tvf.unpack_keys(tp, 2)):
        assert np.array_equal(a, b)
    back = tvf.unpack_keys(tp, 2)
    assert back[0].tolist() == cols[0].tolist()
    assert back[1].tolist() == cols[1].tolist()
    one = np.array([2**62, -(2**63)], np.int64)
    assert np.array_equal(jvf.pack_keys([one]), tvf.pack_keys([one]))
    assert np.array_equal(tvf.unpack_keys(one, 1)[0], one)


@pytest.mark.parametrize("cols", [
    [np.array([2**31], np.int64), np.array([0], np.int64)],
    [np.array([0], np.int64), np.array([-(2**31)], np.int64)],
    [np.array([1], np.int64)] * 3,
], ids=["hi-past-31-bits", "lo-at-minus-2^31", "three-columns"])
def test_pack_unsupported(cols):
    with pytest.raises(jvf.FoldUnsupported):
        jvf.pack_keys(cols)
    with pytest.raises(tvf.FoldUnsupported):
        tvf.pack_keys(cols)


def test_max_groups_refusal(monkeypatch):
    monkeypatch.setattr(jvf, "MAX_GROUPS", 8)
    monkeypatch.setattr(tvf, "MAX_GROUPS", 8)
    js, ts = _both(1)
    ok = np.arange(8, dtype=np.int64)
    one = np.ones(8, np.int64)
    for st in (js, ts):
        st.fold(ok, one, ok[None, :], np.ones((1, 8), bool))
    _assert_same(js, ts)
    more = np.arange(4, 12, dtype=np.int64)
    with pytest.raises(jvf.FoldUnsupported):
        js.fold(more, one, more[None, :], np.ones((1, 8), bool))
    with pytest.raises(tvf.FoldUnsupported):
        ts.fold(more, one, more[None, :], np.ones((1, 8), bool))
    _assert_same(js, ts)  # a refused fold leaves the state as it was


def test_avg_f32():
    rng = np.random.default_rng(9)
    asum = np.concatenate([rng.integers(-(2**40), 2**40, 50),
                           [0, 1, -1, 2**53 + 1, -(2**62)]]).astype(
        np.int64)
    acnt = np.concatenate([rng.integers(0, 1000, 50),
                           [0, 0, 3, 7, 1]]).astype(np.int64)
    j, t = jvf.avg_f32(asum, acnt), tvf.avg_f32(asum, acnt)
    assert j.dtype == t.dtype == np.float32
    assert np.array_equal(j.view(np.int32), t.view(np.int32))


def test_warm_fold_changes_nothing():
    rng = np.random.default_rng(3)
    js, ts = _both(2)
    d = _delta(rng, 40, 2, key_hi=6)
    js.fold(*d)
    ts.fold(*d)
    tvf.warm_fold(ts, tvf.delta_bucket(1))
    _assert_same(js, ts)


def test_carry_group_state_then_fold():
    rng = np.random.default_rng(21)
    js = jvf.GroupState(2)
    for n in (30, 70):
        js.fold(*_delta(rng, n, 2, key_hi=12, p_retract=0.2))
    ts = carry_group_state(js, "cpu")
    _assert_same(js, ts)
    assert ts.device == torch.device("cpu")
    d = _delta(rng, 90, 2, key_hi=40, p_retract=0.1)
    js.fold(*d)
    ts.fold(*d)
    _assert_same(js, ts)


def test_group_state_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tvf.GroupState(1)

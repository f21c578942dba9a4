"""The port's MVCC storage layer against the JAX package's.

cockroach_tpu_torch/storage/ (the native C++ engine, built by the port
into build/torch_native/, the Python model engine and MVCCStore),
util/hlc.py and util/fault.py, held to cockroach_tpu/storage/ on the
same histories: the datadriven corpus byte for byte, random histories
read back through get, scan_keys, scan_to_cols, export_span and
engine_fingerprint, the durability and crash cases of test_durability.py
and test_crash.py, and a data directory written by the port's engines
and opened by the JAX package's. Tolerance: exact everywhere (bytes,
int64 columns, fingerprints).
"""

import glob
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from cockroach_tpu_torch.storage import (
    MVCCStore, NativeEngine, PyEngine, open_engine, run_datadriven,
)
from cockroach_tpu_torch.storage.engine import (
    _load, crc32c, engine_fingerprint, iter_records, pack_record,
)
from cockroach_tpu_torch.storage.mvcc import encode_key, encode_row
from cockroach_tpu_torch.util import fault
from cockroach_tpu_torch.util.fault import (
    DurableFile, SimulatedCrash, corrupt_file, crash_point, tear_file,
)
from cockroach_tpu_torch.util.hlc import HLC, ManualClock, Timestamp
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "testdata", "mvcc")
ENGINES = ["native", "py"]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.registry().disarm()


def _engine(kind, **kw):
    return NativeEngine(**kw) if kind == "native" else PyEngine(**kw)


def _jax_engine(kind, **kw):
    from cockroach_tpu.storage.engine import NativeEngine as JN
    from cockroach_tpu.storage.engine import PyEngine as JP

    return JN(**kw) if kind == "native" else JP(**kw)


def _ts(w, l=0):
    return Timestamp(w, l)


def _jts(w, l=0):
    from cockroach_tpu.util.hlc import Timestamp as JTimestamp

    return JTimestamp(w, l)


def _plain(entries):
    return [(k, (ts.wall, ts.logical), v) for k, ts, v in entries]


def test_native_engine_builds_under_build_dir():
    lib = _load()
    assert lib is not None
    path = lib._name
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "torch_native")
    assert os.path.basename(path).startswith("mvcc_engine-")
    # the C++ source is the JAX package's, byte for byte
    with open(os.path.join(REPO, "cockroach_tpu_torch", "storage", "native",
                           "mvcc_engine.cpp"), "rb") as a, \
            open(os.path.join(REPO, "cockroach_tpu", "storage", "native",
                              "mvcc_engine.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert not glob.glob(os.path.join(REPO, "cockroach_tpu_torch", "storage",
                                      "native", "*.so"))
    assert isinstance(open_engine(), NativeEngine)


# ------------------------------------------------------------ datadriven


def _scripts():
    return sorted(glob.glob(os.path.join(TESTDATA, "*.txt")))


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("path", _scripts(),
                         ids=[os.path.basename(p) for p in _scripts()])
def test_datadriven_matches_jax_transcript(path, kind):
    from cockroach_tpu.storage import MVCCStore as JStore
    from cockroach_tpu.storage import PyEngine as JPy
    from cockroach_tpu.storage import run_datadriven as jrun

    with open(path) as f:
        text = f.read()
    want = jrun(text, JStore(engine=JPy()))
    got = run_datadriven(text, MVCCStore(engine=_engine(kind)))
    assert got == want


# -------------------------------------------------------- random history


@pytest.mark.parametrize("kind", ENGINES)
def test_random_history_matches_jax(kind):
    """Random puts/deletes (tombstones) and flushes through the port's
    engine and both JAX engines: every read agrees."""
    rng = np.random.default_rng(11)
    port = _engine(kind, flush_threshold=1 << 12) if kind == "native" \
        else _engine(kind)
    jn = _jax_engine("native", flush_threshold=1 << 12)
    jp = _jax_engine("py")
    keys = [encode_key(4, int(i)) for i in rng.choice(1000, 40,
                                                      replace=False)]
    for step in range(1200):
        op = rng.integers(0, 10)
        key = keys[rng.integers(0, len(keys))]
        w, l = int(rng.integers(1, 60)), int(rng.integers(0, 3))
        if op < 6:
            val = encode_row(rng.integers(-2**40, 2**40, 3).tolist())
            port.put(key, _ts(w, l), val)
            for e in (jn, jp):
                e.put(key, _jts(w, l), val)
        elif op < 8:
            port.delete(key, _ts(w, l))
            for e in (jn, jp):
                e.delete(key, _jts(w, l))
        else:
            got = port.get(key, _ts(w, l))
            want = jp.get(key, _jts(w, l))
            assert (got is None) == (want is None)
            if got is not None:
                assert got[0] == want[0]
                assert (got[1].wall, got[1].logical) == \
                    (want[1].wall, want[1].logical)
        if step % 300 == 299:
            port.flush()
            jn.flush()
    from cockroach_tpu.storage.engine import \
        engine_fingerprint as jfingerprint

    want_export = _plain(jp.export_span(b"", b""))
    assert _plain(port.export_span(b"", b"")) == want_export
    assert _plain(jn.export_span(b"", b"")) == want_export
    assert engine_fingerprint(port) == jfingerprint(jp)
    start, end = encode_key(4, 0), encode_key(5, 0)
    for w in (1, 15, 30, 59, 100):
        assert engine_fingerprint(port, ts=_ts(w)) == \
            jfingerprint(jp, ts=_jts(w))
        assert port.scan_keys(start, end, _ts(w, 1)) == \
            jp.scan_keys(start, end, _jts(w, 1))
        for cap in (7, 64):
            got = port.scan_to_cols(start, end, _ts(w, 1), 3, cap,
                                    with_pks=True)
            want = jn.scan_to_cols(start, end, _jts(w, 1), 3, cap,
                                   with_pks=True)
            assert got.rows == want.rows and got.more == want.more
            assert got.resume_key == want.resume_key
            assert np.array_equal(got.cols, want.cols)
            assert np.array_equal(got.pks, want.pks)


@pytest.mark.parametrize("kind", ENGINES)
def test_scan_resume_pagination(kind):
    st = MVCCStore(engine=_engine(kind), clock=HLC(ManualClock(10)))
    for pk in range(100):
        st.put(1, pk, [pk, pk * 2])
    got = []
    for chunk in st.scan_chunks(1, 2, capacity=7):
        assert len(chunk["f0"]) <= 7
        got.extend(chunk["f0"].tolist())
    assert got == list(range(100))


@pytest.mark.parametrize("kind", ENGINES)
def test_snapshot_isolation_under_writes(kind):
    clock = HLC(ManualClock(100))
    st = MVCCStore(engine=_engine(kind), clock=clock)
    for pk in range(20):
        st.put(1, pk, [pk])
    snap = clock.now()
    for pk in range(20):
        st.put(1, pk, [pk + 1000])
    st.put(1, 99, [99])
    old = [c["f0"].tolist() for c in st.scan_chunks(1, 1, 64, ts=snap)]
    new = [c["f0"].tolist() for c in st.scan_chunks(1, 1, 64)]
    assert old == [list(range(20))]
    assert new == [[i + 1000 for i in range(20)] + [99]]


def test_store_versions_and_cache_prefix():
    st = MVCCStore(engine=NativeEngine(), clock=HLC(ManualClock(10)))
    assert st.table_version(5) == 0
    st.put(5, 1, [1])
    st.delete(5, 1)
    st.ingest_table(5, [2, 3], {"a": np.array([7, 8])})
    assert st.table_version(5) == 3
    assert st.scan_cache_prefix(5) == ("mvcc", id(st.engine), 5)
    assert st.get(5, 2)[0] == [7]
    assert st.get(5, 1) is None


# ------------------------------------------------- durability (native)


def test_reopen_recovers_wal_and_runs(tmp_path):
    d = str(tmp_path / "eng")
    e = NativeEngine(path=d)
    e.put(b"a", _ts(10), b"va")
    e.put(b"b", _ts(11), b"vb")
    e.flush()
    e.put(b"c", _ts(12), b"vc")
    e.sync()
    e.close()
    e2 = NativeEngine(path=d)
    assert e2.get(b"a", _ts(20))[0] == b"va"
    assert e2.get(b"b", _ts(20))[0] == b"vb"
    assert e2.get(b"c", _ts(20))[0] == b"vc"
    assert e2.get(b"c", _ts(11)) is None
    e2.close()


def test_reopen_after_compaction(tmp_path):
    d = str(tmp_path / "eng")
    e = NativeEngine(path=d, flush_threshold=64)
    for i in range(100):
        e.put(b"k%03d" % i, _ts(i + 1), b"v%03d" % i)
    e.sync()
    e.close()
    e2 = NativeEngine(path=d)
    for i in range(100):
        assert e2.get(b"k%03d" % i, _ts(1000))[0] == b"v%03d" % i
    assert len([f for f in os.listdir(d) if f.endswith(".sst")]) <= 9
    e2.close()


@pytest.mark.parametrize("kind", ENGINES)
def test_tombstones_survive_reopen(tmp_path, kind):
    d = str(tmp_path / "eng")
    e = _engine(kind, path=d)
    e.put(b"k", _ts(1), b"v1")
    e.delete(b"k", _ts(5))
    e.sync()
    e.close()
    e2 = _engine(kind, path=d)
    assert e2.get(b"k", _ts(10)) is None
    assert e2.get(b"k", _ts(3))[0] == b"v1"
    e2.close()


@pytest.mark.parametrize("kind", ENGINES)
def test_ingest_matches_per_row_puts(kind):
    rng = np.random.default_rng(7)
    n = 1000
    pks = np.sort(rng.choice(10 * n, size=n, replace=False)).astype(np.int64)
    c0 = rng.integers(-1000, 1000, n).astype(np.int64)
    c1 = rng.integers(0, 1 << 40, n).astype(np.int64)
    st_a = MVCCStore(engine=_engine(kind), clock=HLC(ManualClock(100)))
    st_a.ingest_table(7, pks, {"c0": c0, "c1": c1}, ts=_ts(50))
    st_b = MVCCStore(engine=_engine(kind), clock=HLC(ManualClock(100)))
    for i in range(n):
        st_b.put(7, int(pks[i]), [int(c0[i]), int(c1[i])], ts=_ts(50))
    for st in (st_a, st_b):
        chunks = list(st.scan_chunks(7, 2, 1 << 9, ts=_ts(99)))
        assert np.array_equal(np.concatenate([c["f0"] for c in chunks]), c0)
        assert np.array_equal(np.concatenate([c["f1"] for c in chunks]), c1)
    assert st_a.fingerprint(7) == st_b.fingerprint(7)


def test_ingest_unsorted_pks(tmp_path):
    st = MVCCStore(engine=NativeEngine(path=str(tmp_path / "e")),
                   clock=HLC(ManualClock(100)))
    st.ingest_table(3, np.array([5, 1, 9, 3], dtype=np.int64),
                    {"v": np.array([50, 10, 90, 30], dtype=np.int64)},
                    ts=_ts(10))
    chunks = list(st.scan_chunks(3, 1, 16, ts=_ts(99)))
    assert chunks[0]["f0"].tolist() == [10, 30, 50, 90]


def test_ingest_durable_and_recovered(tmp_path):
    d = str(tmp_path / "eng")
    e = NativeEngine(path=d)
    pks = np.arange(500, dtype=np.int64)
    e.ingest(9, pks, [pks * 3], _ts(10))
    e.close()
    e2 = NativeEngine(path=d)
    hit = e2.get(encode_key(9, 123), _ts(99))
    assert int.from_bytes(hit[0][:8], "little", signed=True) == 369
    e2.close()


_CRASH_CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    from cockroach_tpu_torch.storage.engine import NativeEngine
    from cockroach_tpu_torch.util.hlc import Timestamp
    e = NativeEngine(path={d!r})
    for i in range(200):
        e.put(b"k%04d" % i, Timestamp(i + 1, 0), b"v%04d" % i)
    e.flush()
    for i in range(200, 300):
        e.put(b"k%04d" % i, Timestamp(i + 1, 0), b"v%04d" % i)
    e.sync()
    print("READY", flush=True)
    os.kill(os.getpid(), 9)
""")


def test_kill9_recovers_synced_writes(tmp_path):
    d = str(tmp_path / "eng")
    _load()  # build before the child, which then only loads
    proc = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD.format(repo=REPO, d=d)],
        capture_output=True, timeout=120, text=True)
    assert "READY" in proc.stdout, proc.stderr
    assert proc.returncode == -signal.SIGKILL
    e = NativeEngine(path=d)
    for i in range(300):
        assert e.get(b"k%04d" % i, _ts(1000))[0] == b"v%04d" % i
    e.close()


def test_native_torn_wal_tail_truncated_not_fatal(tmp_path):
    d = str(tmp_path / "eng")
    e = NativeEngine(path=d)
    for i in range(20):
        e.put(b"k%04d" % i, _ts(i + 1), b"v%04d" % i)
    e.sync()
    e.close()
    tear_file(os.path.join(d, "wal.log"), 9)
    e2 = NativeEngine(path=d)
    st = e2.stats()
    assert st["wal_replayed"] == 19
    assert st["torn_bytes"] > 0
    assert st["crc_failures"] == 0
    assert e2.get(b"k0018", _ts(1000))[0] == b"v0018"
    assert e2.get(b"k0019", _ts(1000)) is None
    e2.close()
    e3 = NativeEngine(path=d)
    assert e3.stats()["torn_bytes"] == 0
    assert e3.stats()["wal_replayed"] == 19
    e3.close()


def test_native_corrupt_wal_byte_detected_by_crc(tmp_path):
    d = str(tmp_path / "eng")
    e = NativeEngine(path=d)
    for i in range(20):
        e.put(b"k%04d" % i, _ts(i + 1), b"v%04d" % i)
    e.sync()
    e.close()
    rec = 24 + 5 + 5
    corrupt_file(os.path.join(d, "wal.log"), 10 * rec + rec // 2)
    e2 = NativeEngine(path=d)
    st = e2.stats()
    assert st["crc_failures"] == 1
    assert st["wal_replayed"] == 10
    assert st["torn_bytes"] > 0
    assert e2.get(b"k0009", _ts(1000))[0] == b"v0009"
    assert e2.get(b"k0010", _ts(1000)) is None
    e2.close()


def test_native_and_python_fingerprints_agree(tmp_path):
    n = NativeEngine(path=str(tmp_path / "eng"))
    p = PyEngine()
    for e in (n, p):
        for i in range(50):
            e.put(encode_key(7, i % 17), _ts(i + 1),
                  b"v%d" % i if i % 5 else b"")
    assert engine_fingerprint(n) == engine_fingerprint(p)
    n.sync()
    n.close()
    n2 = NativeEngine(path=str(tmp_path / "eng"))
    assert engine_fingerprint(n2) == engine_fingerprint(p)
    assert (engine_fingerprint(n2, ts=_ts(25))
            == engine_fingerprint(p, ts=_ts(25)))
    n2.close()


# ------------------------------------------------- crash points (Python)


def test_crc32c_known_answer_and_record_format():
    from cockroach_tpu.storage.engine import pack_record as jpack

    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"6789", crc32c(b"12345")) == 0xE3069283
    assert pack_record(b"key", _ts(7, 3), b"val") == \
        jpack(b"key", _jts(7, 3), b"val")


def test_crash_point_fires_at_exact_count():
    fault.registry().arm_crash("wal.append", at=3)
    crash_point("wal.append")
    crash_point("wal.append")
    with pytest.raises(SimulatedCrash):
        crash_point("wal.append")
    crash_point("wal.append")
    assert fault.registry().crash_fires("wal.append") == 1


def test_simulated_crash_evades_except_exception():
    fault.registry().arm_crash("wal.sync", at=1)
    with pytest.raises(SimulatedCrash):
        try:
            crash_point("wal.sync")
        except Exception:  # noqa: BLE001 — the point of the test
            pytest.fail("SimulatedCrash caught by `except Exception`")


def test_unknown_crash_point_rejected():
    with pytest.raises(ValueError):
        fault.registry().arm_crash("no.such.seam", at=1)


def test_maybe_fail_after_and_probability():
    reg = fault.registry()
    reg.arm("scan.resident", after=2)
    fault.maybe_fail("scan.resident")
    fault.maybe_fail("scan.resident")
    with pytest.raises(fault.InjectedFault):
        fault.maybe_fail("scan.resident")
    fault.maybe_fail("scan.resident")  # once
    assert reg.fires("scan.resident") == 1
    reg.arm("scan.resident", probability=1.0)
    with pytest.raises(fault.InjectedFault):
        fault.maybe_fail("scan.resident")
    reg.disarm("scan.resident")
    fault.maybe_fail("scan.resident")
    # the points the port wires: the JAX package's, less those of the
    # modules the port does not have yet (tests/test_torch_lifecycle_
    # chaos.py checks each has its maybe_fail call)
    from cockroach_tpu.util.fault import KNOWN_POINTS as JAX_POINTS

    assert fault.KNOWN_POINTS == tuple(
        p for p in JAX_POINTS if p not in (
            "dist.a2a", "dtxn.before_resolve"))


def test_durable_file_torn_append(tmp_path):
    p = str(tmp_path / "wal")
    df = DurableFile(p, point="wal")
    df.append(b"AAAA")
    df.sync()
    fault.registry().arm_crash("wal.append", at=1, tear=2)
    with pytest.raises(SimulatedCrash):
        df.append(b"BBBB")
    with open(p, "rb") as f:
        assert f.read() == b"AAAABB"


def test_durable_file_lost_unsynced_tail(tmp_path):
    p = str(tmp_path / "wal")
    df = DurableFile(p, point="wal")
    df.append(b"AAAA")
    df.sync()
    df.append(b"BBBB")
    fault.registry().arm_crash("wal.sync", at=1, lose_unsynced=True)
    with pytest.raises(SimulatedCrash):
        df.sync()
    with open(p, "rb") as f:
        assert f.read() == b"AAAA"


def _fill(e, n, base=1):
    for i in range(n):
        e.put(encode_key(7, i), _ts(base + i), encode_row([i, i * 7]))
    e.sync()


def test_pyengine_reopen_replays_wal(tmp_path):
    d = str(tmp_path / "eng")
    e = PyEngine(path=d)
    _fill(e, 20)
    fp = engine_fingerprint(e)
    e.close()
    e2 = PyEngine(path=d)
    assert e2.stats()["wal_replayed"] == 20
    assert engine_fingerprint(e2) == fp
    assert e2.get(encode_key(7, 3), _ts(1000))[0] == encode_row([3, 21])
    e2.close()


def test_pyengine_torn_tail_truncated_not_fatal(tmp_path):
    d = str(tmp_path / "eng")
    e = PyEngine(path=d)
    _fill(e, 20)
    fp_19 = engine_fingerprint(e, ts=_ts(19))
    e.close()
    tear_file(os.path.join(d, "wal.log"), 9)
    e2 = PyEngine(path=d)
    st = e2.stats()
    assert st["wal_replayed"] == 19
    assert st["torn_bytes"] > 0
    assert st["crc_failures"] == 0
    assert engine_fingerprint(e2, ts=_ts(19)) == fp_19
    assert e2.get(encode_key(7, 19), _ts(1000)) is None
    e2.close()
    e3 = PyEngine(path=d)
    assert e3.stats()["torn_bytes"] == 0
    assert e3.stats()["wal_replayed"] == 19
    e3.close()


def test_pyengine_corrupt_byte_detected_by_crc(tmp_path):
    d = str(tmp_path / "eng")
    e = PyEngine(path=d)
    _fill(e, 20)
    rec = len(pack_record(encode_key(7, 0), _ts(1), encode_row([0, 0])))
    e.close()
    corrupt_file(os.path.join(d, "wal.log"), 10 * rec + rec // 2)
    e2 = PyEngine(path=d)
    st = e2.stats()
    assert st["crc_failures"] == 1
    assert st["wal_replayed"] == 10
    assert st["torn_bytes"] > 0
    assert e2.get(encode_key(7, 9), _ts(1000)) is not None
    assert e2.get(encode_key(7, 10), _ts(1000)) is None
    e2.close()


def test_pyengine_snapshot_plus_wal_recovery(tmp_path):
    d = str(tmp_path / "eng")
    e = PyEngine(path=d)
    _fill(e, 10)
    e.flush()
    for i in range(10, 15):
        e.put(encode_key(7, i), _ts(1 + i), encode_row([i, i * 7]))
    e.sync()
    fp = engine_fingerprint(e)
    e.close()
    e2 = PyEngine(path=d)
    assert e2.stats()["wal_replayed"] == 5
    assert engine_fingerprint(e2) == fp
    e2.close()


def test_pyengine_crash_at_flush_leaves_recoverable_state(tmp_path):
    d = str(tmp_path / "eng")
    e = PyEngine(path=d)
    _fill(e, 12)
    fp = engine_fingerprint(e)
    fault.registry().arm_crash("engine.flush", at=1)
    with pytest.raises(SimulatedCrash):
        e.flush()
    e.close()
    e2 = PyEngine(path=d)
    assert engine_fingerprint(e2) == fp
    e2.close()


def test_iter_records_reports_crc_failures():
    body = pack_record(b"k1", _ts(5), b"v1") + pack_record(
        b"k2", _ts(6), b"v2")
    assert [k for k, _, _, _ in iter_records(body)] == [b"k1", b"k2"]
    bad = bytearray(body)
    bad[len(body) // 2] ^= 0xFF
    stats = {"crc_failures": 0}
    kept = list(iter_records(bytes(bad), stats=stats))
    assert len(kept) < 2 and stats["crc_failures"] == 1


def test_store_fingerprint_bit_exact_and_sensitive(tmp_path):
    a = MVCCStore(engine=PyEngine(path=str(tmp_path / "a")),
                  clock=HLC(ManualClock(100)))
    b = MVCCStore(clock=HLC(ManualClock(100)))
    for st in (a, b):
        for i in range(30):
            st.put(7, i % 10, [i], ts=_ts(i + 1))
        st.delete(7, 3, ts=_ts(99))
    assert a.fingerprint(7) == b.fingerprint(7)
    assert a.fingerprint() == b.fingerprint()
    a.sync()
    a.engine.close()
    a2 = MVCCStore(engine=PyEngine(path=str(tmp_path / "a")),
                   clock=HLC(ManualClock(100)))
    assert a2.fingerprint(7) == b.fingerprint(7)
    b.put(7, 1, [777], ts=_ts(500))
    assert a2.fingerprint(7) != b.fingerprint(7)
    a2.engine.close()


# ------------------------------------- on-disk format shared with JAX


@pytest.mark.parametrize("kind", ENGINES)
def test_port_data_dir_opens_in_jax_package(tmp_path, kind):
    """A data directory the port's engine wrote (WAL, flushed runs or
    snapshot, tombstones, a bulk ingest) opens in the JAX package's
    engine of the same kind with an equal fingerprint."""
    from cockroach_tpu.storage.engine import \
        engine_fingerprint as jfingerprint

    d = str(tmp_path / "eng")
    e = _engine(kind, path=d)
    for i in range(40):
        e.put(encode_key(6, i % 13), _ts(i + 1),
              encode_row([i, -i]) if i % 7 else b"")
    e.flush()
    e.ingest(8, np.arange(20, dtype=np.int64),
             [np.arange(20, dtype=np.int64) * 5], _ts(100))
    for i in range(5):
        e.put(encode_key(6, 100 + i), _ts(200 + i), encode_row([i]))
    e.sync()
    fp = engine_fingerprint(e)
    fp_60 = engine_fingerprint(e, ts=_ts(60))
    e.close()
    j = _jax_engine(kind, path=d)
    assert jfingerprint(j) == fp
    assert jfingerprint(j, ts=_jts(60)) == fp_60
    assert _plain(j.export_span(b"", b"")) == _plain(
        _engine(kind, path=d).export_span(b"", b""))
    j.close()

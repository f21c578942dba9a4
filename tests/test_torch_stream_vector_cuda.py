"""The card's cases of the streaming and vector slice, held to the
port's own CPU results (this file imports no JAX, so it collects on a
machine without it): the view fold's int64 `index_add_` and
`scatter_reduce_` amin/amax on CUDA give the CPU's state bit for bit,
and batched vector search on CUDA equals per-query search bit for bit.
Each test skips without a card; `python -m pytest -m cuda
tests/test_torch_*.py` runs them on one."""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.ops import vector as tv
from cockroach_tpu_torch.ops import view_fold as tvf
from torch_threads import one_torch_thread  # noqa: F401

LANES = ("counts", "acnt", "asum", "amin", "amax")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_fold_sequence_bit_exact_on_cuda():
    _need_card()
    rng = np.random.default_rng(12)
    cs, gs = tvf.GroupState(3, "cpu"), tvf.GroupState(3, "cuda")
    for i, n in enumerate([1, 2, 63, 64, 65, 127, 128, 129, 300]):
        packed = rng.integers(-(2 + 4 * i), 2 + 4 * i, n).astype(np.int64)
        sign = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int64)
        hi = 2**62 if i % 2 else 1000
        vals = rng.integers(-hi, hi, (3, n)).astype(np.int64) * 3
        valid = rng.random((3, n)) < 0.85
        cs.fold(packed, sign, vals, valid)
        gs.fold(packed, sign, vals, valid)
        for name in LANES:
            assert torch.equal(getattr(cs, name),
                               getattr(gs, name).cpu()), name
    assert cs.counts_consistent() == gs.counts_consistent()


@pytest.mark.cuda
def test_batched_bit_identical_on_cuda():
    _need_card()
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 16)).astype(np.float32)
    vecs = (centers[rng.integers(0, 16, 2000)]
            + 0.1 * rng.normal(size=(2000, 16))).astype(np.float32)
    qs = (vecs[:9] + 0.01).astype(np.float32)
    for metric in ("l2", "cos"):
        ex = tv.ExactSearcher(vecs, metric, k=7, device="cuda")
        idx = tv.VectorIndex.build(vecs, metric, n_clusters=16,
                                   device="cuda")
        bids, bd = ex.search_batch(qs, batch_size=4)
        aids, ad = idx.search_batch(qs, k=7, nprobe=4, batch_size=4)
        for i, q in enumerate(qs):
            ids, d = ex.search(q)
            assert np.array_equal(bids[i], ids)
            assert np.array_equal(bd[i].view(np.int32), d.view(np.int32))
            ids, d = idx.search(q, k=7, nprobe=4)
            assert np.array_equal(aids[i], ids)
            assert np.array_equal(ad[i].view(np.int32), d.view(np.int32))

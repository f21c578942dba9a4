"""Near-data MVCC visibility: torch ops over device-resident versioned
columns.

Counterpart of cockroach_tpu/ops/mvcc_filter.py, bit for bit. The JAX
module is jnp, which XLA lowers (no Pallas kernel), so the port is torch
ops on the store's device; on a CPU tensor the same code runs on the
CPU. Reference: pkg/storage/col_mvcc.go (MVCCScanToCols walks versions on
the host); here the walk becomes two data-parallel passes over arrays
kept sorted by (pk, packed ts, seq):

  - `fold_versions`: merge a pow2-padded delta batch (incremental
    put/delete ingest, storage/resident.py) into the sorted base — one
    concatenate, a lexsort as three stable int64 sorts (seq, then ts,
    then pk) and the gathers, no host restacking;
  - `visible_image`: scan-at-timestamp. Versions visible at read ts T
    form a PREFIX of each pk's segment (ts ascending), so the newest
    visible version per pk — the reference's "seek to the max version
    <= read ts" — is the segment's last visible lane: an O(n)
    shift-compare instead of a segmented argmax. Tombstone winners drop,
    survivors compact to the front pk-ascending. torch has no scatter
    with XLA's mode="drop", so the compaction scatters into a cap + 1
    buffer whose last slot takes every dropped lane, then slices it off.

Sentinels: dead lanes carry pk = ts = seq = int64 max so they sort (and
stay) at the tail; real pks must stay below PK_SENTINEL (guarded at
attach). Dead lanes are identical (tomb False, values 0), so their order
among themselves cannot show.

Duplicate (pk, ts) versions — a put replayed at the same timestamp
replaces in the engines — are kept as distinct lanes ordered by append
seq; "last visible lane of the segment" then picks the replacement,
matching engine semantics bit-exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PK_SENTINEL = np.iinfo(np.int64).max
TS_SENTINEL = np.iinfo(np.int64).max


def pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def sentinel_arrays(cap: int, ncols: int) -> Tuple[np.ndarray, ...]:
    """Host-side empty (pk, ts, seq, tomb, vals) lane set of one pow2
    bucket — the shape contract both passes pad to."""
    return (np.full(cap, PK_SENTINEL, np.int64),
            np.full(cap, TS_SENTINEL, np.int64),
            np.full(cap, TS_SENTINEL, np.int64),
            np.zeros(cap, bool),
            np.zeros((ncols, cap), np.int64))


def _lexsort3(pk: torch.Tensor, ts: torch.Tensor,
              seq: torch.Tensor) -> torch.Tensor:
    """The permutation sorting lanes by (pk, ts, seq): stable sorts by
    the least significant key first."""
    order = torch.sort(seq, stable=True).indices
    order = order[torch.sort(ts[order], stable=True).indices]
    return order[torch.sort(pk[order], stable=True).indices]


def fold_versions(base, delta, out_cap: int):
    """Merge `delta` lanes into the sorted `base` lane set; both are
    (pk, ts, seq, tomb, vals) tuples of pow2-padded tensors on one
    device, and the result is re-padded/sliced to `out_cap` lanes (a
    pow2 the caller picked to hold every live lane)."""
    pk, ts, seq, tomb, vals = base
    dpk, dts, dseq, dtomb, dvals = delta
    mpk = torch.cat([pk, dpk])
    mts = torch.cat([ts, dts])
    mseq = torch.cat([seq, dseq])
    order = _lexsort3(mpk, mts, mseq)
    mpk, mts, mseq = mpk[order], mts[order], mseq[order]
    mtomb = torch.cat([tomb, dtomb])[order]
    mvals = torch.cat([vals, dvals], dim=1)[:, order]
    cur = int(mpk.shape[0])
    if out_cap < cur:
        # live lanes never exceed out_cap (caller contract); the tail
        # being sliced off is sentinel padding
        return (mpk[:out_cap], mts[:out_cap], mseq[:out_cap],
                mtomb[:out_cap], mvals[:, :out_cap])
    if out_cap > cur:
        pad = [torch.from_numpy(a).to(mpk.device)
               for a in sentinel_arrays(out_cap - cur, int(mvals.shape[0]))]
        return (torch.cat([mpk, pad[0]]), torch.cat([mts, pad[1]]),
                torch.cat([mseq, pad[2]]), torch.cat([mtomb, pad[3]]),
                torch.cat([mvals, pad[4]], dim=1))
    return mpk, mts, mseq, mtomb, mvals


def visible_image(pk, ts, tomb, vals, n: int, tread: int):
    """The rows visible at packed read timestamp `tread`: newest version
    <= tread per pk, tombstone winners masked, compacted to the front in
    pk order. Returns (pks, vals (C, cap), count) with sentinel-padded
    tails; only the first `count` lanes are rows. `count` is an int32
    0-d tensor on the device: reading it is the caller's sync."""
    cap = int(pk.shape[0])
    dev = pk.device
    lanes = torch.arange(cap, device=dev)
    vis = (lanes < n) & (ts <= tread)
    nxt_pk = torch.cat([pk[1:], torch.full((1,), PK_SENTINEL,
                                           dtype=pk.dtype, device=dev)])
    nxt_vis = torch.cat([vis[1:], torch.zeros(1, dtype=torch.bool,
                                              device=dev)])
    # visible versions are a prefix of each (ts-ascending) pk segment:
    # the winner is the last visible lane of its segment
    winner = vis & ~((nxt_pk == pk) & nxt_vis)
    live = winner & ~tomb
    pos = torch.cumsum(live, 0) - 1
    count = live.sum(dtype=torch.int32)
    idx = torch.where(live, pos, cap)  # slot cap takes the dropped lanes
    out_pk = torch.full((cap + 1,), PK_SENTINEL, dtype=pk.dtype, device=dev)
    out_pk[idx] = pk
    out_vals = torch.zeros((vals.shape[0], cap + 1), dtype=vals.dtype,
                           device=dev)
    out_vals[:, idx] = vals
    return out_pk[:cap], out_vals[:, :cap], count

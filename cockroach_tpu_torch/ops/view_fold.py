"""Incremental GROUP BY maintenance: device-resident group state and one
scatter fold per delta batch.

Counterpart of cockroach_tpu/ops/view_fold.py. The standing aggregate of
a materialized view (sql/matview.py) keeps its group state on the
device (counts, and per aggregate input a valid count, a sum, a min and
a max lane, all int64) and absorbs a write-delta batch with one fold:
`index_add_` for the counts and sums (sign +1 for an insert, -1 for a
retraction, so deletes and overwrites fold as a count-per-group
retraction) and `scatter_reduce_` "amin"/"amax" with `include_self` for
the monotone aggregates (inserts only; a retraction under MIN/MAX cannot
fold, and the caller degrades to a re-scan).

The delta is padded to a pow2 bucket (at least 64 lanes) as in the JAX
package; padding lanes carry index 0, sign 0 and `valid` False, so every
scatter is a no-op there. All arithmetic is exact int64, so the state is
bit for bit the JAX state (decimal columns stay scaled ints; AVG is
float32(sum) / float32(count) at read time, as ops/agg.py computes it).

Group identity is a packed int64 key (one column as it is; two columns
range-checked into 32 bits each). Slot resolution is a host
searchsorted over the sorted key vector (G is small); unseen keys grow
the state into the next pow2 capacity (`_grow`, an `index_copy_` of the
live slots).

Departure from the JAX module: `warm_fold` has no plan vault to compile
through (the vault is ROADMAP.md queue 1, item 8e). It runs one
all-padding fold at the state's shape instead, so the first real delta
pays no allocator warm-up; the state does not change.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cockroach_tpu_torch import resolve_device

I64_MAX = np.int64(2**63 - 1)
I64_MIN = np.int64(-(2**63))

# groups past this capacity refuse to fold (the device-memory refusal:
# the caller falls back to re-scan rather than growing state forever)
MAX_GROUPS = 1 << 20

_MIN_DELTA_BUCKET = 64


class FoldUnsupported(Exception):
    """This delta (or view shape) cannot be folded incrementally; the
    caller must refresh via full re-scan (which stays the oracle)."""


def pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def pack_keys(cols: List[np.ndarray]) -> np.ndarray:
    """Pack 1-2 int64 group-key columns into one int64 identity. Two
    columns must each fit in 32 bits (string dict codes, dates, small
    ints all do); out-of-range keys are a FoldUnsupported."""
    if len(cols) == 1:
        return np.asarray(cols[0], dtype=np.int64)
    if len(cols) != 2:
        raise FoldUnsupported(f"{len(cols)} group columns (max 2)")
    k0 = np.asarray(cols[0], dtype=np.int64)
    k1 = np.asarray(cols[1], dtype=np.int64)
    lim = np.int64(1) << 31
    if (k0.size and (np.abs(k0).max() >= lim or np.abs(k1).max() >= lim)):
        raise FoldUnsupported("group key exceeds 32-bit packing range")
    return (k0 << np.int64(32)) | (k1 & np.int64(0xFFFFFFFF))


def unpack_keys(packed: np.ndarray, n_cols: int) -> List[np.ndarray]:
    packed = np.asarray(packed, dtype=np.int64)
    if n_cols == 1:
        return [packed]
    hi = packed >> np.int64(32)
    lo = (packed & np.int64(0xFFFFFFFF)).astype(np.int64)
    # sign-extend the low half back to int64
    lo = np.where(lo >= (1 << 31), lo - (np.int64(1) << 32), lo)
    return [hi, lo]


def _fold_body(counts, acnt, asum, amin, amax, idx, sign, vals, valid):
    """One delta fold, in place. Shapes: counts (G,), acnt/asum/amin/amax
    (A, G), idx (D,) int64, sign (D,) int64, vals/valid (A, D). Padding
    lanes carry sign 0 and valid False, so every scatter is a no-op
    there."""
    counts.index_add_(0, idx, sign)
    w = sign[None, :] * valid.to(torch.int64)        # (A, D)
    acnt.index_add_(1, idx, w)
    asum.index_add_(1, idx, w * vals)
    live = (sign[None, :] > 0) & valid
    lanes = idx[None, :].expand_as(vals)
    amin.scatter_reduce_(1, lanes, torch.where(
        live, vals, torch.full_like(vals, int(I64_MAX))), "amin",
        include_self=True)
    amax.scatter_reduce_(1, lanes, torch.where(
        live, vals, torch.full_like(vals, int(I64_MIN))), "amax",
        include_self=True)


def warm_fold(state: "GroupState", dbucket: int) -> None:
    """Run one all-padding fold at the state's (A, Gcap, dbucket) shape
    so the first real delta finds its buffers allocated. The state does
    not change (every lane is padding). The JAX package compiles the
    fold here through its plan vault; the port has no vault."""
    A, dev = state.n_inputs, state.device
    z = torch.zeros(dbucket, dtype=torch.int64, device=dev)
    _fold_body(state.counts, state.acnt, state.asum, state.amin,
               state.amax, z, z,
               torch.zeros((A, dbucket), dtype=torch.int64, device=dev),
               torch.zeros((A, dbucket), dtype=torch.bool, device=dev))


def delta_bucket(n: int) -> int:
    return max(_MIN_DELTA_BUCKET, pow2_at_least(max(1, n)))


class GroupState:
    """Device-resident group aggregate state for one materialized view,
    on `device` (CUDA unless the caller passes one).

    `keys` is the sorted packed-group-key vector (host mirror; slot i of
    every device tensor belongs to keys[i]); dead groups (count 0 after
    retraction) stay allocated but are masked out of reads.
    """

    def __init__(self, n_inputs: int, device=None):
        self.device = resolve_device(device)
        self.n_inputs = int(n_inputs)
        self.keys = np.empty(0, dtype=np.int64)
        self.gcap = 1
        (self.counts, self.acnt, self.asum, self.amin,
         self.amax) = self._empty(self.gcap)
        self.folds = 0
        self.generation = 0

    def _empty(self, gcap: int):
        A, dev, i64 = self.n_inputs, self.device, torch.int64
        return (torch.zeros((gcap,), dtype=i64, device=dev),
                torch.zeros((A, gcap), dtype=i64, device=dev),
                torch.zeros((A, gcap), dtype=i64, device=dev),
                torch.full((A, gcap), int(I64_MAX), dtype=i64, device=dev),
                torch.full((A, gcap), int(I64_MIN), dtype=i64, device=dev))

    # ---------------------------------------------------------- capacity

    def nbytes(self) -> int:
        per = 8 * (1 + 4 * self.n_inputs)
        return int(self.gcap * per)

    def _grow(self, new_keys: np.ndarray) -> None:
        """Merge unseen packed keys into the sorted key vector and re-slot
        the device state into the next pow2 capacity. Rare path: it only
        fires when a delta introduces a new group."""
        merged = np.union1d(self.keys, new_keys)
        if len(merged) > MAX_GROUPS:
            raise FoldUnsupported(
                f"{len(merged)} groups exceeds MAX_GROUPS={MAX_GROUPS}")
        gcap = pow2_at_least(max(1, len(merged)))
        fresh = self._empty(gcap)
        G = len(self.keys)
        if G:
            pos = torch.from_numpy(
                np.searchsorted(merged, self.keys).astype(np.int64)
            ).to(self.device)
            old = (self.counts, self.acnt, self.asum, self.amin,
                   self.amax)
            fresh[0].index_copy_(0, pos, old[0][:G])
            for new, cur in zip(fresh[1:], old[1:]):
                new.index_copy_(1, pos, cur[:, :G])
        self.keys, self.gcap = merged, gcap
        (self.counts, self.acnt, self.asum, self.amin,
         self.amax) = fresh

    # -------------------------------------------------------------- fold

    def fold(self, packed: np.ndarray, sign: np.ndarray,
             vals: np.ndarray, valid: np.ndarray,
             allow_retraction_minmax: bool = False) -> None:
        """Fold one delta batch: packed (D,) group keys, sign (D,) in
        {+1,-1}, vals/valid (A, D) aggregate inputs. One fold after host
        slot resolution and pow2 padding."""
        packed = np.asarray(packed, dtype=np.int64)
        sign = np.asarray(sign, dtype=np.int64)
        D = len(packed)
        if D == 0:
            return
        vals = np.asarray(vals, dtype=np.int64).reshape(self.n_inputs, D)
        valid = np.asarray(valid, dtype=bool).reshape(self.n_inputs, D)
        fresh = np.setdiff1d(packed, self.keys)
        if len(fresh):
            self._grow(fresh)
        idx = np.searchsorted(self.keys, packed).astype(np.int64)
        bucket = delta_bucket(D)
        if bucket > D:
            pad = bucket - D
            idx = np.concatenate([idx, np.zeros(pad, np.int64)])
            sign = np.concatenate([sign, np.zeros(pad, np.int64)])
            vals = np.concatenate(
                [vals, np.zeros((self.n_inputs, pad), np.int64)], axis=1)
            valid = np.concatenate(
                [valid, np.zeros((self.n_inputs, pad), bool)], axis=1)
        dev = self.device
        _fold_body(self.counts, self.acnt, self.asum, self.amin,
                   self.amax, torch.from_numpy(idx).to(dev),
                   torch.from_numpy(sign).to(dev),
                   torch.from_numpy(vals).to(dev),
                   torch.from_numpy(valid).to(dev))
        self.folds += 1
        self.generation += 1

    def counts_consistent(self) -> bool:
        """True iff no group count (row or per-aggregate) is negative.
        A negative count means a retraction was folded for a row the
        state never absorbed: the state has diverged from the source
        and only the re-scan oracle can repair it."""
        G = len(self.keys)
        if G == 0:
            return True
        lo = self.counts[:G].min()
        if self.n_inputs:
            lo = torch.minimum(lo, self.acnt[:, :G].min())
        return bool(lo.item() >= 0)

    # -------------------------------------------------------------- read

    def read(self) -> Dict[str, np.ndarray]:
        """Host snapshot of the live groups, sorted by packed key:
        {'keys', 'counts', 'acnt', 'asum', 'amin', 'amax'}; dead
        (count 0) groups are dropped."""
        G = len(self.keys)
        counts = self.counts[:G].cpu().numpy()
        live = counts > 0

        def lanes(t):
            return t[:, :G].cpu().numpy()[:, live]

        return {
            "keys": self.keys[live],
            "counts": counts[live],
            "acnt": lanes(self.acnt),
            "asum": lanes(self.asum),
            "amin": lanes(self.amin),
            "amax": lanes(self.amax),
        }


def avg_f32(asum: np.ndarray, acnt: np.ndarray) -> np.ndarray:
    """AVG exactly as ops/agg.py computes it: the int64 sum cast to f32
    divided by the (floored-at-1) f32 count, not f64 then narrowed."""
    return (asum.astype(np.float32)
            / np.maximum(acnt, 1).astype(np.float32))

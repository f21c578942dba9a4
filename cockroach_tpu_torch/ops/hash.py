"""Vectorized hashing: splitmix64 over 64-bit lanes.

Counterpart of cockroach_tpu/ops/hash.py, bit for bit: the hashes set the
order of groups (ops/agg.py method="hash") and the join's hash keys, so
the port computes exactly the JAX package's uint64 values.

PyTorch has little uint64 support, so every lane is an int64 holding the
uint64 bit pattern: adds and multiplies wrap alike in both, and a logical
right shift is an arithmetic one with the sign-filled bits masked off
(`_srl`). The unsigned order of such lanes is the signed order of
`x ^ SIGN` (`unsigned_order`), which is how the sorts here and in
ops/agg.py, ops/join.py and ops/sortjoin.py order them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cockroach_tpu_torch.coldata.batch import Batch

_U64 = (1 << 64) - 1
SIGN = -(1 << 63)           # int64 with only bit 63 set
ALL_ONES = -1               # the uint64 0xFFFF_FFFF_FFFF_FFFF


def s64(u: int) -> int:
    """A uint64 given as a Python int -> the int64 with the same bits."""
    u &= _U64
    return u - (1 << 64) if u >> 63 else u


# splitmix64 constants as int64 bit patterns
_M1 = s64(0xBF58476D1CE4E5B9)
_M2 = s64(0x94D049BB133111EB)
_GOLDEN = s64(0x9E3779B97F4A7C15)
_NULL_SENTINEL = 0xA5A5A5A5


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def unsigned_order(x: torch.Tensor) -> torch.Tensor:
    """An int64 key whose signed order is the unsigned order of x."""
    return x ^ SIGN


def _seed_term(seed: int) -> int:
    return s64((seed & _U64) * (_GOLDEN & _U64) + (_GOLDEN & _U64))


def hash64(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """splitmix64 finalizer over int64 lanes (uint64 bits). -> int64."""
    h = x.to(torch.int64) + _seed_term(seed)
    h = (h ^ _srl(h, 30)) * _M1
    h = (h ^ _srl(h, 27)) * _M2
    return h ^ _srl(h, 31)


def _hash64_scalar(x: int, seed: int = 0) -> int:
    """hash64 of one value, in Python integers (an int64 bit pattern)."""
    h = (x + (_seed_term(seed) & _U64)) & _U64
    h = ((h ^ (h >> 30)) * (_M1 & _U64)) & _U64
    h = ((h ^ (h >> 27)) * (_M2 & _U64)) & _U64
    return s64(h ^ (h >> 31))


def flush_subnormal(v: torch.Tensor) -> torch.Tensor:
    """Float lanes with subnormal values (and -0.0) as 0.0. The JAX
    package's compiled programs flush subnormals to zero, so there a
    subnormal key equals 0.0 in hashing and in key comparisons alike."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(v.abs() < tiny,
                       torch.zeros((), dtype=v.dtype, device=v.device), v)


def _to_u64(values: torch.Tensor) -> torch.Tensor:
    """Reinterpret any column dtype as 64-bit lanes for hashing: bools as
    0/1, floats as their float32 bits (-0.0 and subnormals folded to 0.0,
    every NaN to one NaN), zero-extended; integers sign-extended."""
    dt = values.dtype
    if dt == torch.bool:
        return values.to(torch.int64)
    if dt.is_floating_point:
        v = flush_subnormal(values)
        v = torch.where(torch.isnan(v), torch.full((), float("nan"),
                                                   dtype=dt,
                                                   device=values.device), v)
        bits = v.to(torch.float32).view(torch.int32)
        return bits.to(torch.int64) & 0xFFFFFFFF
    if dt.is_complex:
        raise TypeError(f"unhashable column dtype {dt}")
    return values.to(torch.int64)


def hash_column(values: torch.Tensor, validity: Optional[torch.Tensor] = None,
                seed: int = 0) -> torch.Tensor:
    """Hash one column. NULLs hash to a fixed sentinel."""
    h = hash64(_to_u64(values), seed)
    if validity is not None:
        h = torch.where(validity, h, _hash64_scalar(_NULL_SENTINEL, seed))
    return h


def combine(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Order-dependent hash combine (boost-style)."""
    return h1 ^ (h2 + _GOLDEN + (h1 << 6) + _srl(h1, 2))


def hash_columns(batch: Batch, names: Sequence[str], seed: int = 0,
                 sel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Combined hash of several columns of a batch ((cap,) int64 holding
    uint64 bits). Column i hashes with seed + i; deselected lanes hash
    to 0."""
    h = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
    for i, n in enumerate(names):
        c = batch.col(n)
        h = combine(h, hash_column(c.values, c.validity, seed=seed + i))
    mask = batch.sel if sel_mask is None else (batch.sel & sel_mask)
    return torch.where(mask, h, 0)

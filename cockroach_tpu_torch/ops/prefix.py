"""Prefix scans.

Counterpart of cockroach_tpu/ops/prefix.py. The JAX package splits long
scans into blocks because the TPU's compiler runs out of vector memory on
a flat multi-million-lane scan; torch.cumsum has no such limit, so
blocked_cumsum is a plain cumsum that keeps the input's dtype, and
blocked_assoc_scan is a log-step (Hillis-Steele) scan of elementwise ops.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1-D cumsum in x's dtype (bools count in int64), as
    jnp.cumsum computes it, wrapping on overflow."""
    dt = torch.int64 if x.dtype == torch.bool else x.dtype
    return torch.cumsum(x, 0, dtype=dt)


def blocked_assoc_scan(combine: Callable, xs: Tuple[torch.Tensor, ...]
                       ) -> Tuple[torch.Tensor, ...]:
    """Inclusive 1-D scan of a tuple of tensors under an associative,
    elementwise `combine(a, b)` (a the earlier lanes): ceil(log2 n)
    rounds, each combining every lane with the one `d` before it."""
    xs = tuple(xs)
    n = xs[0].shape[0]
    d = 1
    while d < n:
        earlier = tuple(x[:-d] for x in xs)
        later = tuple(x[d:] for x in xs)
        merged = combine(earlier, later)
        xs = tuple(torch.cat([x[:d], m]) for x, m in zip(xs, merged))
        d *= 2
    return xs

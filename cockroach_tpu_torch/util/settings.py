"""Typed settings registry.

A copy of cockroach_tpu/util/settings.py, cut to the settings the port
reads: a typed, named registry of process-wide settings with environment
overrides (COCKROACH_TPU_<NAME>).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


_UNRESOLVED = object()  # sentinel: env override not yet looked up


@dataclass
class _Setting:
    name: str
    default: Any
    description: str
    validate: Optional[Callable[[Any], None]] = None
    # default after the one-time env-override lookup
    resolved: Any = _UNRESOLVED


class Settings:
    """A typed settings registry with env-var overrides (COCKROACH_TPU_*).

    Values are process-global by default: every `Settings()` handle
    reads/writes one shared store, so a `set()` is visible to operators
    constructed afterwards. Pass `isolated=True` for a private store.
    """

    _registry: Dict[str, _Setting] = {}
    _shared_values: Dict[str, Any] = {}

    def __init__(self, isolated: bool = False):
        self._values: Dict[str, Any] = {} if isolated else Settings._shared_values

    @classmethod
    def register(
        cls,
        name: str,
        default: Any,
        description: str = "",
        validate: Optional[Callable[[Any], None]] = None,
    ) -> str:
        if name in cls._registry:
            raise ValueError(f"setting {name!r} registered twice")
        cls._registry[name] = _Setting(name, default, description, validate)
        return name

    def get(self, name: str) -> Any:
        vals = self._values
        if name in vals:
            return vals[name]
        reg = self._registry[name]
        if reg.resolved is not _UNRESOLVED:
            return reg.resolved
        env = "COCKROACH_TPU_" + name.upper().replace(".", "_")
        if env in os.environ:
            raw = os.environ[env]
            d = reg.default
            try:
                if isinstance(d, bool):
                    val = raw.lower() in ("1", "true", "yes", "on")
                elif isinstance(d, int):
                    val = int(raw)
                elif isinstance(d, float):
                    val = float(raw)
                else:
                    val = raw
            except ValueError as e:
                raise ValueError(f"invalid value for setting {name!r} "
                                 f"from ${env}: {raw!r}") from e
            if reg.validate is not None:
                reg.validate(val)
            reg.resolved = val
            return val
        reg.resolved = reg.default
        return reg.default

    def set(self, name: str, value: Any) -> None:
        reg = self._registry.get(name)
        if reg is None:
            raise KeyError(f"unknown setting {name!r}")
        if reg.validate is not None:
            reg.validate(value)
        self._values[name] = value

    @classmethod
    def all(cls) -> Dict[str, _Setting]:
        return dict(cls._registry)


def _one_of(*allowed):
    def check(v):
        if v not in allowed:
            raise ValueError(f"bad value {v!r}; expected one of {allowed}")
    return check


WORKMEM = Settings.register(
    "sql.distsql.temp_storage.workmem",
    512 << 20,
    "per-operator memory budget before spilling",
)
DEFAULT_BATCH_SIZE = Settings.register(
    "sql.tpu.batch_size",
    1 << 16,
    "rows per device batch",
)
# Counterpart of sql.tpu.pallas. auto: a CUDA tensor goes through the
# hand-written CUDA kernel and a CPU tensor through its plain version;
# off: every dense aggregate takes the broadcast path.
KERNELS = Settings.register(
    "sql.gpu.kernels",
    "auto",
    "CUDA kernel mode: auto | off",
    validate=_one_of("auto", "off"),
)

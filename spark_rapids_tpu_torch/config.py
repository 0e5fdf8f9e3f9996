"""Typed configuration — port of ``spark_rapids_tpu/config.py``.

Only the keys this package reads are registered. Keys keep the
reference's names, so a conf dict written for the JAX session means the
same here; an unknown ``spark.rapids.*`` key raises, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, "ConfEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[str], Any]

    def get(self, conf: Dict[str, Any]) -> Any:
        if self.key in conf:
            v = conf[self.key]
            return self.conv(v) if isinstance(v, str) else v
        return self.default


def _register(key: str, default, doc: str, conv) -> ConfEntry:
    if key in _REGISTRY:
        raise ValueError(f"duplicate conf key {key}")
    e = ConfEntry(key, default, doc, conv)
    _REGISTRY[key] = e
    return e


def conf_int(key: str, default: int, doc: str) -> ConfEntry:
    return _register(key, default, doc, int)


TOPK_THRESHOLD = conf_int(
    "spark.rapids.tpu.sort.topKThreshold", 16384,
    "ORDER BY ... LIMIT n with n at or below this runs as the top-k exec "
    "instead of a global sort. 0 disables limit-into-sort.")


class TorchConf:
    """Immutable snapshot of a conf dict with typed access."""

    def __init__(self, conf: Optional[Dict[str, Any]] = None):
        self._conf = dict(conf or {})
        for k in self._conf:
            if k.startswith("spark.rapids.") and k not in _REGISTRY:
                raise KeyError(f"unknown rapids conf key: {k}")

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self._conf)

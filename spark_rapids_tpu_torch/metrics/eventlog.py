"""Structured query-event log — port of
``spark_rapids_tpu/metrics/eventlog.py``: one JSON line per executed query.

A :class:`~.profile.QueryProfile` (operator tree + metrics + engine
counters) appends as one line to ``query_profiles.jsonl`` under
``spark.rapids.tpu.metrics.eventLog.dir``. The format is the
reference's, line for line, so either package reads the other's log.
Append is crash-safe: each record is a single ``write()`` of one full
line, failures never fail the query, and the reader skips torn or
corrupt lines (a crash mid-append loses at most the last line).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from ..utils import lockdep

FILENAME = "query_profiles.jsonl"


class EventLog:
    """Append-only JSON-lines writer for query profiles.

    ``max_bytes`` (``spark.rapids.tpu.metrics.eventLog.maxBytes``) caps
    growth in a long-lived serving process: an append that would push
    the file past the cap first rotates it to ``<name>.1`` via
    ``os.replace`` — atomic, so a crash mid-rotation leaves either the
    old or the new generation intact, never a torn hybrid — and keeps
    exactly one prior generation. Torn-line tolerance is unchanged: both
    generations are read with the same skip-corrupt-lines reader."""

    def __init__(self, directory: str, max_bytes: int = 0):
        self.dir = directory
        self.path = os.path.join(directory, FILENAME)
        self.max_bytes = int(max_bytes)
        self._lock = lockdep.lock("EventLog._lock", io_ok=True)

    def _rotate_if_needed(self, incoming: int) -> None:
        """Rotate under the lock when the NEXT append would cross the
        cap (a single record larger than the cap still appends — the
        cap bounds the file, not the record)."""
        if self.max_bytes <= 0:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size > 0 and size + incoming > self.max_bytes:
            os.replace(self.path, self.path + ".1")

    def append(self, profile) -> bool:
        """Append one profile (QueryProfile or plain dict); returns False
        (and logs nothing) on any IO failure — the event log is an
        observability aid, never a correctness dependency."""
        record = profile if isinstance(profile, dict) else profile.to_dict()
        try:
            payload = (json.dumps(record, separators=(",", ":"),
                                  default=_jsonable) + "\n").encode("utf-8")
        except (TypeError, ValueError):
            return False
        with self._lock:
            try:
                os.makedirs(self.dir, exist_ok=True)
                self._rotate_if_needed(len(payload))
                # A previous writer may have crashed mid-append, leaving a
                # torn line with no trailing newline; start this record on
                # a fresh line so the torn one stays isolated (and skipped
                # by read()) instead of corrupting ours too.
                needs_nl = False
                try:
                    if os.path.getsize(self.path) > 0:
                        with open(self.path, "rb") as r:
                            r.seek(-1, os.SEEK_END)
                            needs_nl = r.read(1) != b"\n"
                except OSError:
                    pass
                with open(self.path, "ab") as f:
                    f.write((b"\n" if needs_nl else b"")
                            + payload)  # one write per record
                    f.flush()
            except OSError:
                return False
        return True


def _jsonable(v):
    """numpy scalars and other numerics that reach a profile dict."""
    if hasattr(v, "item"):
        return v.item()
    return str(v)


def read(path: str) -> List[dict]:
    """Load every intact profile line; torn or corrupt lines are skipped
    (crash-safety contract: a partial trailing line must not poison the
    log)."""
    out: List[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return []
    return out


def read_all(directory: str) -> List[dict]:
    """Every intact profile across the rotated generation (``.1``, older)
    and the current file, in append order."""
    path = os.path.join(directory, FILENAME)
    return read(path + ".1") + read(path)


def log_path(directory: Optional[str]) -> Optional[str]:
    return os.path.join(directory, FILENAME) if directory else None

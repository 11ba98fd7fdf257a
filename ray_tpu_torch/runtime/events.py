"""Structured event log + timeline (observability floor).

Reference parity: upstream emits structured per-component logs under the
session's ``logs/`` dir and records task lifecycle events that
``ray.timeline()`` exports as a Chrome trace (``src/ray/util/event.cc``,
``python/ray/_private/state.py::timeline`` — SURVEY.md §1 layer 12,
§5.5; mount empty).

One process-local sink serves both: ``emit()`` appends a JSON line to
``<log_dir>/events.jsonl`` (structured logs) and keeps a bounded
in-memory ring of timeline spans that exports in Chrome
``chrome://tracing`` format.  Gated by ``event_log_enabled``; the file
sink lazily creates ``log_dir`` (config, else ``<session>/logs``).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque

from ..common.config import get_config
from ..common import clock as _clk

_RING = 65536           # bounded timeline memory (spans)


class EventLog:
    def __init__(self, session_dir: str):
        cfg = get_config()
        self.enabled = cfg.event_log_enabled
        self._dir = cfg.log_dir or os.path.join(session_dir, "logs")
        self._lock = threading.Lock()
        self._file = None
        self._ring: deque = deque(maxlen=_RING)
        self.num_events = 0

    # -- structured log ------------------------------------------------------
    def emit(self, category: str, name: str, **fields) -> None:
        """Append one structured event (JSON line) and record it in the
        timeline ring.  No-op when ``event_log_enabled`` is false."""
        if not self.enabled:
            return
        ev = {"ts": _clk.now(), "category": category, "name": name,
              **fields}
        with self._lock:
            self.num_events += 1
            self._ring.append(ev)
            try:
                if self._file is None:
                    os.makedirs(self._dir, exist_ok=True)
                    self._file = open(
                        os.path.join(self._dir, "events.jsonl"), "a",
                        buffering=1)
                self._file.write(json.dumps(ev) + "\n")
            except OSError:
                self._file = None       # disk trouble: keep the ring only

    def span(self, category: str, name: str, start: float, end: float,
             node_row: int, **fields) -> None:
        """Record a completed duration span (timeline 'X' event)."""
        if not self.enabled:
            return
        ev = {"ts": start, "dur": end - start, "category": category,
              "name": name, "node_row": node_row, **fields}
        with self._lock:
            self.num_events += 1
            self._ring.append(ev)

    # -- timeline export -----------------------------------------------------
    def timeline(self) -> list[dict]:
        """Chrome-trace events (``chrome://tracing`` / Perfetto load this
        directly, like the reference's ``ray.timeline()``)."""
        with self._lock:
            events = list(self._ring)
        out = []
        for ev in events:
            base = {
                "name": ev["name"],
                "cat": ev["category"],
                "pid": ev.get("node_row", 0),
                "tid": ev.get("worker", 0),
                "ts": ev["ts"] * 1e6,           # chrome wants microseconds
                "args": {k: v for k, v in ev.items()
                         if k not in ("ts", "dur", "category", "name")},
            }
            if "dur" in ev:
                base["ph"] = "X"
                base["dur"] = ev["dur"] * 1e6
            else:
                base["ph"] = "i"                # instant
                base["s"] = "g"
            out.append(base)
        return out

    def dump_timeline(self, filename: str) -> str:
        with open(filename, "w") as f:
            json.dump(self.timeline(), f)
        return filename

    def close(self) -> None:
        with self._lock:
            self.enabled = False    # a late emit must not recreate the
            #                         log dir inside a deleted session
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def stats(self) -> dict:
        with self._lock:
            return {"num_events": self.num_events,
                    "ring_size": len(self._ring),
                    "log_dir": self._dir}

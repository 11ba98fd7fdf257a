"""The budget board: the beat -> grantor seam of the closed dispatch loop.

The fused scheduling beat prices per-(class, node) lease budgets on
device (``ops.hybrid_kernel.fused_beat`` / ``ShardPlane.fused_beat``)
and the raylet's delta engine lands them host-side in the beat's single
readback (``DeltaScheduler.last_budgets``).  The head's ``AgentHub``,
which sizes ``LeaseGrantor.grant`` calls, runs in the same process as a
raylet in every colocated deployment (and always in the sim) — so the
seam between them is a process-wide board, not an RPC:

    beat (device) -> packed readback -> raylet publishes rows here
                                   -> AgentHub.sync looks up (class, row)
                                   -> grantor.grant(node, class, budget)
                                   -> raylet LocalLeaseCache admits

Rows are keyed by the lease class-key string (the sorted
``name:count`` join of ``runtime.node_agent._lease_class_key``) and
indexed by CRM row — both sides of the seam already speak those
coordinates.  When the head is NOT colocated with a beat-running raylet
the board simply never fills and ``AgentHub`` falls back to the host
heuristic (the ``lease_budget_source`` knob's documented fallback).

Thread safety: the raylet's scheduler loop publishes while head RPC
threads read; everything is behind one lock and ``publish`` replaces
the whole row map atomically (readers never see a half-written beat).
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["BudgetBoard", "budget_board"]


class BudgetBoard:
    """Process-wide (class-key -> per-CRM-row budget vector) board."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seq = 0
        self._rows: dict[str, np.ndarray] = {}
        self.publishes = 0
        self.hits = 0
        self.misses = 0

    def publish(self, seq: int, rows: dict[str, np.ndarray]) -> None:
        """Replace the board with one beat's budget rows.

        ``seq`` is the publishing engine's beat sequence; the board
        keeps the max seen (several engines may publish — last beat
        wins, which is correct because every beat prices ALL resident
        classes from the full mirror).
        """
        with self._lock:
            self._seq = max(self._seq, int(seq))
            self._rows = dict(rows)
            self.publishes += 1

    def budget_for(self, class_key: str, row: int) -> int | None:
        """Beat-emitted budget for one (lease class, CRM row), or None
        when the board has no opinion (class not resident on the beat,
        row out of the beat's range, or no beat has published)."""
        with self._lock:
            vec = self._rows.get(class_key)
            if vec is None or not 0 <= int(row) < len(vec):
                self.misses += 1
                return None
            self.hits += 1
            return int(vec[int(row)])

    def seq(self) -> int:
        with self._lock:
            return self._seq

    def clear(self) -> None:
        """Drop all rows and counters (test isolation)."""
        with self._lock:
            self._seq = 0
            self._rows = {}
            self.publishes = self.hits = self.misses = 0

    def stats(self) -> dict:
        with self._lock:
            return {"budget_board_seq": self._seq,
                    "budget_board_classes": len(self._rows),
                    "budget_board_publishes": self.publishes,
                    "budget_board_hits": self.hits,
                    "budget_board_misses": self.misses}


_BOARD = BudgetBoard()


def budget_board() -> BudgetBoard:
    """The process singleton (head and raylet sides share it)."""
    return _BOARD

"""The lease plane: decentralized steady-state dispatch.

Upstream Ray moves steady-state scheduling off the GCS with a two-level
core-worker -> raylet lease scheme (SURVEY.md §1): a raylet holding a
lease for a resource class grants repeat submissions locally, and only
misses travel to the head.  This package is that scheme's kernel,
shared by the live runtime (``runtime/node_agent.py`` +
``runtime/head.py``) and the simulator (``sim/cluster.py``):

- :class:`LeaseGrantor` — head-side single source of truth: carves
  bounded, **epoch-stamped** per-class budgets out of CRM availability,
  routes repeat-class submissions to nodes already holding a lease, and
  **revokes by epoch bump** when a node goes quiet, drains, or dies.
- :class:`LocalLeaseCache` — raylet-side grant authority: admits tasks
  against the leased budgets without touching the head, spills misses
  and conflicts back, and **self-fences** when head contact is lost for
  the death-declaration horizon (so a revoked epoch can never race a
  fresh local grant past the grace window).
- :class:`BudgetBoard` — the beat -> grantor seam: the scheduling
  beat's device-priced per-(class, node) budgets, published by the
  raylet's delta engine and read by the head when sizing grants
  (``lease_budget_source = "beat"``).

Both sides are pure state machines over injected timestamps — no clock
reads, no transport — which is what lets the simulator drive them at
10k nodes under chaos and the live agents reuse them verbatim.

Process-wide stats registry: components register a callable returning
their counters; ``/metrics``, the dashboard and ``ray_tpu_torch status``
aggregate whatever is live in this process.
"""

from __future__ import annotations

import threading

from .board import BudgetBoard, budget_board
from .grantor import LeaseGrantor
from .local import LocalLeaseCache

__all__ = ["BudgetBoard", "LeaseGrantor", "LocalLeaseCache",
           "budget_board", "register_stats", "unregister_stats",
           "aggregate_stats"]

_STATS_LOCK = threading.Lock()
_STATS_SOURCES: dict[str, object] = {}

_COUNTER_KEYS = ("leases_granted_local", "spillbacks",
                 "lease_revocations", "leases_issued",
                 "lease_epoch_discards", "submit_batches",
                 "submit_batched_frames")


def register_stats(name: str, fn) -> None:
    """Register a zero-arg callable returning a lease-stats dict."""
    with _STATS_LOCK:
        _STATS_SOURCES[name] = fn


def unregister_stats(name: str) -> None:
    with _STATS_LOCK:
        _STATS_SOURCES.pop(name, None)


def aggregate_stats() -> dict:
    """Fold every registered source's counters into one dict (the
    ``/metrics`` + ``/api/leases`` + ``ray_tpu_torch status`` surface)."""
    with _STATS_LOCK:
        sources = list(_STATS_SOURCES.items())
    agg: dict = {k: 0 for k in _COUNTER_KEYS}
    agg["sources"] = {}
    for name, fn in sources:
        try:
            s = dict(fn())
        except Exception:   # noqa: BLE001 — a dying source never
            continue        # breaks the scrape
        agg["sources"][name] = s
        for k in _COUNTER_KEYS:
            if isinstance(s.get(k), (int, float)):
                agg[k] += s[k]
    hits, misses = agg["leases_granted_local"], agg["spillbacks"]
    agg["lease_hit_rate"] = round(hits / (hits + misses), 4) \
        if hits + misses else 0.0
    return agg

"""Model-version plane: zero-downtime rolling weight hot-swap.

A deployment's weights are versioned (``v1``, ``v2``, ...) in a
:class:`VersionRegistry` journaled into the GCS-snapshotted KV — the
version table survives head restarts AND standby promotion for free,
because promotion restores the same KV snapshot.  A
:class:`RolloutController` rolls a new version across a live replica
set with zero accepted-request loss:

    STAGING -> BROADCASTING -> FLIPPING -> SEALED | ROLLED_BACK

The new artifact streams 1->N down the bandwidth-derated broadcast
tree (``broadcast/manager.py``) while routers keep serving the old
version; replicas then flip atomically one-at-a-time — each flip pulls
the replica out of routing, drains its in-flight requests behind the
``max_ongoing_requests`` cap, reloads, probes, and re-enters.  Session
-sticky rendezvous routing pins live sessions to a consistent version
until they end.  A failed rollout (replica death mid-broadcast,
verification-probe failure, or an SLO-regression trip on the
per-deployment p99 EWMA) rolls back by re-flipping already-flipped
replicas to the retained old version.

The simulator twin (``sim/rollout.py``) models the same state machine
on the virtual clock; the ``serve_rolling_update`` campaign drives it
under chaos with three dedicated invariants (mixed-version sessions,
rollout termination, old-version retention).
"""

from .phases import (BROADCASTING, FLIPPING, ROLLED_BACK, SEALED,
                     STAGING, TERMINAL)
from .registry import VersionRegistry
from .rollout import (RolloutController, abort_rollout, pause_rollout,
                      resume_rollout, rollout, rollout_status)

__all__ = [
    "STAGING", "BROADCASTING", "FLIPPING", "SEALED", "ROLLED_BACK",
    "TERMINAL", "VersionRegistry", "RolloutController", "rollout",
    "rollout_status", "pause_rollout", "resume_rollout",
    "abort_rollout",
]

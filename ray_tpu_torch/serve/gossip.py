"""Gossiped per-replica load digests for the sharded serve router.

With one router per deployment the per-replica inflight map was
a single coherent dict.  Sharding the router per-ingress
(``serve_router_shards``) splits that view: each shard only *observes*
its own dispatches.  Instead of re-centralizing behind a lock — the
bottleneck sharding exists to remove — shards exchange **load
digests**: each shard's ``{replica_key: inflight}`` map is folded into
a per-deployment board at most every ``serve_gossip_interval_s``, and
a shard routes power-of-two-choices on

    own live count  +  (folded total − own count at fold time)

i.e. its *exact* local contribution plus a bounded-stale view of every
peer shard's.  Folds piggyback on the health manager's probe round
(``runtime/health.py``), the same beat that already carries node
liveness — no new RPC — and happen opportunistically at submit time
when the board is older than the gossip interval.  The distributed
form of the same protocol (digests riding node heartbeats to the head)
runs at 1k nodes in the simulator (``sim/serve.py``).

Staleness vs. caps: a stale digest can *under*-count a replica and let
two shards both dispatch to its last free slot.  That cannot
oversubscribe execution — replicas are threaded actors whose
``max_concurrency`` IS ``max_ongoing_requests``, so the excess call
queues in the replica mailbox instead of running, shows up in the next
digest, and p2c steers away.  Staleness degrades placement quality,
never the cap.

The board also fixes the unbounded per-replica growth bug: every fold
evicts digest entries whose replica left the controller's membership
(scale-down, death, loan reclaim), and ``evict()`` drops a
deployment's whole board entry at teardown.
"""

from __future__ import annotations

import threading

from ..common import clock as _clk
from ..common import locksets

__all__ = ["LoadBoard", "board", "fold_all"]


class _Folded:
    """One deployment's folded digest: the per-replica totals plus each
    shard's contribution at fold time (so a shard can subtract itself
    back out and never double-count its own live dispatches)."""

    __slots__ = ("t", "total", "per_shard", "versions")

    def __init__(self, t: float, total: dict, per_shard: dict,
                 versions: dict | None = None):
        self.t = t
        self.total = total          # replica_key -> summed inflight
        self.per_shard = per_shard  # shard_id -> {replica_key: inflight}
        self.versions = versions or {}  # replica_key -> model version


@locksets.track("folds", "evicted_replicas")
class LoadBoard:
    """Process-local gossip board, one entry per deployment (keyed by
    the controller's KV base).  A leaf lock: callers snapshot shard
    state first, then publish — the board never calls back out."""

    def __init__(self):
        self._lock = threading.Lock()
        self._folded: dict[str, _Folded] = {}
        self.folds = 0
        self.evicted_replicas = 0

    # -- publish -------------------------------------------------------------
    def fold(self, base: str, shard_digests: dict[int, dict[bytes, int]],
             live: set[bytes],
             versions: dict[bytes, str] | None = None) -> None:
        """Merge the shards' digest maps for one deployment.  Entries
        for replicas outside ``live`` (the controller's current
        membership) are evicted — dead, downscaled, and reclaimed
        replicas must not haunt the load view (or grow it forever).
        ``versions`` tags each live replica with its model version so
        digest readers (metrics, status) can see rollout progress
        without an extra controller RPC."""
        total: dict[bytes, int] = {}
        per_shard: dict[int, dict[bytes, int]] = {}
        dropped = 0
        for sid, digest in shard_digests.items():
            kept: dict[bytes, int] = {}
            for key, n in digest.items():
                if key not in live:
                    dropped += 1
                    continue
                kept[key] = n
                total[key] = total.get(key, 0) + n
            per_shard[sid] = kept
        ver = {k: v for k, v in (versions or {}).items() if k in live}
        with self._lock:
            self._folded[base] = _Folded(_clk.monotonic(), total,
                                         per_shard, ver)
            self.folds += 1
            self.evicted_replicas += dropped

    def evict(self, base: str) -> None:
        with self._lock:
            self._folded.pop(base, None)

    # -- read ----------------------------------------------------------------
    def age(self, base: str) -> float:
        with self._lock:
            f = self._folded.get(base)
        if f is None:
            return float("inf")
        return _clk.monotonic() - f.t

    def remote_load(self, base: str, shard_id: int, key: bytes) -> int:
        """Peer shards' folded inflight count for one replica: the
        total minus the asking shard's own contribution at fold time
        (its live count is added back by the caller)."""
        with self._lock:
            f = self._folded.get(base)
            if f is None:
                return 0
            own = f.per_shard.get(shard_id, {}).get(key, 0)
            return max(f.total.get(key, 0) - own, 0)

    def digest_size(self, base: str) -> int:
        with self._lock:
            f = self._folded.get(base)
            return len(f.total) if f is not None else 0

    def version_counts(self, base: str) -> dict[str, int]:
        """Replicas per model version in the folded digest — the
        gossip-eye view of rollout progress."""
        with self._lock:
            f = self._folded.get(base)
            if f is None:
                return {}
            out: dict[str, int] = {}
            for v in f.versions.values():
                out[v] = out.get(v, 0) + 1
            return out

    def stats(self) -> dict:
        with self._lock:
            ages = [_clk.monotonic() - f.t
                    for f in self._folded.values()]
            return {
                "deployments": len(self._folded),
                "folds": self.folds,
                "evicted_replicas": self.evicted_replicas,
                "max_age_s": round(max(ages), 4) if ages else 0.0,
            }


board = LoadBoard()


def fold_all() -> int:
    """Fold every router group in this process — the health manager's
    probe round calls this (gossip piggybacks on the liveness beat).
    Returns the number of deployments folded."""
    # serve's router is not ported yet (ROADMAP.md A.16): no router
    # group exists in this process, so there is nothing to fold
    return 0

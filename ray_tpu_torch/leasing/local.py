"""Raylet-side lease cache: the local grant authority.

A node holds one epoch-stamped snapshot of per-class budgets leased to
it by the head.  ``try_grant`` admits a task entirely locally — no head
RPC — when the snapshot covers its class with headroom; everything else
is a spillback (the caller ships the task to the head, which remains
the single source of truth).

Fencing is the safety half of revocation: once the node has gone
``fence_after_s`` without a *confirmed* head contact (the same horizon
after which the head declares it dead and revokes its epoch), the cache
refuses every grant.  Because a node's last confirmed contact is never
later than the head's last observed heartbeat, the node always fences
at or before the moment the head revokes — a grant under a revoked
epoch can only start inside the revocation grace window, never after
it.  The simulator's ``no double-executed lease`` invariant checks
exactly this.

Pure state machine: timestamps are injected, so the simulator drives it
on virtual time and the agents on the monotonic clock seam.
"""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["LocalLeaseCache"]


class LocalLeaseCache:
    """Per-node lease snapshot + admission counters."""

    def __init__(self, capacity: int, fence_after_s: float,
                 overcommit: float = 2.0, max_classes: int = 64):
        self.capacity = max(1, int(capacity))
        self.fence_after_s = float(fence_after_s)
        self.overcommit = float(overcommit)
        self.max_classes = max(1, int(max_classes))
        self.epoch = 0
        # class_key -> [budget, admitted]; ordered for LRU eviction
        self._classes: OrderedDict[str, list] = OrderedDict()
        self._last_contact = 0.0
        self._admitted_total = 0
        # counters (the observability satellite's node-side half)
        self.local_grants = 0
        self.spillbacks = 0
        self.epoch_discards = 0
        self.fenced_denials = 0

    # -- head contact / epoch ------------------------------------------------
    def on_head_contact(self, now: float) -> None:
        """A round trip to the head *confirmed* (reply received)."""
        self._last_contact = now

    def fenced(self, now: float) -> bool:
        return now - self._last_contact > self.fence_after_s

    def observe_epoch(self, epoch: int) -> bool:
        """Fold the head's current epoch for this node.  Returns True
        when it advanced past ours — the head revoked: the caller must
        discard locally-queued, not-yet-started grants (the head has
        already requeued them) before granting again."""
        if epoch <= self.epoch:
            return False
        self.epoch = epoch
        self.epoch_discards += 1
        for entry in self._classes.values():
            entry[1] = 0            # head requeued everything unstarted
        self._admitted_total = 0
        return True

    # -- snapshot installation -----------------------------------------------
    def install(self, grants: dict, epoch: int) -> None:
        """Merge a head-issued grant set ``{class_key: budget}`` stamped
        with ``epoch`` (>= ours; the head never time-travels)."""
        if epoch > self.epoch:
            self.epoch = epoch
        for class_key, budget in grants.items():
            entry = self._classes.get(class_key)
            if entry is None:
                while len(self._classes) >= self.max_classes:
                    self._classes.popitem(last=False)   # LRU eviction
                self._classes[class_key] = [int(budget), 0]
            else:
                entry[0] = int(budget)
                self._classes.move_to_end(class_key)

    def holds(self, class_key: str) -> bool:
        return class_key in self._classes

    def held_classes(self) -> list[str]:
        return list(self._classes)

    # -- admission -----------------------------------------------------------
    def try_grant(self, class_key: str, now: float) -> bool:
        """Admit one task of ``class_key`` locally; False == spillback."""
        if self.fenced(now):
            self.fenced_denials += 1
            self.spillbacks += 1
            return False
        entry = self._classes.get(class_key)
        if entry is None or entry[1] >= entry[0] or \
                self._admitted_total >= int(self.capacity *
                                            self.overcommit):
            self.spillbacks += 1
            return False
        entry[1] += 1
        self._admitted_total += 1
        self._classes.move_to_end(class_key)
        self.local_grants += 1
        return True

    def release(self, class_key: str) -> None:
        """A locally-admitted task finished (or was handed back)."""
        entry = self._classes.get(class_key)
        if entry is not None and entry[1] > 0:
            entry[1] -= 1
        if self._admitted_total > 0:
            self._admitted_total -= 1

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "leases_granted_local": self.local_grants,
            "spillbacks": self.spillbacks,
            "lease_epoch_discards": self.epoch_discards,
            "fenced_denials": self.fenced_denials,
            "epoch": self.epoch,
            "classes_held": len(self._classes),
            "admitted": self._admitted_total,
        }

"""Head-side lease grantor: the single source of truth.

Carves bounded per-class budgets for nodes, stamps every node's grant
set with a monotonically-increasing **epoch**, routes repeat-class
submissions to nodes already holding a matching lease (round-robin over
the class's holders), and revokes a node's entire grant set by bumping
its epoch — on death, drain, quarantine, or a leased task going quiet
past the TTL.

Revocations are journaled through an injected callback so the persisted
epoch table survives a head kill: the hot-standby restores it on
promotion, which is why outstanding leases survive failover — grant
authority already lives at the raylets, and the promoted head agrees
with them about which epochs are current.
"""

from __future__ import annotations

__all__ = ["LeaseGrantor"]


class LeaseGrantor:
    def __init__(self, budget_per_class: int, max_classes: int = 64,
                 journal=None):
        self.budget_per_class = max(1, int(budget_per_class))
        self.max_classes = max(1, int(max_classes))
        self._journal = journal          # fn(node, epoch) -> None
        self._epochs: dict[str, int] = {}
        self._grants: dict[str, dict[str, int]] = {}
        # class_key -> [holder nodes, insertion order]; rr cursor per class
        self._class_nodes: dict[str, list[str]] = {}
        self._class_rr: dict[str, int] = {}
        # epoch each node's grant set was last stamped under: origin_for
        # must not route to a holder whose epoch was bumped by revoke/
        # drop_node after its last grant — its raylet will fence every
        # admission and spill the whole batch back (the one-cycle
        # spillback storm).  A fresh grant() re-stamps and re-admits.
        self._granted_epoch: dict[str, int] = {}
        self.leases_issued = 0
        self.revocations = 0

    # -- grants --------------------------------------------------------------
    def epoch(self, node: str) -> int:
        return self._epochs.get(node, 0)

    def grant(self, node: str, class_key: str,
              budget: int | None = None) -> tuple[int, dict]:
        """Lease ``class_key`` to ``node``; returns (epoch, grant set)."""
        grants = self._grants.setdefault(node, {})
        if class_key not in grants:
            if len(grants) >= self.max_classes:
                evicted = next(iter(grants))
                del grants[evicted]
                self._unlink(evicted, node)
            holders = self._class_nodes.setdefault(class_key, [])
            if node not in holders:
                holders.append(node)
            self.leases_issued += 1
        grants[class_key] = int(budget or self.budget_per_class)
        self._granted_epoch[node] = self._epochs.get(node, 0)
        return self._epochs.get(node, 0), dict(grants)

    def snapshot_for(self, node: str) -> tuple[int, dict]:
        return self._epochs.get(node, 0), dict(self._grants.get(node, {}))

    def holds(self, node: str, class_key: str) -> bool:
        return class_key in self._grants.get(node, ())

    # -- revocation ----------------------------------------------------------
    def revoke(self, node: str, reason: str = "") -> int:
        """Bump the node's epoch: every grant stamped below it is dead.
        Returns the new epoch (journaled for failover)."""
        epoch = self._epochs.get(node, 0) + 1
        self._epochs[node] = epoch
        self.revocations += 1
        if self._journal is not None:
            self._journal(node, epoch)
        return epoch

    def drop_node(self, node: str, reason: str = "dead") -> int:
        """Node left the cluster: revoke and forget its grant set."""
        epoch = self.revoke(node, reason)
        for class_key in self._grants.pop(node, {}):
            self._unlink(class_key, node)
        self._granted_epoch.pop(node, None)
        return epoch

    def restore(self, epochs: dict) -> None:
        """Promotion path: adopt the journaled epoch table so the new
        head never re-issues an epoch the old head already revoked."""
        for node, epoch in epochs.items():
            if int(epoch) > self._epochs.get(node, 0):
                self._epochs[node] = int(epoch)

    def _unlink(self, class_key: str, node: str) -> None:
        holders = self._class_nodes.get(class_key)
        if holders and node in holders:
            holders.remove(node)
            if not holders:
                self._class_nodes.pop(class_key, None)
                self._class_rr.pop(class_key, None)

    # -- origin routing ------------------------------------------------------
    def origin_for(self, class_key: str, eligible=None) -> str | None:
        """A node already holding a lease for ``class_key`` (round-robin
        over holders, filtered by ``eligible``), or None — the caller
        falls back to global scheduling and grants the class there.

        Holders whose epoch was bumped since their last grant (revoked
        but not yet re-granted) are skipped: their grant set is fenced
        raylet-side, so routing repeat-class traffic there can only
        spill back.  They rejoin the rotation on the next ``grant``.
        """
        holders = self._class_nodes.get(class_key)
        if not holders:
            return None
        rr = self._class_rr.get(class_key, 0)
        n = len(holders)
        for off in range(n):
            node = holders[(rr + off) % n]
            if self._epochs.get(node, 0) > self._granted_epoch.get(node, -1):
                continue        # revoked since last grant: fenced
            if eligible is None or eligible(node):
                self._class_rr[class_key] = (rr + off + 1) % n
                return node
        return None

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "leases_issued": self.leases_issued,
            "lease_revocations": self.revocations,
            "nodes_with_grants": len(self._grants),
            "classes_tracked": len(self._class_nodes),
        }

"""Broadcast tree shaping: fan-out plans over the bandwidth cost model.

A plan is the static shape of one 1->N distribution tree: who relays
from whom (parent assignment) and in what order members attach (the
chunk schedule follows attach order — see ``ops/broadcast_kernel.py``
for the scoring).  Two constructors:

* ``build_plan`` — topology-aware: the fan-out kernel over the cluster's
  node-bandwidth matrix plus per-node uplink in-flight load, device-
  evaluated for big member sets (same backend-switch discipline as the
  pull manager's source selection).
* ``balanced_plan`` — index-ordered balanced F-ary tree over a plain
  member list, for callers with no bandwidth matrix (the plane-level
  ``ObjectPlane.broadcast`` primitive, benches).

Both emit the same ``BroadcastPlan``; the relay protocol never sees the
difference.
"""

from __future__ import annotations

from ..common.config import get_config


class BroadcastPlan:
    """One tree: ``root`` plus, per attached member, its parent and the
    ancestor fallback chain the relay protocol re-parents through."""

    def __init__(self, root, parent: dict, order: list):
        self.root = root
        self.parent = parent        # member -> parent (root included)
        self.order = order          # members, attach order
        self.children: dict = {}
        for c, p in parent.items():
            self.children.setdefault(p, []).append(c)

    def fallbacks(self, member) -> list:
        """Ancestor chain above ``member``'s parent, ending at the root:
        the re-parent targets when the parent dies mid-broadcast."""
        out = []
        node = self.parent.get(member)
        while node is not None and node not in out and node != member:
            out.append(node)
            node = self.parent.get(node)
        if self.root not in out:
            out.append(self.root)
        return out

    def relay_fanout(self) -> float:
        """Mean children per relaying (non-leaf) node — the observability
        gauge ``broadcast_relay_fanout``."""
        if not self.children:
            return 0.0
        return sum(len(v) for v in self.children.values()) \
            / len(self.children)

    def depth(self) -> int:
        d = 0
        for m in self.order:
            hops = len(self.fallbacks(m))
            d = max(d, hops)
        return d


def build_plan(member_rows, bw, root_row: int, fanout: int | None = None,
               inflight_kb=None, device=None) -> BroadcastPlan:
    """Shape a tree over the node-bandwidth matrix.  ``member_rows`` are
    CRM rows wanting a replica (root excluded or included — it is
    always covered); rows the matrix cannot reach stay unattached and
    are absent from the plan (callers fall back to a plain pull).
    ``device``: where the fan-out program runs for batches at or above
    ``broadcast_device_batch_min`` (the GPU unless the caller asks for
    the CPU)."""
    cfg = get_config()
    fanout = int(fanout or cfg.broadcast_fanout)
    n = bw.shape[0]
    import numpy as np
    member = np.zeros(n, dtype=bool)
    for r in member_rows:
        if 0 <= r < n:
            member[r] = True
    member[root_row] = True
    if len(member_rows) >= cfg.broadcast_device_batch_min:
        from ..ops.broadcast_kernel import plan_fanout_np
        parent, order = plan_fanout_np(member, bw, root_row, fanout,
                                       inflight_kb, device=device)
    else:
        from ..ops.broadcast_kernel import plan_fanout_oracle
        parent, order = plan_fanout_oracle(member, bw, root_row, fanout,
                                           inflight_kb)
    pmap = {int(c): int(parent[c]) for c in range(n) if parent[c] >= 0}
    attach = sorted(pmap, key=lambda c: int(order[c]))
    return BroadcastPlan(int(root_row), pmap, attach)


def balanced_plan(members: list, root, fanout: int | None = None
                  ) -> BroadcastPlan:
    """Index-ordered balanced F-ary tree over an explicit member list
    (no bandwidth matrix): member i's parent is the root for i < F,
    else member (i - F) // F.  Depth ~log_F(M)."""
    fanout = int(fanout or get_config().broadcast_fanout)
    fanout = max(1, fanout)
    parent = {}
    for i, m in enumerate(members):
        parent[m] = root if i < fanout else members[(i - fanout) // fanout]
    return BroadcastPlan(root, parent, list(members))

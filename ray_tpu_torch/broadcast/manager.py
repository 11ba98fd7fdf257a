"""BroadcastManager: the head-side coordinator for 1->N distribution.

Builds the fan-out plan (``broadcast/plan.py`` over the cluster's
node-bandwidth matrix + the pull manager's per-node uplink in-flight
ledger), fires one ``bc_begin`` per member — all concurrently, so the
relay pipeline forms immediately — and records directory locations as
replicas seal.  Members whose relay session fails (every fallback
gone) are retried through the pull manager's striped machinery, so a
broadcast degrades to pulls rather than failing outright.

Concurrent-pull integration: while a tree is active for an object, the
pull manager offers each new pull of that object to ``join()`` first —
the destination grafts onto the tree as a fresh leaf (parented to a
completed member or the root) instead of opening an independent source
stream against the cost model's favorite replica.
"""

from __future__ import annotations

import itertools
import threading

from ..common.config import get_config
from ..common import clock as _clk
from .plan import BroadcastPlan, build_plan


class _ActiveTree:
    """Coordinator-side record of one in-flight broadcast."""

    def __init__(self, bcast_id: str, oid, size: int, chunk: int,
                 root_addr: str, plan: BroadcastPlan):
        self.bcast_id = bcast_id
        self.oid = oid
        self.size = size
        self.chunk = chunk
        self.root_addr = root_addr
        self.plan = plan
        self.lock = threading.Lock()
        self.completed_addrs: list[str] = []    # sealed replicas, oldest
        #                                         first (graft parents)
        self.joins = 0


class BroadcastManager:
    def __init__(self, cluster):
        self._cluster = cluster
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._active: dict[bytes, _ActiveTree] = {}   # oid bin -> tree
        # stats
        self.trees_started = 0
        self.trees_completed = 0
        self.trees_failed = 0           # >= 1 member fell back to pull
        self.members_reached = 0
        self.members_fallback = 0
        self.joins = 0
        self.last_relay_fanout = 0.0
        self.ewma_time_to_all_s = 0.0

    # -- public API ----------------------------------------------------------
    def broadcast(self, object_id, node_rows=None, fanout=None,
                  timeout: float | None = None) -> dict:
        """Distribute ``object_id`` to ``node_rows`` (default: every
        node with a plane).  Blocks until every member holds a sealed
        replica (relay tree first, pull-manager fallback for stragglers)
        and returns a summary dict."""
        cluster = self._cluster
        oid = getattr(object_id, "object_id", object_id)
        cfg = get_config()
        rows = cluster.directory.locations(oid)
        if not rows:
            return {"ok": False, "error": "object has no tracked "
                    "location (in-band or lost)", "members": 0}
        root_row, root_addr = self._pick_root(rows)
        if root_addr is None:
            return {"ok": False, "error": "no servable root replica "
                    "(no plane is serving the object)", "members": 0}
        size = self._object_size(oid, root_addr)
        if size <= 0:
            return {"ok": False, "error": "object size unknown",
                    "members": 0}
        if node_rows is None:
            node_rows = sorted(cluster.planes)
        members = [r for r in node_rows
                   if not cluster.directory.has_location(oid, r)]
        # head-resident rows (no plane address) share the head store:
        # bytes are either already there or one plain pull away
        local_rows = [r for r in members
                      if cluster.planes.get(r) is None]
        members = [r for r in members if r not in local_rows]
        t0 = _clk.monotonic()
        summary = {"ok": True, "bcast_id": None, "members": len(members),
                   "reached": 0, "joined_rows": [], "fallbacks": 0,
                   "depth": 0, "relay_fanout": 0.0, "seconds": 0.0}
        for r in local_rows:
            if self._pull_fallback(oid, size, r, root_addr):
                cluster.directory.add_location(oid, r)
                summary["reached"] += 1
            else:
                summary["ok"] = False
        if not members:
            summary["seconds"] = _clk.monotonic() - t0
            return summary
        plan = build_plan(members, cluster.bandwidth_mbps, root_row,
                          fanout=fanout,
                          inflight_kb=cluster.pull_manager.inflight_kb(
                              cluster.bandwidth_mbps.shape[0]),
                          device=cluster.scheduler_device)
        bcast_id = f"{oid.hex()[:16]}.{next(self._seq)}"
        chunk = cfg.broadcast_chunk_mb * (1 << 20)
        tree = _ActiveTree(bcast_id, oid, size, chunk, root_addr, plan)
        with self._lock:
            self._active[oid.binary()] = tree
            self.trees_started += 1
        self.last_relay_fanout = plan.relay_fanout()
        summary["bcast_id"] = bcast_id
        summary["depth"] = plan.depth()
        summary["relay_fanout"] = round(self.last_relay_fanout, 2)
        try:
            reached, fell_back = self._run_tree(tree, timeout)
        finally:
            with self._lock:
                self._active.pop(oid.binary(), None)
        summary["reached"] += len(reached)
        summary["fallbacks"] = len(fell_back)
        summary["joined_rows"] = sorted(reached | set(fell_back))
        unattached = [r for r in members
                      if r not in reached and r not in fell_back]
        summary["fallbacks"] += len(unattached)
        for r in (*fell_back, *unattached):
            if self._pull_fallback(oid, size, r, root_addr):
                cluster.directory.add_location(oid, r)
                summary["reached"] += 1
            else:
                summary["ok"] = False
        dt = _clk.monotonic() - t0
        summary["seconds"] = round(dt, 4)
        with self._lock:
            self.members_reached += summary["reached"]
            self.members_fallback += summary["fallbacks"]
            self.joins += tree.joins
            if summary["fallbacks"] or not summary["ok"]:
                self.trees_failed += 1
            else:
                self.trees_completed += 1
            self.ewma_time_to_all_s = (
                dt if self.ewma_time_to_all_s == 0
                else 0.8 * self.ewma_time_to_all_s + 0.2 * dt)
        return summary

    def join(self, object_id, dest_row: int) -> bool:
        """Pull-manager integration: a concurrent pull of an object with
        an ACTIVE broadcast grafts onto the tree as a fresh leaf instead
        of opening a new source stream.  True when the graft sealed a
        replica at ``dest_row`` (the caller then records the location
        exactly like a finished pull)."""
        if not get_config().broadcast_join_pulls:
            return False
        cluster = self._cluster
        with self._lock:
            tree = self._active.get(object_id.binary())
        if tree is None:
            return False
        dest_addr = cluster.planes.get(dest_row)
        if dest_addr is None:
            return False        # head-resident: a plain pull is local
        with tree.lock:
            # graft under a completed member when one exists (spreads
            # uplink load off the root), else under the root itself
            parents = [*tree.completed_addrs[:2], tree.root_addr]
            tree.joins += 1
        try:
            res = cluster.plane._peer(dest_addr).call(
                "bc_begin", tree.bcast_id, tree.oid.binary(), tree.size,
                tuple(dict.fromkeys(parents)), tree.chunk,
                timeout=self._tree_timeout(tree.size))
        except Exception:   # noqa: BLE001 — graft failed: plain pull
            cluster.plane._drop_peer(dest_addr)
            return False
        return bool(res.get("ok"))

    def stats(self) -> dict:
        with self._lock:
            active = len(self._active)
        return {
            "bcast_trees_started": self.trees_started,
            "bcast_trees_completed": self.trees_completed,
            "bcast_trees_failed": self.trees_failed,
            "bcast_active_trees": active,
            "bcast_members_reached": self.members_reached,
            "bcast_members_fallback": self.members_fallback,
            "bcast_joins": self.joins,
            "bcast_relay_fanout": round(self.last_relay_fanout, 2),
            "bcast_time_to_all_ewma_s": round(self.ewma_time_to_all_s,
                                              4),
        }

    def shutdown(self) -> None:
        with self._lock:
            self._active.clear()

    # -- internals -----------------------------------------------------------
    def _pick_root(self, rows) -> tuple[int, str | None]:
        """First location with a servable plane address (head-resident
        replicas serve through the head's own plane)."""
        cluster = self._cluster
        for row in rows:
            addr = cluster.planes.get(row)
            if addr is None:
                addr = cluster.plane.serve_address
            if addr is not None:
                return int(row), addr
        return int(rows[0]), None

    def _object_size(self, oid, root_addr: str) -> int:
        kind, size = self._cluster.store.plasma_info(oid)
        if kind in ("shm", "spill"):
            return int(size)
        try:
            _kind, size = self._cluster.plane._peer(root_addr).call(
                "op_stat", oid.binary(), timeout=30.0)
            return int(size)
        except Exception:   # noqa: BLE001 — root unreachable
            return 0

    def _tree_timeout(self, size: int) -> float:
        """Generous per-member deadline: whole-object at 1 MB/s plus
        the configured chunk-stall allowance."""
        return get_config().broadcast_fetch_timeout_s + \
            max(60.0, size / (1 << 20))

    def _run_tree(self, tree: _ActiveTree, timeout: float | None
                  ) -> tuple[set, list]:
        """Fire bc_begin at every member concurrently (the pipeline
        forms as ancestors start landing chunks) and wait for the
        results.  Returns (reached rows, fallback rows)."""
        cluster = self._cluster
        plan = tree.plan
        addr_of = {plan.root: tree.root_addr}
        for row in plan.order:
            addr_of[row] = cluster.planes.get(row)
        deadline = (_clk.monotonic() + timeout) if timeout else None
        futs: list[tuple[int, object]] = []
        fell_back: list[int] = []
        for row in plan.order:
            dest = addr_of.get(row)
            if dest is None:
                fell_back.append(row)
                continue
            sources = []
            for anc in plan.fallbacks(row):
                a = addr_of.get(anc)
                if a is not None and a not in sources and a != dest:
                    sources.append(a)
            if tree.root_addr not in sources:
                sources.append(tree.root_addr)
            try:
                fut = cluster.plane._peer(dest).call_async(
                    "bc_begin", tree.bcast_id, tree.oid.binary(),
                    tree.size, tuple(sources), tree.chunk)
            except Exception:   # noqa: BLE001 — member unreachable
                cluster.plane._drop_peer(dest)
                fell_back.append(row)
                continue
            futs.append((row, fut))
        reached: set[int] = set()
        per_member = self._tree_timeout(tree.size)
        for row, fut in futs:
            left = per_member
            if deadline is not None:
                left = min(left, max(0.0, deadline - _clk.monotonic()))
            ok = False
            try:
                res = fut.result(left)
                ok = bool(res.get("ok"))
            except Exception:   # noqa: BLE001 — member died mid-session
                cluster.plane._drop_peer(addr_of[row])
            if ok:
                # bytes land BEFORE the directory update (same ordering
                # discipline as the pull manager)
                cluster.directory.add_location(tree.oid, row)
                reached.add(row)
                with tree.lock:
                    tree.completed_addrs.append(addr_of[row])
            else:
                fell_back.append(row)
        return reached, fell_back

    def _pull_fallback(self, oid, size: int, row: int,
                       root_addr: str) -> bool:
        """A member the tree could not reach still gets its replica —
        through the plane's striped pull machinery."""
        cluster = self._cluster
        self_addr = cluster.planes.get(row)
        extra = tuple(a for a in (cluster.plane.serve_address,)
                      if a and a != root_addr)
        if self_addr is None:
            return cluster.plane.pull_into_local(oid, size, root_addr,
                                                 extra)
        return cluster.plane.request_remote_pull(self_addr, oid, size,
                                                 root_addr, extra)

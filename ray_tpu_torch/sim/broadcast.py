"""Event-scheduled broadcast waves over the simulated cluster.

The socket relay protocol (``broadcast/relay.py``) runs sessions on
per-request threads and blocks server-side — a shape the synchronous
single-threaded ``SimTransport`` cannot host.  The simulator therefore
models the SAME protocol as discrete chunk-delivery events on the
virtual clock: per-parent serialized uplinks, relay-as-you-receive
(a chunk forwards the moment it lands), deterministic re-parenting
through the ancestor chain when a parent dies, retry-with-backoff when
every candidate is momentarily gone (head restart).  1k-relay-node
waves run in milliseconds of wall time and land in the campaign trace,
so replay hashes cover broadcast behavior bit-for-bit.

Uplink model: parent ``p`` serves one chunk in ``chunk_bytes /
uplink_mbps`` virtual seconds, chunks serialized per parent (children
share the uplink exactly like frames on one NIC) — the same shape the
socket path enforces with ``plane_uplink_mbps`` pacing.
"""

from __future__ import annotations

from ..broadcast.plan import balanced_plan

_HEAD = "head"
_RETRY_S = 5.0          # re-probe period while no parent candidate lives
_MAX_RETRIES = 200      # then the member is marked unreachable


class SimBroadcastWave:
    """One 1->N distribution: a balanced relay tree over ``members``
    rooted at ``root`` (default: the head)."""

    def __init__(self, cluster, wave_id: str, members: list[str],
                 root: str = _HEAD, size_mb: int = 1024,
                 chunk_mb: int = 8, fanout: int = 2,
                 uplink_mbps: float = 1000.0):
        self.cluster = cluster
        self.wave_id = wave_id
        self.members = [m for m in dict.fromkeys(members) if m != root]
        self.root = root
        self.size = int(size_mb) * (1 << 20)
        self.chunk = int(chunk_mb) * (1 << 20)
        self.nchunks = max(1, -(-self.size // self.chunk))
        self.uplink = float(uplink_mbps) * (1 << 20)    # bytes/s
        self.plan = balanced_plan(self.members, root, fanout)
        self.parent_of = dict(self.plan.parent)
        self.have = {root: self.nchunks}
        self.have.update({m: 0 for m in self.members})
        self.up_free = {root: 0.0}      # uplink next-free instant
        self.waiters: dict[str, list] = {}  # parent -> [(child, k)]
        self.retries: dict[str, int] = {}
        self.completed: list[str] = []
        self.unreachable: set[str] = set()
        self.reparents = 0
        self.chunks_delivered = 0
        self.t_start = 0.0
        self.t_done: float | None = None
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        clock, trace = self.cluster.clock, self.cluster.trace
        self.t_start = clock.monotonic()
        self._started = True
        trace.rec(self.t_start, "bcast_start", wave=self.wave_id,
                  root=self.root, members=len(self.members),
                  chunks=self.nchunks, fanout=self.plan.relay_fanout())
        for m in self.members:
            self._request(m, 0)
        self._check_done()

    @property
    def terminal(self) -> bool:
        return self._started and \
            len(self.completed) + len(self._dead_members()) + \
            len(self.unreachable) >= len(self.members)

    @property
    def time_to_all(self) -> float | None:
        return None if self.t_done is None else \
            self.t_done - self.t_start

    def unreached_live(self) -> list[str]:
        """Live members without a full replica — the campaign's final
        strict check expects this empty after quiesce."""
        done = set(self.completed)
        return [m for m in self.members
                if m not in done and self._alive(m)]

    # -- failure plumbing ----------------------------------------------------
    def on_node_killed(self, nid: str) -> None:
        """A relay died: orphaned children re-parent through the
        ancestor chain and resume their missing chunks.  Waiters parked
        on the dead node are flushed here (no event would ever wake
        them); in-flight deliveries re-check liveness on landing."""
        if not self._started or self.t_done is not None:
            return
        stuck = self.waiters.pop(nid, [])
        for child, k in stuck:
            self._request(child, k)
        self._check_done()

    # -- internals -----------------------------------------------------------
    def _alive(self, nid: str) -> bool:
        if nid == _HEAD:
            head = self.cluster.head
            return head is not None and head.alive
        node = self.cluster.nodes.get(nid)
        return node is not None and node.alive

    def _dead_members(self) -> list[str]:
        return [m for m in self.members if not self._alive(m)]

    def _pick_parent(self, child: str) -> str | None:
        """Deterministic re-parent order: original ancestor chain
        (ending at the root), then sealed replicas oldest-first.  A
        candidate whose CURRENT parent chain runs through ``child`` is
        skipped (no cycles)."""
        for cand in (*self.plan.fallbacks(child), *self.completed):
            if cand == child or not self._alive(cand):
                continue
            node, hops = cand, 0
            while node is not None and hops <= len(self.members) + 1:
                if node == child:
                    break
                node = self.parent_of.get(node)
                hops += 1
            else:
                node = None
            if node == child:
                continue
            return cand
        return None

    def _request(self, child: str, k: int) -> None:
        """Child wants chunk ``k``: serve it from the current parent's
        uplink if the parent has it, park as a waiter if not yet, or
        re-parent if the parent is gone."""
        clock = self.cluster.clock
        if not self._alive(child) or self.t_done is not None:
            return
        parent = self.parent_of.get(child)
        if parent is None or not self._alive(parent):
            cand = self._pick_parent(child)
            if cand is None:
                n = self.retries.get(child, 0) + 1
                self.retries[child] = n
                if n > _MAX_RETRIES:
                    self.unreachable.add(child)
                    self.cluster.trace.rec(
                        clock.monotonic(), "bcast_unreachable",
                        wave=self.wave_id, node=child)
                    self._check_done()
                    return
                clock.call_later(_RETRY_S,
                                 lambda: self._request(child, k))
                return
            if cand != parent:
                self.reparents += 1
                self.cluster.trace.rec(
                    clock.monotonic(), "bcast_reparent",
                    wave=self.wave_id, node=child, parent=cand)
            self.parent_of[child] = cand
            parent = cand
        if self.have.get(parent, 0) > k:
            now = clock.monotonic()
            nbytes = min(self.chunk, self.size - k * self.chunk)
            dur = nbytes / self.uplink
            begin = max(now, self.up_free.get(parent, 0.0))
            self.up_free[parent] = begin + dur
            clock.call_later(
                begin + dur - now,
                lambda: self._deliver(child, k, parent))
        else:
            self.waiters.setdefault(parent, []).append((child, k))

    def _deliver(self, child: str, k: int, parent: str) -> None:
        if not self._started or self.t_done is not None or \
                not self._alive(child):
            return
        if not self._alive(parent):
            # the sender died mid-chunk: the bytes never finished —
            # refetch through a new parent, nothing is lost
            self._request(child, k)
            return
        if self.have[child] > k:
            return      # duplicate (re-requested during a gray window)
        self.have[child] = k + 1
        self.chunks_delivered += 1
        # relay-as-you-receive: children parked on this chunk go NOW
        still = []
        for gc, wk in self.waiters.pop(child, []):
            if wk < self.have[child]:
                self._request(gc, wk)
            else:
                still.append((gc, wk))
        if still:
            self.waiters.setdefault(child, []).extend(still)
        if self.have[child] >= self.nchunks:
            self.completed.append(child)
            self.cluster.trace.rec(
                self.cluster.clock.monotonic(), "bcast_node_complete",
                wave=self.wave_id, node=child)
            self._check_done()
        else:
            self._request(child, k + 1)

    def _check_done(self) -> None:
        if self.t_done is None and self.terminal:
            self.t_done = self.cluster.clock.monotonic()
            self.cluster.trace.rec(
                self.t_done, "bcast_complete", wave=self.wave_id,
                reached=len(self.completed),
                dead=len(self._dead_members()),
                unreachable=len(self.unreachable),
                reparents=self.reparents,
                chunks=self.chunks_delivered,
                seconds=round(self.t_done - self.t_start, 6))

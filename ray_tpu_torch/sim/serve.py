"""Simulated serve plane: sharded routers, gossiped load digests and
elastic serve<->batch capacity loaning over the simulated cluster.

The live request plane (``serve/router.py`` + ``serve/gossip.py`` +
``serve/loaning.py``) runs on threads and real actors — a shape the
synchronous single-threaded ``SimTransport`` cannot host.  The
simulator therefore models the SAME control decisions as discrete
events on the virtual clock:

* **Sharded routers.**  Each shard serializes its routing work — one
  admission + placement decision costs ``route_overhead_s`` of shard
  time, exactly the per-request critical section the live
  ``RequestRouter`` holds under its condition variable.  Shard count is
  therefore the request-plane throughput lever, which is what the
  diurnal bench measures (1 shard vs N at identical load).
* **Gossiped load.**  Shards route power-of-two-choices on a digest of
  per-replica load that refreshes only when that replica's node
  heartbeats (``SimHead._h_heartbeat`` -> :meth:`on_heartbeat`), plus
  the shard's own dispatches since the last fold — the same
  bounded-staleness contract as ``serve/gossip.py``.  Staleness is safe
  here for the same reason as in the live plane: replica concurrency
  caps are enforced replica-side, so a stale digest over-QUEUES a
  replica, it never over-RUNS the cap.
* **Capacity loaning.**  When serve backlog crosses the bar the plane
  borrows an idle batch node (it vanishes from ``SimHead._pick_node``
  via the ``reserved`` set), warms it in ``warmup_s`` — far below
  ``boot_delay_s``, the cold-start reference — and reclaims it with
  drain semantics when batch pressure returns or the peak passes:
  stop routing, let inflight finish, hand the row back.  A loaned node
  SIGKILLed mid-anything books the loss exactly once (the loan record
  is popped) and its accepted requests re-dispatch to other replicas.

Determinism contract: same as the rest of the simulator — virtual
clock, all randomness from one Philox stream keyed ``[seed,
0x5E12FE]``, no iteration over unordered sets (``reserved`` is
membership-only), bounded trace recording (aggregate windows + loan
lifecycle events, never per-request events).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass

__all__ = ["SimServePlane", "SimServeParams"]

# latency histogram bucket upper edges (seconds); quantiles are read as
# the upper edge of the covering bucket — deterministic and O(1) memory
_LAT_EDGES = (0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0, 10.0)


@dataclass
class SimServeParams:
    """Shape knobs for the simulated serve plane."""

    num_shards: int = 4
    replica_cap: int = 4            # max concurrent requests per replica
    replica_queue: int = 8          # replica mailbox bound (then bounce)
    service_s: tuple = (0.06, 0.14)     # uniform service time draw
    route_overhead_s: float = 0.002     # serialized shard work/request
    shard_queue: int = 512          # TOTAL admission bound, split across
                                    # shards like the live router's
                                    # _enqueue_locked (shed past it)
    arrival_tick_s: float = 0.1     # Poisson arrival batching quantum
    window_s: float = 15.0          # aggregate trace window
    warmup_s: float = 0.5           # loaned-node warm-up (<< boot_delay_s)
    loan_max: int = 4
    loan_backlog: int = 24          # queued requests that trigger a loan
    loan_reclaim_idle_s: float = 20.0
    tick_s: float = 2.5             # loan state machine period
    sessions: int = 64              # distinct sticky session keys


class _Replica:
    __slots__ = ("nid", "cap", "inflight", "queue", "loaned", "alive",
                 "route_ok", "epoch", "version")

    def __init__(self, nid: str, cap: int, loaned: bool = False):
        self.nid = nid
        self.cap = cap
        self.inflight: dict[int, float] = {}    # rid -> arrival t
        self.queue: deque = deque()             # (rid, arrival t)
        self.loaned = loaned
        self.alive = True
        self.route_ok = True
        self.epoch = 0          # bumped on death: stale completions no-op
        self.version = "v1"     # model version tag (rollout plane re-tags)

    def load(self) -> int:
        return len(self.inflight) + len(self.queue)


class _Shard:
    __slots__ = ("idx", "queue", "routing", "own")

    def __init__(self, idx: int):
        self.idx = idx
        self.queue: deque = deque()     # accepted (rid, arrival t)
        self.routing = False            # serialized: one decision at a time
        self.own: dict[str, int] = {}   # nid -> dispatches since last fold


class SimServePlane:
    """The serve overlay a ``serve_diurnal`` campaign installs on a
    :class:`SimCluster` (as ``cluster.serve_plane``)."""

    def __init__(self, cluster, seed: int = 0,
                 duration: float = 200.0,
                 num_replicas: int | None = None,
                 params: SimServeParams | None = None,
                 base_rps: float | None = None,
                 peak_rps: float | None = None):
        import numpy as np

        self.cluster = cluster
        self.p = params or SimServeParams()
        self.rng = np.random.Generator(np.random.Philox(
            key=[int(seed) & (2 ** 64 - 1), 0x5E12FE]))
        n = num_replicas if num_replicas is not None else \
            max(2, len(cluster.nodes) // 16)
        # base pool: the first n node ids, deterministically — these rows
        # are reserved (SimHead._pick_node and the autoscaler skip them)
        base = sorted(cluster.nodes)[:n]
        self.reserved: set[str] = set(base)
        self.replicas: dict[str, _Replica] = {
            nid: _Replica(nid, self.p.replica_cap) for nid in base}
        self.shards = [_Shard(i) for i in range(self.p.num_shards)]
        self._admit = max(8, self.p.shard_queue // self.p.num_shards)
        self.digest: dict[str, int] = {nid: 0 for nid in base}
        self.loans: dict[str, dict] = {}    # nid -> {state, t0, t_drain}
        # reverse direction (Aryl: train borrows serve capacity at the
        # diurnal trough) — driven entirely by sim/train.py, so on
        # campaigns without a train plane ``lent`` stays empty and every
        # branch below is dead (replay hashes of serve-only runs are
        # untouched)
        self.lent: dict[str, dict] = {}     # nid -> {state, t0}
        self.lends_total = 0
        self.lends_returned = 0
        self.lends_lost = 0

        # diurnal curve: one full cycle over the arrival window, scaled
        # to the base pool's steady-state capacity
        mean_svc = (self.p.service_s[0] + self.p.service_s[1]) / 2.0
        cap_rps = n * self.p.replica_cap / mean_svc
        self.base_rps = base_rps if base_rps is not None else 0.45 * cap_rps
        self.peak_rps = peak_rps if peak_rps is not None else 1.45 * cap_rps
        self.arrival_end = duration * 0.85
        self.pool_capacity_rps = cap_rps

        self.started = False
        self.arrivals_done = False
        self._rid = 0
        self.accepted = 0
        self.completed = 0
        self.shed = 0
        self.redispatched = 0
        self.outstanding = 0        # accepted - completed, by counter
        self.in_route = 0           # popped from a shard, not yet placed
        self.loans_total = 0
        self.reclaims_total = 0
        self.loans_lost = 0
        self.peak_backlog = 0
        self._busy_t = 0.0
        self._reclaim_sum = 0.0
        self._reclaim_max = 0.0
        self._win = {"accepted": 0, "completed": 0, "shed": 0}
        self._hist = [0] * (len(_LAT_EDGES) + 1)
        # model-version plane (sim/rollout.py) — None on every campaign
        # except serve_rolling_update, so no hook below changes the
        # behavior (or replay hash) of existing serve runs
        self.rollout = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        clock, trace = self.cluster.clock, self.cluster.trace
        self.started = True
        trace.rec(clock.monotonic(), "serve_start",
                  replicas=len(self.replicas), shards=len(self.shards),
                  base_rps=round(self.base_rps, 3),
                  peak_rps=round(self.peak_rps, 3))
        clock.call_later(self.p.arrival_tick_s, self._arrivals)
        clock.call_later(self.p.tick_s, self._tick)
        clock.call_later(self.p.window_s, self._window)

    @property
    def terminal(self) -> bool:
        return self.started and self.arrivals_done and \
            self.outstanding == 0 and not self.loans and not self.lent

    # -- arrivals ------------------------------------------------------------
    def _rate(self, t: float) -> float:
        frac = min(1.0, t / max(self.arrival_end, 1e-9))
        return self.base_rps + (self.peak_rps - self.base_rps) * \
            0.5 * (1.0 - math.cos(2.0 * math.pi * frac))

    def _arrivals(self) -> None:
        if not self.cluster.running:
            return
        now = self.cluster.clock.monotonic()
        if now >= self.arrival_end:
            self.arrivals_done = True
            return
        n = int(self.rng.poisson(self._rate(now) * self.p.arrival_tick_s))
        for _ in range(n):
            session = int(self.rng.integers(self.p.sessions))
            # session stickiness: Knuth-hash rendezvous, same shape as
            # RouterGroup.shard_for — a session always lands one shard
            shard = self.shards[
                (session * 2654435761) % (1 << 32) % len(self.shards)]
            if len(shard.queue) >= self._admit:
                self.shed += 1
                self._win["shed"] += 1
                continue
            self._rid += 1
            self.accepted += 1
            self.outstanding += 1
            self._win["accepted"] += 1
            shard.queue.append((self._rid, now))
            if self.rollout is not None:
                self.rollout.note_arrival(self._rid, session, now)
            self._pump(shard)
        self.cluster.clock.call_later(self.p.arrival_tick_s,
                                      self._arrivals)

    # -- routing (serialized per shard) --------------------------------------
    def _pump(self, shard: _Shard) -> None:
        if shard.routing or not shard.queue:
            return
        shard.routing = True
        rid, t_arr = shard.queue.popleft()
        self.in_route += 1
        self.cluster.clock.call_later(
            self.p.route_overhead_s,
            lambda: self._dispatch(shard, rid, t_arr))

    def _viewed_load(self, shard: _Shard, nid: str) -> int:
        return self.digest.get(nid, 0) + shard.own.get(nid, 0)

    def _dispatch(self, shard: _Shard, rid: int, t_arr: float) -> None:
        shard.routing = False
        if not self.cluster.running:
            return
        live = [r for r in self.replicas.values()
                if r.alive and r.route_ok]
        if not live:
            # momentarily no routable replica (mass kill, loan warming):
            # park and retry — the request is accepted, never dropped
            self.in_route -= 1
            shard.queue.appendleft((rid, t_arr))
            self.cluster.clock.call_later(1.0, lambda: self._pump(shard))
            return
        if self.rollout is not None:
            # session-version pinning: candidates narrow to the pinned
            # version (never to empty — the pin migrates instead)
            live = self.rollout.filter_candidates(rid, live)
        if len(live) == 1:
            cands = [live[0]]
        else:
            i = int(self.rng.integers(len(live)))
            j = int(self.rng.integers(len(live)))
            a, b = live[i], live[j]
            if self._viewed_load(shard, a.nid) <= \
                    self._viewed_load(shard, b.nid):
                cands = [a, b]
            else:
                cands = [b, a]
        bound = self.p.replica_cap + self.p.replica_queue
        for rep in cands:
            # cap + mailbox enforced replica-side on ACTUAL load: a
            # stale digest can pick a full replica, but the replica
            # bounces it back to the shard instead of over-running
            if rep.load() < bound:
                shard.own[rep.nid] = shard.own.get(rep.nid, 0) + 1
                self.in_route -= 1
                self._deliver(rep, rid, t_arr)
                self._pump(shard)
                return
        # every candidate full: back-pressure into the shard queue —
        # a completion (or the tick backstop) pumps the shard again
        self.in_route -= 1
        shard.queue.appendleft((rid, t_arr))
        self.cluster.clock.call_later(0.05, lambda: self._pump(shard))

    def _deliver(self, rep: _Replica, rid: int, t_arr: float) -> None:
        if len(rep.inflight) < rep.cap:
            self._begin(rep, rid, t_arr)
        else:
            # cap enforced replica-side: over-queue, never over-run
            rep.queue.append((rid, t_arr))

    def _begin(self, rep: _Replica, rid: int, t_arr: float) -> None:
        rep.inflight[rid] = t_arr
        svc = float(self.rng.uniform(*self.p.service_s))
        epoch = rep.epoch
        self.cluster.clock.call_later(
            svc, lambda: self._complete(rep.nid, rid, epoch))

    def _complete(self, nid: str, rid: int, epoch: int) -> None:
        rep = self.replicas.get(nid)
        if rep is None or rep.epoch != epoch or rid not in rep.inflight:
            return      # replica died meanwhile; request re-dispatched
        t_arr = rep.inflight.pop(rid)
        now = self.cluster.clock.monotonic()
        lat = now - t_arr
        k = 0
        while k < len(_LAT_EDGES) and lat > _LAT_EDGES[k]:
            k += 1
        self._hist[k] += 1
        self.completed += 1
        self.outstanding -= 1
        self._win["completed"] += 1
        if self.rollout is not None:
            self.rollout.on_complete(rid, rep.version)
        if rep.queue:
            nrid, nt = rep.queue.popleft()
            self._begin(rep, nrid, nt)
        # a slot (or mailbox room) freed: shards with parked work retry
        for shard in self.shards:
            self._pump(shard)

    # -- gossip fold (piggybacked on node heartbeats) ------------------------
    def on_heartbeat(self, nid: str) -> None:
        rep = self.replicas.get(nid)
        if rep is None:
            return
        self.digest[nid] = rep.load()
        for shard in self.shards:
            shard.own.pop(nid, None)

    # -- failure plumbing ----------------------------------------------------
    def on_node_killed(self, nid: str) -> None:
        if nid in self.replicas:
            self._replica_dead(nid)
        elif nid in self.loans:
            # killed while still warming: no replica yet, book the loss
            self.loans.pop(nid)
            self.reserved.discard(nid)
            self.loans_lost += 1
            self.cluster.trace.rec(self.cluster.clock.monotonic(),
                                   "loan_lost", node=nid, phase="warming")
        elif nid in self.lent:
            # died while fully lent out (no replica on it): the lend
            # record pops HERE and only here — booked exactly once even
            # when the train plane also sees the kill
            lend = self.lent.pop(nid)
            self.reserved.discard(nid)
            self.lends_lost += 1
            self.cluster.trace.rec(self.cluster.clock.monotonic(),
                                   "reverse_lend_lost", node=nid,
                                   phase=lend["state"])

    def _replica_dead(self, nid: str) -> None:
        rep = self.replicas.pop(nid, None)
        if rep is None:
            return
        rep.alive = False
        rep.epoch += 1
        moved = list(rep.inflight.items()) + list(rep.queue)
        for rid, t_arr in moved:
            # accepted work survives its replica: back into a shard
            shard = self.shards[rid % len(self.shards)]
            shard.queue.append((rid, t_arr))
        self.redispatched += len(moved)
        for shard in self.shards:
            shard.own.pop(nid, None)
        self.digest.pop(nid, None)
        self.reserved.discard(nid)
        loan = self.loans.pop(nid, None)
        lend = self.lent.pop(nid, None)
        now = self.cluster.clock.monotonic()
        if loan is not None:
            self.loans_lost += 1    # popped record: booked exactly once
            self.cluster.trace.rec(now, "loan_lost", node=nid,
                                   phase=loan["state"],
                                   redispatched=len(moved))
        elif lend is not None:
            # died while draining toward the train plane: same
            # popped-record exactly-once contract as the forward loans
            self.lends_lost += 1
            self.cluster.trace.rec(now, "reverse_lend_lost", node=nid,
                                   phase=lend["state"],
                                   redispatched=len(moved))
        else:
            self.cluster.trace.rec(now, "serve_replica_dead", node=nid,
                                   redispatched=len(moved))
        for shard in self.shards:
            self._pump(shard)

    # -- the loan state machine ----------------------------------------------
    def _backlog(self) -> int:
        return sum(len(s.queue) for s in self.shards) + \
            sum(len(r.queue) for r in self.replicas.values())

    def _node_alive(self, nid: str) -> bool:
        node = self.cluster.nodes.get(nid)
        return node is not None and node.alive

    def _tick(self) -> None:
        if not self.cluster.running:
            return
        clock, trace = self.cluster.clock, self.cluster.trace
        now = clock.monotonic()
        # sweep: replicas/loans whose node died without a kill callback
        # (campaign drain faults make serve nodes exit cleanly)
        for nid in [n for n in self.replicas if not self._node_alive(n)]:
            self._replica_dead(nid)
        for nid in [n for n in self.loans
                    if n not in self.replicas and not self._node_alive(n)]:
            self.on_node_killed(nid)
        for nid in [n for n in self.lent
                    if n not in self.replicas and not self._node_alive(n)]:
            self.on_node_killed(nid)

        backlog = self._backlog()
        self.peak_backlog = max(self.peak_backlog, backlog)
        if backlog:
            for shard in self.shards:   # lost-wakeup backstop
                self._pump(shard)
        if backlog:
            self._busy_t = now
        head = self.cluster.head
        batch_pressure = head is not None and head.alive and \
            bool(head.pending)

        # advance draining loans: inflight drained -> row goes back
        for nid in [n for n, lo in self.loans.items()
                    if lo["state"] == "draining"]:
            rep = self.replicas.get(nid)
            if rep is not None and rep.load() == 0:
                reclaim_s = now - self.loans[nid]["t_drain"]
                self.replicas.pop(nid)
                self.digest.pop(nid, None)
                for shard in self.shards:
                    shard.own.pop(nid, None)
                self.reserved.discard(nid)      # batch can place again
                self.loans.pop(nid)
                self.reclaims_total += 1
                self._reclaim_sum += reclaim_s
                self._reclaim_max = max(self._reclaim_max, reclaim_s)
                trace.rec(now, "loan_reclaimed", node=nid,
                          reclaim_s=round(reclaim_s, 4),
                          cold_start_s=self.cluster.params.boot_delay_s)

        # start a reclaim: batch pressure pulls the newest loan back
        # immediately; otherwise idle loans drain after the peak passes
        idle = (backlog == 0 and
                now - self._busy_t >= self.p.loan_reclaim_idle_s)
        if batch_pressure or idle or self.arrivals_done and backlog == 0:
            for nid in [n for n in reversed(self.loans)
                        if self.loans[n]["state"] == "active"]:
                rep = self.replicas.get(nid)
                if rep is None:
                    continue
                if idle or batch_pressure or rep.load() == 0:
                    rep.route_ok = False
                    self.loans[nid]["state"] = "draining"
                    self.loans[nid]["t_drain"] = now
                    trace.rec(now, "loan_reclaim_started", node=nid,
                              reason="batch_pressure" if batch_pressure
                              else "idle")
                    break       # gentle: one reclaim per tick

        # take a new loan: backlog over the bar and room under the cap
        want_loan = (backlog >= self.p.loan_backlog and
                     len(self.loans) < self.p.loan_max and
                     not self.arrivals_done)
        if not want_loan and self.outstanding and not self.replicas \
                and not self.loans:
            # rescue: every replica died and nothing is warming —
            # accepted work must still finish, so borrow regardless
            want_loan = True
        if want_loan:
            nid = self._pick_idle_batch_node()
            if nid is not None:
                self.reserved.add(nid)      # off the batch market NOW
                self.loans[nid] = {"state": "warming", "t0": now,
                                   "t_drain": 0.0}
                self.loans_total += 1
                trace.rec(now, "loan_started", node=nid,
                          backlog=backlog,
                          warmup_s=self.p.warmup_s)
                clock.call_later(self.p.warmup_s,
                                 lambda: self._loan_ready(nid))
        clock.call_later(self.p.tick_s, self._tick)

    def _pick_idle_batch_node(self) -> str | None:
        head = self.cluster.head
        if head is None or not head.alive:
            return None
        for nid in head._node_order:
            row = head.nodes.get(nid)
            if row is None or row["state"] != "alive" or row["suspect"]:
                continue
            if row["running"] or nid in self.reserved:
                continue
            if not self._node_alive(nid):
                continue
            return nid
        return None

    def _loan_ready(self, nid: str) -> None:
        loan = self.loans.get(nid)
        if loan is None or loan["state"] != "warming":
            return      # lost or reclaimed while warming
        if not self._node_alive(nid):
            self.on_node_killed(nid)
            return
        loan["state"] = "active"
        self.replicas[nid] = _Replica(nid, self.p.replica_cap,
                                      loaned=True)
        self.digest[nid] = 0
        if self.rollout is not None:
            # graft-on-pull: a late-joining replica adopts the
            # phase-appropriate model version
            self.rollout.on_replica_added(nid)
        self.cluster.trace.rec(
            self.cluster.clock.monotonic(), "loan_active", node=nid,
            warmup_s=self.p.warmup_s,
            cold_start_s=self.cluster.params.boot_delay_s)
        for shard in self.shards:
            self._pump(shard)

    # -- reverse loaning: the train plane borrows a serve replica node -------
    # Same Aryl drain-reclaim semantics as the forward direction, with
    # the roles swapped: serve is the lender, train the borrower.  The
    # lender keeps the row in ``reserved`` for the whole lend (batch
    # never places on it) and books a mid-lend death exactly once by
    # popping the record.

    def can_lend(self) -> bool:
        """True when serve is at the trough: low backlog, no forward
        loans outstanding, and at least two routable base replicas
        would remain after lending one out."""
        routable = [r for r in self.replicas.values()
                    if r.alive and r.route_ok and not r.loaned]
        return (self.started and not self.arrivals_done and
                len(routable) > 2 and not self.loans and
                self._backlog() < max(1, self.p.loan_backlog // 4))

    def begin_lend(self) -> str | None:
        """Stop routing to one idle base replica and start draining it
        toward the train plane.  Returns its nid, or None."""
        if not self.can_lend():
            return None
        now = self.cluster.clock.monotonic()
        for nid in sorted(self.replicas, reverse=True):
            rep = self.replicas[nid]
            if not rep.alive or not rep.route_ok or rep.loaned or \
                    nid in self.lent:
                continue
            rep.route_ok = False
            self.lent[nid] = {"state": "draining", "t0": now}
            self.lends_total += 1
            self.cluster.trace.rec(now, "reverse_lend_started",
                                   node=nid, backlog=self._backlog())
            return nid
        return None

    def lend_ready(self, nid: str) -> bool:
        """True once the draining replica emptied and the row was
        handed over (replica popped; the train plane owns the node
        until :meth:`end_lend` or death)."""
        lend = self.lent.get(nid)
        if lend is None:
            return False
        if lend["state"] == "lent":
            return True
        rep = self.replicas.get(nid)
        if rep is None or not self._node_alive(nid):
            return False
        if rep.load() != 0:
            return False
        self.replicas.pop(nid)
        self.digest.pop(nid, None)
        for shard in self.shards:
            shard.own.pop(nid, None)
        lend["state"] = "lent"
        self.cluster.trace.rec(self.cluster.clock.monotonic(),
                               "reverse_lend_active", node=nid)
        return True

    def wants_back(self) -> bool:
        """Serve pressure: when True the train plane must return every
        borrowed replica at its next epoch boundary (drain-reclaim, the
        mirror of batch_pressure in the forward direction)."""
        return self.arrivals_done or \
            self._backlog() >= max(1, self.p.loan_backlog // 2)

    def end_lend(self, nid: str) -> None:
        """Train hands the node back alive: the replica is re-created
        and routing resumes.  A no-op if death already popped the
        record (loss was booked there)."""
        lend = self.lent.pop(nid, None)
        if lend is None:
            return
        now = self.cluster.clock.monotonic()
        if not self._node_alive(nid):
            self.reserved.discard(nid)
            self.lends_lost += 1
            self.cluster.trace.rec(now, "reverse_lend_lost", node=nid,
                                   phase=lend["state"])
            return
        self.lends_returned += 1
        rep = self.replicas.get(nid)
        if rep is not None:
            rep.route_ok = True     # returned before the drain finished
        else:
            self.replicas[nid] = _Replica(nid, self.p.replica_cap)
            self.digest[nid] = 0
            if self.rollout is not None:
                self.rollout.on_replica_added(nid)
        self.cluster.trace.rec(now, "reverse_lend_returned", node=nid)
        for shard in self.shards:
            self._pump(shard)

    # -- aggregate trace window ----------------------------------------------
    def _window(self) -> None:
        if not self.cluster.running:
            return
        clock = self.cluster.clock
        w = self._win
        if w["accepted"] or w["completed"] or w["shed"] or self.loans:
            self.cluster.trace.rec(
                clock.monotonic(), "serve_window",
                accepted=w["accepted"], completed=w["completed"],
                shed=w["shed"], backlog=self._backlog(),
                loans=len(self.loans))
        self._win = {"accepted": 0, "completed": 0, "shed": 0}
        if not self.terminal:
            clock.call_later(self.p.window_s, self._window)

    # -- invariants ----------------------------------------------------------
    def check(self, strict: bool = False, now: float | None = None,
              grace: float = 10.0) -> tuple[list[str], int]:
        """Serve-plane invariants, called from
        :func:`sim.invariants.check_invariants`: accepted requests are
        never lost (counter vs structural sum), loans conserve
        (``loans_total == active + reclaimed + lost`` — a SIGKILL
        mid-reclaim must book the loss exactly once, never zero or
        twice), loan drains converge, and — strictly, after quiesce —
        everything accepted completed and every loan was reclaimed or
        booked lost."""
        from .invariants import fmt_violation

        violations: list[str] = []
        checks = 0
        if now is None:
            now = self.cluster.clock.monotonic()
        checks += 1
        accounted = sum(len(s.queue) for s in self.shards) + \
            self.in_route + \
            sum(r.load() for r in self.replicas.values())
        if accounted != self.outstanding:
            violations.append(fmt_violation(
                "serve-accounting", now,
                f"{self.outstanding} outstanding by counter, "
                f"{accounted} accounted in queues"))
        checks += 1
        if self.accepted != self.completed + self.outstanding:
            violations.append(fmt_violation(
                "serve-conservation", now,
                f"accepted={self.accepted} != "
                f"completed={self.completed} + "
                f"outstanding={self.outstanding}"))
        checks += 1
        if self.loans_total != (len(self.loans) + self.reclaims_total +
                                self.loans_lost):
            violations.append(fmt_violation(
                "loan-conservation", now,
                f"loans_total={self.loans_total} != "
                f"active={len(self.loans)} + "
                f"reclaimed={self.reclaims_total} + "
                f"lost={self.loans_lost}"))
        checks += 1
        if self.lends_total != (len(self.lent) + self.lends_returned +
                                self.lends_lost):
            violations.append(fmt_violation(
                "loan-conservation", now,
                f"reverse lends_total={self.lends_total} != "
                f"lent={len(self.lent)} + "
                f"returned={self.lends_returned} + "
                f"lost={self.lends_lost}"))
        drain_cap = self.cluster.params.drain_deadline_s + grace
        for nid, loan in self.loans.items():
            if loan["state"] != "draining":
                continue
            checks += 1
            if now - loan["t_drain"] > drain_cap and \
                    self._node_alive(nid):
                violations.append(fmt_violation(
                    "loan-drain-stuck", now,
                    f"{nid} draining for "
                    f"{now - loan['t_drain']:.1f}s"))
        if strict:
            checks += 2
            if self.outstanding:
                violations.append(fmt_violation(
                    "serve-incomplete", now,
                    f"{self.outstanding} accepted requests never "
                    f"completed after quiesce"))
            if self.loans or self.lent:
                violations.append(fmt_violation(
                    "loans-outstanding", now,
                    f"{len(self.loans)} loans / {len(self.lent)} "
                    f"reverse lends neither reclaimed nor booked lost "
                    f"after quiesce"))
        return violations, checks

    # -- reporting -----------------------------------------------------------
    def _quantile(self, q: float) -> float:
        total = sum(self._hist)
        if not total:
            return 0.0
        target = q * total
        acc = 0
        for k, cnt in enumerate(self._hist):
            acc += cnt
            if acc >= target:
                return _LAT_EDGES[k] if k < len(_LAT_EDGES) else \
                    _LAT_EDGES[-1] * 2
        return _LAT_EDGES[-1] * 2

    def stats(self) -> dict:
        return {
            "shards": len(self.shards),
            "replicas": len(self.replicas),
            "pool_capacity_rps": round(self.pool_capacity_rps, 1),
            "accepted": self.accepted,
            "completed": self.completed,
            "shed": self.shed,
            "redispatched": self.redispatched,
            "outstanding": self.outstanding,
            "p50_s": self._quantile(0.50),
            "p99_s": self._quantile(0.99),
            "peak_backlog": self.peak_backlog,
            "loans_total": self.loans_total,
            "reclaims_total": self.reclaims_total,
            "loans_lost": self.loans_lost,
            "lends_total": self.lends_total,
            "lends_returned": self.lends_returned,
            "lends_lost": self.lends_lost,
            "mean_reclaim_s": round(
                self._reclaim_sum / self.reclaims_total, 4)
            if self.reclaims_total else 0.0,
            "max_reclaim_s": round(self._reclaim_max, 4),
            "cold_start_s": self.cluster.params.boot_delay_s,
        }

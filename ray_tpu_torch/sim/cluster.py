"""Simulated control plane: head, nodes and autoscaler as discrete-event
state machines.

These are the *control* state machines of the real runtime — register/
heartbeat/death declaration (``runtime/health.py``), lease grant and
lost-ack requeue (``runtime/raylet.py``), the breaker→quarantine→
soft-avoid chain (``rpc/breaker.py`` + ``runtime/health.py`` +
scheduler), drain convergence (``cluster_utils.drain_node``), snapshot
persistence and head failover (``runtime/head.py``), lineage
reconstruction (``runtime/recovery.py``) and the autoscaler sizing loop
— re-expressed over the ``Clock``/``Transport`` seams so 10k of them
run in one process.  Where the real modules have a reusable primitive
(``PeerBreaker``, the chaos plane's Philox link streams), the simulator
uses the real class, on virtual time.

Determinism contract: single-threaded, virtual clock, all randomness
from Philox (the chaos instance plus the campaign's own generator), no
iteration over unordered sets.  The same seed replays the same trace,
byte for byte.
"""

from __future__ import annotations

import hashlib
import json
from collections import deque
from dataclasses import dataclass

from ..common.clock import VirtualClock
from ..common.config import get_config
from ..leasing import LeaseGrantor, LocalLeaseCache
from ..rpc.breaker import CLOSED, OPEN, PeerBreaker
from ..rpc.chaos import _Chaos
from ..rpc.client import RpcConnectionError
from .transport import SimTransport

__all__ = ["SimCluster", "SimParams", "SimHead", "SimNode",
           "SimStandby", "SimAutoscaler", "Trace", "ALIVE", "DRAINING",
           "DEAD", "REMOVED"]

ALIVE, DRAINING, DEAD, REMOVED = "alive", "draining", "dead", "removed"
HEAD_ADDR = "sim://head"
STANDBY_ADDR = "sim://standby"

_TRACE_EVENT_CAP = 20000        # stored events; the hash covers ALL

# Modeled head service cost per RPC, in deterministic virtual
# microseconds: the dispatch-throughput denominator.  A scheduling RPC
# (grant, submit, done, spillback) runs the placement machinery +
# serialization; an origin-routed batch forward is a route-table lookup
# plus a send — no placement solve; a heartbeat (and a leased-row TTL
# refresh) is a row-timestamp touch, two orders cheaper; batched ops
# pay a small marginal per item.  The ratio of lease-plane to head-only
# throughput is a pure function of these constants and the RPC counts —
# replay-stable by construction.
_HEAD_RPC_US = 100.0            # full scheduling-path RPC
_HEAD_ROUTE_US = 20.0           # origin-routed forward (no placement)
_HEAD_TOUCH_US = 1.0            # heartbeat / lease-row liveness touch
_HEAD_ITEM_US = 5.0             # marginal cost per batched item


def _row_reserved(cluster, nid: str) -> bool:
    """A row held by an overlay plane (serve replica, loaned-out row,
    or a training-gang member) is off the batch market: the scheduler
    never places on it, the lease plane prices it at zero headroom and
    the autoscaler neither counts it as slack nor idle-drains it."""
    plane = cluster.serve_plane
    if plane is not None and nid in plane.reserved:
        return True
    tplane = cluster.train_plane
    return tplane is not None and nid in tplane.reserved


class Trace:
    """Append-only campaign trace with an incremental sha256 over the
    canonical JSON of every event — the replay fingerprint.  Storage is
    capped (artifacts stay small at 10k nodes); the hash is not.

    ``cov`` is an optional coverage sink (``sim/hunt.py``'s
    ``RunCoverage``): when attached it sees every event — including the
    ones past the storage cap — but never feeds the hash, so attaching
    it cannot perturb replay fingerprints."""

    def __init__(self):
        self.events: list[dict] = []
        self.total = 0
        self._h = hashlib.sha256()
        self.cov = None

    def rec(self, t: float, kind: str, **fields) -> None:
        ev = {"t": round(t, 6), "kind": kind}
        ev.update(fields)
        self._h.update(json.dumps(
            ev, sort_keys=True, separators=(",", ":")).encode())
        self._h.update(b"\n")
        self.total += 1
        if len(self.events) < _TRACE_EVENT_CAP:
            self.events.append(ev)
        if self.cov is not None:
            self.cov.note(ev)

    def hash(self) -> str:
        return self._h.hexdigest()


@dataclass
class SimParams:
    """Timing/shape knobs, defaulted from the ``sim_*`` config knobs."""

    heartbeat_period_s: float = 5.0
    miss_threshold: int = 3
    lease_timeout_s: float = 20.0
    drain_deadline_s: float = 45.0
    node_capacity: int = 4
    boot_delay_s: float = 3.0
    autoscaler_interval_s: float = 5.0
    autoscaler_idle_timeout_s: float = 60.0
    # lease plane + hot standby (r15); both default off so pre-r15
    # campaign trace hashes replay unchanged
    lease_plane: bool = False
    lease_overcommit: float = 2.0
    lease_max_classes: int = 64
    # floor on the per-class budget the sim head carves (the
    # lease_budget_min knob's sim twin); 0 = no floor, the pre-r17
    # capacity x overcommit sizing — the dataclass default keeps
    # directly-constructed campaigns (dispatch_bench, hunts) replaying
    # their recorded trace hashes unchanged
    lease_budget_min: int = 0
    standby: bool = False
    standby_quorum: float = 0.34
    # planted canary bug (r16, default off): the hunt's CI smoke and
    # bench arm it to prove the adversarial search can find and
    # minimize a real injected defect — with it on, a node death while
    # ANY partition is active "loses" the dead node's running tasks
    # (they are never requeued), so the strict final check fires
    canary: bool = False

    @classmethod
    def from_config(cls) -> "SimParams":
        cfg = get_config()
        return cls(
            heartbeat_period_s=cfg.sim_heartbeat_period_s,
            miss_threshold=cfg.sim_heartbeat_miss_threshold,
            lease_timeout_s=cfg.sim_lease_timeout_s,
            drain_deadline_s=cfg.sim_drain_deadline_s,
            node_capacity=cfg.sim_node_capacity,
            boot_delay_s=cfg.sim_boot_delay_s,
            lease_plane=cfg.sim_lease_plane,
            lease_overcommit=cfg.lease_overcommit,
            lease_max_classes=cfg.lease_max_classes,
            lease_budget_min=cfg.lease_budget_min,
            standby=cfg.sim_standby,
            standby_quorum=cfg.standby_quorum,
        )

    @property
    def fence_horizon_s(self) -> float:
        """How long a node may go without confirmed head contact before
        it stops granting locally — the same horizon after which the
        head declares it dead, so self-fencing always precedes a
        death-driven revocation."""
        return self.heartbeat_period_s * self.miss_threshold


class SimNode:
    """One simulated node agent: heartbeat loop, lease execution with
    idempotent re-grant handling, ack retry, drain participation — and,
    with the lease plane on, a :class:`LocalLeaseCache` that admits
    batched submissions locally, spills misses back to the head, and
    self-fences when head contact is lost."""

    def __init__(self, cluster: "SimCluster", nid: str):
        self.cluster = cluster
        self.nid = nid
        self.address = f"sim://{nid}"
        self.clock = cluster.clock
        self.params = cluster.params
        self.alive = True
        self.registered = False
        self.draining = False
        self.running: dict[str, float] = {}     # tid -> started (virtual)
        self.classes: dict[str, str] = {}       # tid -> class (lease path)
        self.local_queue: deque = deque()       # (tid, duration, class)
        self.done: dict[str, str] = {}          # tid -> oid (ack cache)
        self.done_buffer: list = []             # (tid, oid) awaiting flush
        self.holds: dict[str, bool] = {}        # oid -> True
        self.lease: LocalLeaseCache | None = None
        if self.params.lease_plane:
            self.lease = LocalLeaseCache(
                capacity=self.params.node_capacity,
                fence_after_s=self.params.fence_horizon_s,
                overcommit=self.params.lease_overcommit,
                max_classes=self.params.lease_max_classes)
        handlers = {"exec": self._h_exec, "drain": self._h_drain,
                    "ping": self._h_ping}
        if self.params.lease_plane:
            handlers["submit_batch"] = self._h_submit_batch
        self.server = cluster.transport.serve(
            handlers, host=self.address).start()
        self.head = cluster.transport.connect(HEAD_ADDR,
                                              _sim_src=self.address)
        self._standby = None

    def start(self, stagger: float = 0.0) -> None:
        self.clock.call_later(stagger, self._beat)

    # -- heartbeat / (re-)register loop --------------------------------------
    def _beat(self) -> None:
        if not self.alive:
            return
        try:
            if not self.registered:
                reply = self.head.call("register", self.nid,
                                       self.address, self._report())
                self.registered = True
                self._fold_head_reply(reply)
            else:
                payload = self._hb_payload()
                reply = self.head.call("heartbeat", self.nid, payload)
                if reply == "reregister" or (
                        isinstance(reply, dict) and
                        reply.get("op") == "reregister"):
                    # restarted head lost our row: rejoin with state
                    self.registered = False
                    reply = self.head.call("register", self.nid,
                                           self.address, self._report())
                    self.registered = True
                self._fold_head_reply(reply)
                if payload is not None:
                    # the head folded the piggybacked done acks
                    del self.done_buffer[:len(payload["done"])]
        except RpcConnectionError:
            self._vote()        # head down/partitioned: keep beating
        self.clock.call_later(self.params.heartbeat_period_s, self._beat)

    def _report(self) -> dict:
        report = {"running": list(self.running), "done": dict(self.done),
                  "holds": list(self.holds), "draining": self.draining}
        if self.lease is not None:
            # promotion rejoin: the promoted head re-adopts our leases
            # (grant authority stayed here) and our locally-queued work
            report["lease_epoch"] = self.lease.epoch
            report["lease_classes"] = self.lease.held_classes()
            report["leased_queued"] = [tid for tid, _d, _c
                                       in self.local_queue]
        return report

    def _hb_payload(self) -> dict | None:
        if self.lease is None:
            return None
        return {"done": list(self.done_buffer),
                "leased": list(self.running) +
                [tid for tid, _d, _c in self.local_queue]}

    def _fold_head_reply(self, reply) -> None:
        """Confirmed head contact: refresh the fence clock and fold the
        lease epoch + any fresh grants the head piggybacked."""
        if self.lease is None:
            return
        now = self.clock.monotonic()
        self.lease.on_head_contact(now)
        if not isinstance(reply, dict):
            return
        if self.lease.observe_epoch(reply.get("epoch", 0)):
            self._discard_queue("epoch_revoked")
        grants = reply.get("grants")
        if grants:
            self.lease.install(grants, reply.get("epoch", 0))

    def _discard_queue(self, reason: str) -> None:
        """The head revoked our epoch: it already requeued everything
        we had locally admitted but not started — drop it, never start
        a task under a dead epoch."""
        if self.local_queue:
            self.cluster.trace.rec(
                self.clock.monotonic(), "lease_queue_discard",
                node=self.nid, dropped=len(self.local_queue),
                reason=reason)
            self.local_queue.clear()

    def _vote(self) -> None:
        """Head unreachable: vote for standby promotion (quorum is the
        standby's promotion gate; a partitioned minority never wins)."""
        if not self.params.standby:
            return
        if self._standby is None:
            self._standby = self.cluster.transport.connect(
                STANDBY_ADDR, _sim_src=self.address)
        try:
            self._standby.call("vote", self.nid)
        except RpcConnectionError:
            pass

    # -- handlers ------------------------------------------------------------
    def _h_ping(self) -> str:
        return "pong"

    def _h_exec(self, tid: str, duration: float):
        if tid in self.done:
            # late re-grant of finished work: answer from the ack cache
            return {"op": "done", "oid": self.done[tid]}
        if tid in self.running:
            return {"op": "running"}        # dup delivery: idempotent
        if self.draining:
            return {"op": "rejected"}
        self._start(tid, duration, epoch=-1)
        return {"op": "accepted"}

    def _h_submit_batch(self, tasks: list, epoch: int, grants: dict):
        """One framed multi-submit from the head's origin routing:
        admit locally against the leased budgets, spill the rest.
        ``tasks`` is ``[(tid, duration, class_key), ...]``."""
        lease = self.lease
        now = self.clock.monotonic()
        if self.lease.observe_epoch(epoch):
            self._discard_queue("epoch_revoked")
        lease.install(grants, epoch)
        lease.on_head_contact(now)      # the head just reached us
        accepted, spilled = [], []
        for tid, duration, class_key in tasks:
            if tid in self.done:
                accepted.append(tid)    # idempotent re-submit
                continue
            if tid in self.running or any(t == tid for t, _d, _c
                                          in self.local_queue):
                accepted.append(tid)
                continue
            if self.draining or not lease.try_grant(class_key, now):
                spilled.append(tid)
                continue
            self.classes[tid] = class_key
            self.local_queue.append((tid, duration, class_key))
            accepted.append(tid)
        self.cluster.leasing["local_grants"] += len(accepted)
        self.cluster.leasing["spillbacks"] += len(spilled)
        self._pump_local()
        return {"accepted": accepted, "spilled": spilled}

    def _pump_local(self) -> None:
        """Start locally-admitted tasks while run slots are free — but
        never while fenced (head contact lost past the horizon: our
        epoch may already be revoked)."""
        now = self.clock.monotonic()
        while self.local_queue and \
                len(self.running) < self.params.node_capacity:
            if self.lease.fenced(now):
                return      # resume after the next confirmed contact
            tid, duration, _class_key = self.local_queue.popleft()
            self._start(tid, duration, epoch=self.lease.epoch)

    def _start(self, tid: str, duration: float, epoch: int) -> None:
        self.running[tid] = self.clock.monotonic()
        if self.params.lease_plane:
            # the no-double-execution invariant audits this log
            self.cluster.exec_log.append(
                (tid, self.nid, epoch, self.clock.monotonic()))
        self.clock.call_later(duration, lambda: self._complete(tid))

    def _h_drain(self) -> str:
        self.draining = True
        self._discard_queue("drain")
        if not self.running:
            self._drain_done(0)
        return "ok"

    # -- completion / ack ----------------------------------------------------
    def _complete(self, tid: str) -> None:
        if not self.alive or tid not in self.running:
            return
        del self.running[tid]
        oid = "o:" + tid
        self.done[tid] = oid
        if len(self.done) > 512:            # bounded idempotency window
            self.done.pop(next(iter(self.done)))
        self.holds[oid] = True
        class_key = self.classes.pop(tid, None)
        if class_key is not None and self.lease is not None:
            self.lease.release(class_key)
        if self.lease is not None:
            # batched ack: piggybacks on the next heartbeat, with an
            # early flush so a hot node's tail never waits a period
            self.done_buffer.append((tid, oid))
            if len(self.done_buffer) >= 32:
                self._flush_done()
            self._pump_local()
        else:
            self._ack(tid, oid, 0)
        if self.draining and not self.running and not self.local_queue:
            self._drain_done(0)

    def _flush_done(self) -> None:
        if not self.done_buffer:
            return
        batch = list(self.done_buffer)
        try:
            self.head.call("task_done_batch", self.nid, batch)
            del self.done_buffer[:len(batch)]
            self.lease.on_head_contact(self.clock.monotonic())
        except RpcConnectionError:
            self._vote()    # heartbeat retry still holds the buffer

    def _ack(self, tid: str, oid: str, attempt: int) -> None:
        if not self.alive:
            return
        try:
            self.head.call("task_done", self.nid, tid, oid)
            if self.lease is not None:
                self.lease.on_head_contact(self.clock.monotonic())
        except RpcConnectionError:
            self._vote()
            self.clock.call_later(min(8.0, 1.0 + attempt),
                                  lambda: self._ack(tid, oid, attempt + 1))

    def _drain_done(self, attempt: int) -> None:
        if not self.alive or not self.draining or self.running:
            return
        if self.lease is not None:
            self._flush_done()      # never strand buffered acks at exit
        try:
            self.head.call("drain_done", self.nid)
        except RpcConnectionError:
            self.clock.call_later(min(8.0, 1.0 + attempt),
                                  lambda: self._drain_done(attempt + 1))
            return
        # drained and acknowledged: this node's process exits
        self.alive = False
        self.cluster.transport.kill(self.address)
        self.cluster.node_stopped(self.nid)


class SimHead:
    """The simulated head: node table, job/lease tables, snapshot-backed
    persistence (survives kill), death declaration, lost-ack lease
    requeue, drain convergence, breaker-driven quarantine with
    soft-avoid scheduling, and lineage reconstruction."""

    def __init__(self, cluster: "SimCluster"):
        self.cluster = cluster
        self.clock = cluster.clock
        self.params = cluster.params
        self.trace = cluster.trace
        self.persist = cluster.persist      # survives head kill
        self.alive = True
        self.nodes: dict[str, dict] = {}
        self._node_order: list[str] = []
        self._rr = 0
        self.jobs: dict[str, dict] = {}
        self.tasks: dict[str, dict] = {}
        self.objects: dict[str, dict] = {}  # oid -> {producer, copies}
        self.pending: deque[str] = deque()
        self.breakers: dict[str, PeerBreaker] = {}
        self._clients: dict[str, object] = {}
        self.grantor: LeaseGrantor | None = None
        if self.params.lease_plane:
            # revocation epochs journal into the persist dict, so the
            # promoted head never re-issues a revoked epoch
            journal = self.persist.setdefault("lease_epochs", {})

            def _journal(node: str, epoch: int) -> None:
                journal[node] = epoch

            # per-class budgets cover the node's full overcommit bound:
            # a single-class wave (the common repeat-class shape) can
            # fill a node without artificial per-class throttling — the
            # raylet's admitted_total cap enforces the real limit
            self.grantor = LeaseGrantor(
                budget_per_class=max(
                    int(self.params.node_capacity *
                        self.params.lease_overcommit),
                    self.params.lease_budget_min),
                max_classes=self.params.lease_max_classes,
                journal=_journal)
        handlers = {
            "register": self._h_register, "heartbeat": self._h_heartbeat,
            "job_submit": self._h_job_submit, "task_done": self._h_task_done,
            "drain_done": self._h_drain_done, "ping": self._h_ping,
            "status": self._h_status}
        if self.params.lease_plane:
            handlers["spillback"] = self._h_spillback
            handlers["task_done_batch"] = self._h_task_done_batch
        self.server = cluster.transport.serve(
            handlers, host=HEAD_ADDR).start()
        self._restore()
        self.clock.call_later(self.params.heartbeat_period_s,
                              self._monitor)

    def _busy(self, us: float, dispatch: bool = True) -> None:
        """Accrue modeled head service time.  ``dispatch=False`` marks
        pure liveness work (heartbeat row touches) — identical in both
        dispatch modes, so the throughput denominator excludes it and
        the comparison measures what the lease plane actually moves."""
        self.cluster.head_busy_us += us
        if dispatch:
            self.cluster.head_dispatch_us += us

    def _note_dispatch(self) -> None:
        """First dispatch after a head kill closes the failover window."""
        cl = self.cluster
        if cl.last_head_kill_t is not None:
            ms = round((self.clock.monotonic() - cl.last_head_kill_t)
                       * 1000.0, 3)
            cl.failover_ms.append(ms)
            cl.last_head_kill_t = None
            self.trace.rec(self.clock.monotonic(),
                           "failover_first_dispatch", ms=ms)

    # -- persistence ---------------------------------------------------------
    def _restore(self) -> None:
        restored = 0
        if self.grantor is not None:
            self.grantor.restore(self.persist.get("lease_epochs", {}))
        for jid, spec in self.persist["jobs"].items():
            tids = list(spec["tasks"])
            self.jobs[jid] = {"tasks": tids, "status": "running"}
            for tid in tids:
                done_oid = self.persist["done"].get(tid)
                t = {"job": jid, "duration": spec["tasks"][tid],
                     "state": "pending", "node": None, "granted_at": 0.0,
                     "attempts": 0, "oid": None}
                if done_oid is not None:
                    t["state"] = "done"
                    t["oid"] = done_oid
                    self.objects.setdefault(
                        done_oid, {"producer": tid, "copies": {}})
                else:
                    self.pending.append(tid)
                self.tasks[tid] = t
            self._refresh_job(jid)
            restored += 1
        if restored:
            self.trace.rec(self.clock.monotonic(), "head_restore",
                           jobs=restored, pending=len(self.pending))

    # -- handlers ------------------------------------------------------------
    def _h_ping(self) -> str:
        return "pong"

    def _h_register(self, nid: str, address: str, report: dict):
        # membership bootstrap, not dispatch: identical in both
        # dispatch modes, so it stays out of the throughput denominator
        self._busy(_HEAD_RPC_US, dispatch=False)
        now = self.clock.monotonic()
        known = nid in self.nodes
        self.nodes[nid] = {
            "address": address, "state": ALIVE, "last_hb": now,
            "suspect": False, "running": {}, "drain_started": None,
            "idle_since": now, "leased": {},
        }
        if not known:
            self._node_order.append(nid)
        row = self.nodes[nid]
        if report.get("draining"):
            row["state"] = DRAINING
            row["drain_started"] = now
        for tid, oid in report.get("done", {}).items():
            self._mark_done(tid, oid, nid)
        for oid in report.get("holds", ()):
            obj = self.objects.get(oid)
            if obj is not None:
                obj["copies"][nid] = True
        for tid in report.get("running", ()):
            t = self.tasks.get(tid)
            if t is not None and t["state"] != "done":
                t["state"] = "running"
                t["node"] = nid
                t["granted_at"] = now
                row["running"][tid] = True
        if self.grantor is not None:
            # promotion rejoin: grant authority stayed at the raylet —
            # re-adopt its lease set when its epoch is still current
            # (the journal survived the kill), else force a discard
            epoch = self.grantor.epoch(nid)
            if report.get("lease_epoch", 0) == epoch:
                for class_key in report.get("lease_classes", ()):
                    self.grantor.grant(nid, class_key)
                for tid in report.get("leased_queued", ()):
                    t = self.tasks.get(tid)
                    if t is not None and t["state"] in ("pending",
                                                       "leased"):
                        if t["state"] == "pending":
                            try:
                                self.pending.remove(tid)
                            except ValueError:
                                pass
                        t["state"] = "leased"
                        t["node"] = nid
                        t["granted_at"] = now
                        row["leased"][tid] = now
            self._schedule()
            epoch, grants = self.grantor.snapshot_for(nid)
            return {"op": "ok", "epoch": epoch, "grants": grants}
        self._schedule()
        return "ok"

    def _h_heartbeat(self, nid: str, payload: dict | None = None):
        self._busy(_HEAD_TOUCH_US, dispatch=False)
        row = self.nodes.get(nid)
        if row is None or row["state"] in (DEAD, REMOVED):
            if self.grantor is not None:
                return {"op": "reregister"}
            return "reregister"
        now = self.clock.monotonic()
        row["last_hb"] = now
        # serve-plane piggyback: the load digest for this node's replica
        # folds on the heartbeat that carries its liveness — the same
        # no-extra-RPC contract as the live gossip board
        plane = self.cluster.serve_plane
        if plane is not None:
            plane.on_heartbeat(nid)
        if self.grantor is None:
            return "ok"
        if payload is not None:
            self._busy(_HEAD_ITEM_US * len(payload.get("done", ())))
            self._busy(_HEAD_TOUCH_US * len(payload.get("leased", ())),
                       dispatch=False)
            for tid, oid in payload.get("done", ()):
                self._mark_done(tid, oid, nid)
            # a reported leased task is alive at its raylet: refresh it
            # so the TTL sweep only revokes genuinely quiet grants
            for tid in payload.get("leased", ()):
                if tid in row["leased"]:
                    row["leased"][tid] = now
            if payload.get("done"):
                self._schedule()
        return {"op": "ok", "epoch": self.grantor.epoch(nid),
                "grants": None}

    def _class_key(self, duration: float) -> str:
        """Scheduling class of a simulated task.  Durations stand in
        for the interned resource-request vector: tasks of one class
        are shaped alike, which is exactly what makes repeat
        submissions lease-servable."""
        return f"c{duration:g}"

    def _h_job_submit(self, jid: str, tasks: dict) -> str:
        self._busy(_HEAD_RPC_US + _HEAD_ITEM_US * len(tasks))
        if jid not in self.persist["jobs"]:
            # persist BEFORE acking: an acked job survives a head kill
            self.persist["jobs"][jid] = {"tasks": dict(tasks)}
            self.jobs[jid] = {"tasks": list(tasks), "status": "running"}
            for tid, duration in tasks.items():
                self.tasks[tid] = {
                    "job": jid, "duration": duration, "state": "pending",
                    "node": None, "granted_at": 0.0, "attempts": 0,
                    "oid": None}
                self.pending.append(tid)
            self.trace.rec(self.clock.monotonic(), "job_submit", job=jid,
                           tasks=len(tasks))
        self._schedule()
        return "ack"

    def _h_task_done(self, nid: str, tid: str, oid: str) -> str:
        self._busy(_HEAD_RPC_US)
        self._mark_done(tid, oid, nid)
        self._schedule()
        return "ok"

    def _h_task_done_batch(self, nid: str, items: list) -> str:
        self._busy(_HEAD_RPC_US + _HEAD_ITEM_US * len(items))
        for tid, oid in items:
            self._mark_done(tid, oid, nid)
        self._schedule()
        return "ok"

    def _h_spillback(self, nid: str, tids: list) -> str:
        """A raylet handed leased tasks back (budget exhausted, fenced,
        or stale epoch): the head reschedules them globally."""
        self._busy(_HEAD_RPC_US + _HEAD_ITEM_US * len(tids))
        self._repend(nid, tids)
        self._schedule()
        return "ok"

    def _repend(self, nid: str, tids) -> int:
        row = self.nodes.get(nid)
        n = 0
        for tid in tids:
            t = self.tasks.get(tid)
            if t is None or t["state"] not in ("leased", "running"):
                continue
            t["state"] = "pending"
            t["node"] = None
            self.pending.append(tid)
            n += 1
            if row is not None:
                row["leased"].pop(tid, None)
                row["running"].pop(tid, None)
        return n

    def _h_drain_done(self, nid: str) -> str:
        row = self.nodes.get(nid)
        if row is not None and row["state"] == DRAINING:
            self._remove_node(nid, "drained")
        return "ok"

    def _h_status(self) -> dict:
        states: dict[str, int] = {}
        for nid in self._node_order:
            row = self.nodes.get(nid)
            if row is not None:
                states[row["state"]] = states.get(row["state"], 0) + 1
        return {"nodes": states, "jobs": len(self.jobs),
                "pending": len(self.pending)}

    # -- bookkeeping ---------------------------------------------------------
    def _mark_done(self, tid: str, oid: str, nid: str) -> None:
        t = self.tasks.get(tid)
        if t is None:
            return
        # fence late acks from nodes the head already wrote off: the
        # task was requeued when the node was declared dead/removed,
        # and registering a copy on such a row would plant a phantom
        # replica (the gray-window twin of the drain-path leak the r16
        # hunt found).  The retry completes the task with a live copy.
        nrow = self.nodes.get(nid)
        if nrow is None or nrow["state"] in (DEAD, REMOVED):
            return
        prev = t["node"]
        if prev is not None:
            prow = self.nodes.get(prev)
            if prow is not None:
                prow["running"].pop(tid, None)
                prow["leased"].pop(tid, None)
                if not prow["running"]:
                    prow["idle_since"] = self.clock.monotonic()
        nrow["running"].pop(tid, None)
        nrow["leased"].pop(tid, None)
        if not nrow["running"]:
            nrow["idle_since"] = self.clock.monotonic()
        obj = self.objects.setdefault(oid,
                                      {"producer": tid, "copies": {}})
        obj["copies"][nid] = True
        if t["state"] != "done":
            t["state"] = "done"
            t["node"] = None
            t["oid"] = oid
            self.persist["done"][tid] = oid
            self._refresh_job(t["job"])

    def _refresh_job(self, jid: str) -> None:
        job = self.jobs.get(jid)
        if job is None or job["status"] == "succeeded":
            return
        if all(self.tasks[tid]["state"] == "done"
               for tid in job["tasks"]):
            job["status"] = "succeeded"
            self.trace.rec(self.clock.monotonic(), "job_complete",
                           job=jid)

    def _breaker(self, addr: str) -> PeerBreaker:
        b = self.breakers.get(addr)
        if b is None:
            cfg = get_config()
            b = self.breakers[addr] = PeerBreaker(
                addr, cfg.rpc_breaker_failure_threshold,
                cfg.rpc_breaker_reset_s)
        return b

    def _client(self, nid: str):
        c = self._clients.get(nid)
        if c is None:
            c = self._clients[nid] = self.cluster.transport.connect(
                self.nodes[nid]["address"], _sim_src=HEAD_ADDR)
        return c

    def _after_breaker(self, nid: str, b: PeerBreaker) -> None:
        """The quarantine chain: OPEN breaker -> suspect (scheduler
        soft-avoids), CLOSED again -> unquarantined."""
        row = self.nodes.get(nid)
        if row is None:
            return
        if b.state == OPEN and not row["suspect"]:
            row["suspect"] = True
            self.trace.rec(self.clock.monotonic(), "quarantine",
                           node=nid, opens=b.opens)
        elif b.state == CLOSED and row["suspect"]:
            row["suspect"] = False
            self.trace.rec(self.clock.monotonic(), "unquarantine",
                           node=nid)

    # -- scheduling ----------------------------------------------------------
    def _pick_node(self) -> str | None:
        for allow_suspect in (False, True):     # soft-avoid: two passes
            n = len(self._node_order)
            for off in range(n):
                nid = self._node_order[(self._rr + off) % n]
                row = self.nodes.get(nid)
                if row is None or row["state"] != ALIVE:
                    continue
                if _row_reserved(self.cluster, nid):
                    continue    # serve replica, gang member or LOANED
                if row["suspect"] and not allow_suspect:
                    continue
                if len(row["running"]) + len(row["leased"]) >= \
                        self.params.node_capacity:
                    continue
                if row["suspect"] and \
                        not self._breaker(row["address"]).allow():
                    continue        # open breaker: hard fail-fast
                self._rr = (self._rr + off + 1) % n
                return nid
        return None

    def _schedule(self) -> None:
        if not self.alive:
            return
        if self.grantor is not None:
            self._schedule_lease()
            return
        for _ in range(len(self.pending)):
            if not self.pending:
                break
            tid = self.pending.popleft()
            t = self.tasks.get(tid)
            if t is None or t["state"] != "pending":
                continue
            nid = self._pick_node()
            if nid is None:
                self.pending.appendleft(tid)
                break
            self._grant(tid, nid)

    # -- lease-plane dispatch ------------------------------------------------
    def _lease_headroom(self, nid: str) -> int:
        """How many more tasks the head will route at ``nid`` — mirrors
        the raylet's own overcommit admission bound, so routed batches
        rarely spill."""
        row = self.nodes.get(nid)
        if row is None or row["state"] != ALIVE or row["suspect"]:
            return 0
        if _row_reserved(self.cluster, nid):
            return 0
        cap = int(self.params.node_capacity *
                  self.params.lease_overcommit)
        return cap - len(row["running"]) - len(row["leased"])

    def _lease_class_headroom(self, nid: str, class_key: str) -> int:
        """Headroom for one class at one node: the overall overcommit
        bound AND the per-class budget the raylet enforces.  Mirroring
        both means routed batches are admitted, not spilled — the
        head's view of in-flight leases only ever lags toward fewer
        routes, never more."""
        room = self._lease_headroom(nid)
        if room <= 0:
            return 0
        row = self.nodes[nid]
        inflight = 0
        for tid in row["leased"]:
            t = self.tasks.get(tid)
            if t is not None and \
                    self._class_key(t["duration"]) == class_key:
                inflight += 1
        return min(room, self.grantor.budget_per_class - inflight)

    def _schedule_lease(self) -> None:
        """Origin routing: group pending tasks by scheduling class and
        send each group to a node already holding that class's lease
        (one framed multi-submit per origin).  First-of-class falls back
        to global placement and the grant rides the same batch, so the
        admission itself is a local grant at the raylet."""
        by_class: dict[str, list[str]] = {}
        order: list[str] = []
        for _ in range(len(self.pending)):
            tid = self.pending.popleft()
            t = self.tasks.get(tid)
            if t is None or t["state"] != "pending":
                continue
            ck = self._class_key(t["duration"])
            if ck not in by_class:
                by_class[ck] = []
                order.append(ck)
            by_class[ck].append(tid)
        for ck in order:
            tids = by_class[ck]
            while tids:
                origin = self.grantor.origin_for(
                    ck, eligible=lambda nid:
                    self._lease_class_headroom(nid, ck) > 0)
                if origin is None:
                    origin = self._pick_node()
                    if origin is None:
                        # no capacity anywhere: back on the queue
                        for tid in tids:
                            self.pending.append(tid)
                        break
                    self.grantor.grant(origin, ck)
                tids = self._submit_batch(origin, ck, tids)

    def _submit_batch(self, nid: str, class_key: str,
                      tids: list) -> list:
        """One multi-submit to ``nid`` covering its headroom; returns
        the tids still to place (the rest of the class group)."""
        row = self.nodes[nid]
        take = min(len(tids),
                   max(1, self._lease_class_headroom(nid, class_key)))
        batch_tids, rest = tids[:take], tids[take:]
        batch = [(tid, self.tasks[tid]["duration"], class_key)
                 for tid in batch_tids]
        epoch, grants = self.grantor.snapshot_for(nid)
        b = self._breaker(row["address"])
        self._busy(_HEAD_ROUTE_US + _HEAD_ITEM_US * len(batch))
        try:
            reply = self._client(nid).call("submit_batch", batch,
                                           epoch, grants)
        except RpcConnectionError:
            b.record_failure()
            self._after_breaker(nid, b)
            for tid in batch_tids:
                self.pending.append(tid)
            return rest
        b.record_success()
        self._after_breaker(nid, b)
        now = self.clock.monotonic()
        accepted = set(reply.get("accepted", ()))
        for tid in batch_tids:
            t = self.tasks.get(tid)
            if t is None or t["state"] != "pending":
                continue
            if tid in accepted:
                t["state"] = "leased"
                t["node"] = nid
                t["granted_at"] = now
                t["attempts"] += 1
                row["leased"][tid] = now
            else:
                # spillback: the raylet refused (budget, fence, drain);
                # the head stays the single source of truth and will
                # re-route on the next scheduling pass
                self.pending.append(tid)
        if accepted:
            self._note_dispatch()
        return rest

    def _grant(self, tid: str, nid: str) -> None:
        self._busy(_HEAD_RPC_US)
        row = self.nodes[nid]
        b = self._breaker(row["address"])
        t = self.tasks[tid]
        try:
            reply = self._client(nid).call("exec", tid, t["duration"])
        except RpcConnectionError:
            b.record_failure()
            self._after_breaker(nid, b)
            self.pending.append(tid)
            return
        b.record_success()
        self._after_breaker(nid, b)
        if reply.get("op") == "done":
            self._mark_done(tid, reply["oid"], nid)
            return
        if reply.get("op") == "rejected":       # node started draining
            self.pending.append(tid)
            return
        t["state"] = "running"
        t["node"] = nid
        t["granted_at"] = self.clock.monotonic()
        t["attempts"] += 1
        row["running"][tid] = True
        self._note_dispatch()

    # -- drain / death / removal ---------------------------------------------
    def start_drain(self, nid: str, reason: str) -> bool:
        row = self.nodes.get(nid)
        if row is None or row["state"] != ALIVE:
            return False
        row["state"] = DRAINING
        row["drain_started"] = self.clock.monotonic()
        self.trace.rec(self.clock.monotonic(), "drain_start", node=nid,
                       reason=reason)
        try:
            self._client(nid).call("drain")
        except RpcConnectionError:
            pass        # deadline in the monitor will force-remove
        return True

    def _on_node_dead(self, nid: str, reason: str) -> None:
        row = self.nodes[nid]
        row["state"] = DEAD
        requeued = self._requeue_node(nid)
        self._revoke_node(nid, reason)
        self.trace.rec(self.clock.monotonic(), "node_dead", node=nid,
                       reason=reason, requeued=requeued)
        self._remove_node(nid, "dead")

    def _requeue_node(self, nid: str) -> int:
        row = self.nodes[nid]
        requeued = 0
        # canary (params.canary, default off): drop — instead of
        # requeueing — the running set of a node that dies while a
        # partition is live.  The hunt's smoke target: reachable only
        # by composing two fault ops, so a schedule must be FOUND, and
        # minimizable to exactly that pair.
        lose = self.params.canary and bool(self.cluster.chaos.partitions)
        for tid in list(row["running"]):
            t = self.tasks.get(tid)
            if t is not None and t["state"] == "running" and \
                    t["node"] == nid:
                if lose:
                    continue
                t["state"] = "pending"
                t["node"] = None
                self.pending.append(tid)
                requeued += 1
        row["running"].clear()
        for tid in list(row["leased"]):
            t = self.tasks.get(tid)
            if t is not None and t["state"] == "leased" and \
                    t["node"] == nid:
                t["state"] = "pending"
                t["node"] = None
                self.pending.append(tid)
                requeued += 1
        row["leased"].clear()
        return requeued

    def _revoke_node(self, nid: str, reason: str) -> None:
        """Bump the node's lease epoch (journaled) and forget its grant
        set: any grant it stamped below the new epoch is dead."""
        if self.grantor is None:
            return
        epoch = self.grantor.drop_node(nid, reason)
        now = self.clock.monotonic()
        self.cluster.leasing["revocations"] += 1
        self.cluster.revocation_log.setdefault(nid, []).append(
            (epoch, now))
        self.trace.rec(now, "lease_revoked", node=nid, epoch=epoch,
                       reason=reason)

    def _remove_node(self, nid: str, reason: str) -> None:
        row = self.nodes[nid]
        if row["state"] != DEAD:
            self._requeue_node(nid)
            self._revoke_node(nid, reason)
        # a removed node's replicas leave the cluster with it —
        # whether it died or drained cleanly (drain migrates tasks,
        # not objects).  Scrub its copy registrations so lineage
        # repair sees the loss; a phantom copy on a REMOVED row would
        # block reconstruction forever.  Found by the r16 hunt
        # (tests/data/hunt_finding_object_copies_r16.json): the scrub
        # used to run only on the death path, so a clean drain — e.g.
        # the autoscaler removing post-failover surge capacity — leaked
        # its replicas into the registry.
        for oid in list(self.objects):
            self.objects[oid]["copies"].pop(nid, None)
        row["state"] = REMOVED
        row["drain_started"] = None
        self.trace.rec(self.clock.monotonic(), "node_removed", node=nid,
                       reason=reason)

    # -- the periodic monitor ------------------------------------------------
    def _monitor(self) -> None:
        if not self.alive:
            return
        now = self.clock.monotonic()
        p = self.params
        hb_deadline = p.heartbeat_period_s * p.miss_threshold
        for nid in self._node_order:
            row = self.nodes.get(nid)
            if row is None:
                continue
            state = row["state"]
            if state in (ALIVE, DRAINING) and \
                    now - row["last_hb"] > hb_deadline:
                self._on_node_dead(nid, "heartbeat_timeout")
                continue
            if state == DRAINING and row["drain_started"] is not None \
                    and now - row["drain_started"] > p.drain_deadline_s:
                self._remove_node(nid, "drain_deadline")
                continue
            # lost-ack lease recovery
            for tid in list(row["running"]):
                t = self.tasks.get(tid)
                if t is None or t["state"] != "running":
                    row["running"].pop(tid, None)
                    continue
                if now - t["granted_at"] > p.lease_timeout_s:
                    row["running"].pop(tid, None)
                    t["state"] = "pending"
                    t["node"] = None
                    self.pending.append(tid)
                    self.trace.rec(now, "lease_requeued", task=tid,
                                   node=nid)
            # quiet-lease TTL sweep: a grant the raylet stopped
            # reporting went quiet past the TTL — revoke the node's
            # whole epoch (the raylet's queue dies with it) and requeue
            # everything it was leased, so nothing starts twice without
            # the epoch fence on record
            if self.grantor is not None and row["leased"]:
                quiet = any(now - last > p.lease_timeout_s
                            for last in row["leased"].values())
                if quiet:
                    epoch = self.grantor.revoke(nid, "quiet_lease")
                    self.cluster.leasing["revocations"] += 1
                    self.cluster.revocation_log.setdefault(
                        nid, []).append((epoch, now))
                    requeued = self._repend(nid, list(row["leased"]))
                    self.trace.rec(now, "lease_revoked", node=nid,
                                   epoch=epoch, reason="quiet_lease",
                                   requeued=requeued)
            # half-open probes for quarantined nodes
            if row["state"] == ALIVE and row["suspect"]:
                b = self._breaker(row["address"])
                if b.allow():
                    try:
                        self._client(nid).call("ping")
                        b.record_success()
                    except RpcConnectionError:
                        b.record_failure()
                    self._after_breaker(nid, b)
        # lineage: outputs of done tasks that lost every copy while the
        # job still needs them are reconstructed by re-running the task
        for jid, job in self.jobs.items():
            if job["status"] == "succeeded":
                continue
            for tid in job["tasks"]:
                t = self.tasks[tid]
                if t["state"] == "done":
                    obj = self.objects.get(t["oid"])
                    if obj is None or not obj["copies"]:
                        t["state"] = "pending"
                        t["node"] = None
                        self.pending.append(tid)
                        self.trace.rec(now, "reconstruct", task=tid,
                                       job=jid)
        self._schedule()
        self.clock.call_later(p.heartbeat_period_s, self._monitor)


class SimStandby:
    """Hot-standby head.  A follower that tails the shared persist dict
    (job table, done acks and the lease-epoch journal all live there),
    probes the primary at a quarter-heartbeat cadence, and collects
    raylet votes: every node that fails an RPC to the head votes here.

    Promotion is double-gated — the standby must have missed >= 2 of
    its own probes AND hold votes from a quorum fraction of live nodes.
    Under an asymmetric partition that cuts only the standby<->head
    link, the nodes keep reaching the head, never vote, and the lone
    standby can't split-brain; under a real head death both gates open
    within half a heartbeat period and the standby promotes by calling
    ``cluster.start_head()`` — which restores jobs, done acks and the
    revocation-epoch journal, so outstanding leases survive."""

    def __init__(self, cluster: "SimCluster"):
        self.cluster = cluster
        self.clock = cluster.clock
        self.params = cluster.params
        self.alive = True
        self.votes: set[str] = set()        # counted, never iterated
        self.probe_failures = 0
        self.server = cluster.transport.serve(
            {"vote": self._h_vote, "ping": self._h_ping},
            host=STANDBY_ADDR).start()
        self._head = cluster.transport.connect(HEAD_ADDR,
                                               _sim_src=STANDBY_ADDR)
        self.clock.call_later(self._probe_interval, self._probe)

    @property
    def _probe_interval(self) -> float:
        return self.params.heartbeat_period_s / 4.0

    def _h_ping(self) -> str:
        return "pong"

    def _h_vote(self, nid: str) -> str:
        self.votes.add(nid)
        self._maybe_promote()
        return "ok"

    def _probe(self) -> None:
        if not self.alive or not self.cluster.running:
            return
        try:
            self._head.call("ping")
            # primary reachable from here: clear stale votes so a past
            # blip can never combine with a later one into a quorum
            self.probe_failures = 0
            self.votes.clear()
        except RpcConnectionError:
            self.probe_failures += 1
            self._maybe_promote()
        self.clock.call_later(self._probe_interval, self._probe)

    def _maybe_promote(self) -> None:
        if not self.alive or self.probe_failures < 2:
            return
        need = max(1, -(-int(self.params.standby_quorum * 1000 *
                             self.cluster.alive_count) // 1000))
        if len(self.votes) < need:
            return
        self._promote()

    def _promote(self) -> None:
        cl = self.cluster
        if cl.head is not None and cl.head.alive:
            return      # primary is actually alive: never split-brain
        self.alive = False
        cl.transport.kill(STANDBY_ADDR)
        cl.trace.rec(self.clock.monotonic(), "standby_promote",
                     votes=len(self.votes),
                     probe_failures=self.probe_failures)
        cl.promotions += 1
        cl.start_head()     # restores persist incl. the epoch journal
        cl.standby = SimStandby(cl)     # a fresh follower takes over


class SimAutoscaler:
    """Sizing loop over the simulated head's node table: launches to
    cover pending demand and the min floor, drains idle surplus."""

    def __init__(self, cluster: "SimCluster", min_nodes: int,
                 max_nodes: int):
        self.cluster = cluster
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.launched = 0
        self.drained = 0
        cluster.clock.call_later(cluster.params.autoscaler_interval_s,
                                 self._tick)

    def _tick(self) -> None:
        cl = self.cluster
        if not cl.running:
            return
        head = cl.head
        if head is not None and head.alive:
            p = cl.params
            now = cl.clock.monotonic()
            alive = []
            free = 0
            for nid in head._node_order:
                row = head.nodes.get(nid)
                if row is not None and row["state"] == ALIVE:
                    alive.append(nid)
                    if _row_reserved(cl, nid):
                        continue    # serve/gang/LOANED: no batch slack
                    if not row["suspect"]:
                        free += p.node_capacity - len(row["running"])
            pending = len(head.pending)
            up = 0
            if pending > free:
                up = -(-(pending - free) // p.node_capacity)  # ceil
            if len(alive) < self.min_nodes:
                up = max(up, self.min_nodes - len(alive))
            up = max(0, min(up, self.max_nodes - len(alive)))
            if up:
                for _ in range(up):
                    cl.launch_node(booting=True)
                self.launched += up
                cl.trace.rec(now, "scale_up", count=up,
                             pending=pending)
            elif pending == 0 and len(alive) > self.min_nodes:
                surplus = len(alive) - self.min_nodes
                drained = 0
                for nid in alive:
                    if drained >= min(2, surplus):  # gentle: <=2/tick
                        break
                    if _row_reserved(cl, nid):
                        continue    # never idle-drain serve/gang rows
                    row = head.nodes[nid]
                    if not row["running"] and \
                            now - row["idle_since"] > \
                            p.autoscaler_idle_timeout_s:
                        if head.start_drain(nid, "idle_surplus"):
                            drained += 1
                self.drained += drained
        cl.clock.call_later(cl.params.autoscaler_interval_s, self._tick)


class SimCluster:
    """Owns the virtual clock, the sim transport, the chaos instance and
    every simulated component.  ``install()``/``close()`` swap the
    process clock seam in and out (the campaign runner brackets runs
    with them)."""

    def __init__(self, num_nodes: int, seed: int = 0,
                 params: SimParams | None = None,
                 chaos_params: dict | None = None):
        self.seed = int(seed)
        self.clock = VirtualClock()
        self.params = params or SimParams.from_config()
        self.chaos = _Chaos(seed=self.seed, **(chaos_params or {}))
        self.transport = SimTransport(chaos=self.chaos)
        self.trace = Trace()
        self.persist: dict = {"jobs": {}, "done": {}}
        self.nodes: dict[str, SimNode] = {}
        self._next_node = 0
        self.alive_count = 0
        self.peak_nodes = 0
        self.running = True
        self.head: SimHead | None = None
        self.autoscaler: SimAutoscaler | None = None
        self.serve_plane = None     # installed by serve_diurnal campaigns
        self.train_plane = None     # installed by train_diurnal campaigns
        # lease plane + failover bookkeeping (cluster-scoped so it
        # survives head kills; the promoted head keeps accruing)
        self.head_busy_us = 0.0
        self.head_dispatch_us = 0.0     # busy minus liveness touches
        self.leasing = {"local_grants": 0, "spillbacks": 0,
                        "revocations": 0}
        self.exec_log: list = []        # (tid, nid, epoch, start_t)
        self.exec_audited = 0           # starts already invariant-checked
        self.revocation_log: dict[str, list] = {}   # nid -> [(epoch, t)]
        self.failover_ms: list[float] = []
        self.last_head_kill_t: float | None = None
        self.promotions = 0
        self.standby: SimStandby | None = None
        self.start_head()
        if self.params.standby:
            self.standby = SimStandby(self)
        period = self.params.heartbeat_period_s
        for i in range(num_nodes):
            # stagger first beats across one period so 10k registrations
            # don't land on a single timestamp
            self.launch_node(stagger=period * i / max(1, num_nodes))
        self.trace.rec(0.0, "cluster_start", nodes=num_nodes,
                       seed=self.seed)

    # -- clock seam management ----------------------------------------------
    def install(self) -> "SimCluster":
        from ..common import clock as _clk
        self._prev_clock = _clk.get_clock()
        _clk.install(self.clock)
        return self

    def close(self) -> None:
        from ..common import clock as _clk
        self.running = False
        if getattr(self, "_prev_clock", None) is not None:
            _clk.install(self._prev_clock)
            self._prev_clock = None
        else:
            _clk.uninstall()

    def __enter__(self) -> "SimCluster":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- topology ------------------------------------------------------------
    def start_head(self) -> SimHead:
        self.head = SimHead(self)
        return self.head

    def kill_head(self) -> None:
        if self.head is not None:
            self.head.alive = False
            self.transport.kill(HEAD_ADDR)
            self.head = None
            # failover window opens: closed by the first dispatch of
            # whichever head comes back (restart or standby promotion)
            self.last_head_kill_t = self.clock.monotonic()

    def launch_node(self, stagger: float | None = None,
                    booting: bool = False) -> str:
        nid = f"n{self._next_node:05d}"
        self._next_node += 1
        delay = self.params.boot_delay_s if booting else (stagger or 0.0)
        if booting:
            self.clock.call_later(delay, lambda: self._boot(nid, 0.0))
        else:
            self._boot(nid, delay)
        return nid

    def _boot(self, nid: str, stagger: float) -> None:
        if not self.running:
            return
        node = SimNode(self, nid)
        self.nodes[nid] = node
        node.start(stagger=stagger)
        self.alive_count += 1
        self.peak_nodes = max(self.peak_nodes, self.alive_count)

    def kill_node(self, nid: str) -> bool:
        node = self.nodes.get(nid)
        if node is None or not node.alive:
            return False
        node.alive = False
        self.transport.kill(node.address)
        self.alive_count -= 1
        return True

    def node_stopped(self, nid: str) -> None:
        """A node exited cleanly (post-drain)."""
        self.alive_count -= 1

    def enable_autoscaler(self, min_nodes: int,
                          max_nodes: int) -> SimAutoscaler:
        self.autoscaler = SimAutoscaler(self, min_nodes, max_nodes)
        return self.autoscaler

    # -- convenience ---------------------------------------------------------
    def alive_node_ids(self) -> list[str]:
        return [nid for nid, n in self.nodes.items() if n.alive]

    def stats(self) -> dict:
        tr = self.transport
        busy_s = self.head_busy_us / 1e6
        disp_s = self.head_dispatch_us / 1e6
        done = len(self.persist["done"])
        s = {
            "virtual_s": round(self.clock.monotonic(), 3),
            "events_fired": self.clock.fired,
            "rpc_calls": tr.calls,
            "rpc_dropped": tr.dropped,
            "rpc_dup": tr.dup_delivered,
            "rpc_unreachable": tr.unreachable,
            "chaos_partitioned": self.chaos.num_partitioned,
            "chaos_delayed": self.chaos.num_delayed,
            "peak_nodes": self.peak_nodes,
            "trace_events": self.trace.total,
            # dispatch throughput over modeled head service time
            # attributable to dispatching (liveness touches excluded —
            # they are identical in both modes): the lease-vs-head-only
            # comparison the bench records
            "dispatch": {
                "tasks_done": done,
                "head_busy_s": round(busy_s, 6),
                "head_dispatch_s": round(disp_s, 6),
                "throughput_per_s": round(done / disp_s, 3)
                if disp_s else 0.0,
            },
        }
        if self.params.lease_plane:
            hits = self.leasing["local_grants"]
            miss = self.leasing["spillbacks"]
            s["leasing"] = {
                "leases_granted_local": hits,
                "spillbacks": miss,
                "lease_hit_rate": round(hits / (hits + miss), 4)
                if hits + miss else 0.0,
                "lease_revocations": self.leasing["revocations"],
                "lease_starts": self.exec_audited + len(self.exec_log),
                "promotions": self.promotions,
                "failover_ms": [round(ms, 3)
                                for ms in self.failover_ms],
            }
        return s

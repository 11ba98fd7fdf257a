"""Elastic serve<->batch capacity loaning (driver-side loan manager).

When a deployment's backlog crosses the scale-up bar but its replica
pool is already at ``max_replicas`` (the controller's ``at_max``
signal), the cluster can *borrow* an idle batch node instead of shedding:
the node's CRM row is marked ``LOANED``, its generic availability is
force-subtracted to zero (batch placement cannot fit), and a shaped
``serve_loaned`` resource — exposed only on loaned rows — is added, onto
which the controller starts one extra replica (``add_loaner``).  Router
shards pick the loaner up on their next refresh like any other replica.

Reclaim reuses the DRAINING machine's semantics with a restore epilogue
instead of a removal: ``begin_retire_loaner`` pulls the replica out of
the routing set (version bump — shards stop dispatching), the row is
marked draining, the manager polls the replica shell's in-flight count
across ticks until it hits zero (or ``serve_loan_drain_timeout_s``),
then ``finish_retire_loaner`` kills the replica and the row's original
availability is added back.  The node never leaves the cluster, so
reclaim latency is a drain, not a cold boot.

A loaned node that DIES mid-loan or mid-reclaim is booked as a loss
exactly once: the loan record is popped under the manager lock, the
controller drops the dead replica from its membership, and the router's
transport-error path settles the in-flight accounting (the next gossip
fold evicts the dead replica's digest).

Loaning also runs in REVERSE: when batch/train demand is unmet, no idle
batch row exists, and a deployment is quiet, the manager borrows a
serve node — ``begin_release_replica`` pulls the newest replica out of
routing (same drain semantics as a reclaim), the manager polls its
in-flight count to zero, then ``finish_release_replica`` kills it so
the node's full availability returns to the CRM for batch placement.
Serve backlog pressure ends the lend (``restore_replica`` starts a
fresh replica); a lent node that dies is booked as a loss exactly once
by the same popped-record rule, and serve is made whole with a
replacement replica elsewhere.

Ticks ride existing beats — the autoscaler's ``update()`` round (which
also supplies batch pressure as ``unmet``) and the health manager's
probe round — so loaning adds no thread and no new RPC.
"""

from __future__ import annotations

import threading

import numpy as np

from ..common import clock as _clk
from ..common import locksets
from ..common.config import get_config
from ..common.resources import ResourceRequest, to_cu

__all__ = ["CapacityLoanManager"]


def _api():
    import ray_tpu_torch
    return ray_tpu_torch


class _Loan:
    __slots__ = ("node_id", "row", "handle", "key_hex", "ctl_key",
                 "controller", "borrowed", "state", "t_loaned",
                 "t_drain", "drain_deadline")

    def __init__(self, node_id, row, handle, ctl_key, controller,
                 borrowed):
        self.node_id = node_id
        self.row = row
        self.handle = handle            # the loaner replica's handle
        self.key_hex = handle._actor_id.binary().hex()
        self.ctl_key = ctl_key          # controller actor-id binary
        self.controller = controller
        self.borrowed = borrowed        # cu dict force-subtracted at loan
        self.state = "active"           # active -> draining -> (gone)
        self.t_loaned = _clk.monotonic()
        self.t_drain = 0.0
        self.drain_deadline = 0.0


class _ReverseLend:
    __slots__ = ("node_id", "row", "handle", "key_hex", "ctl_key",
                 "controller", "state", "t_start", "drain_deadline")

    def __init__(self, node_id, row, handle, ctl_key, controller):
        self.node_id = node_id
        self.row = row
        self.handle = handle            # the released replica's handle
        self.key_hex = handle._actor_id.binary().hex()
        self.ctl_key = ctl_key
        self.controller = controller
        self.state = "draining"         # draining -> lent -> (gone)
        self.t_start = _clk.monotonic()
        self.drain_deadline = 0.0


@locksets.track("loans_total", "reclaims_total", "loans_lost",
                "reverse_lends_total", "reverse_lends_returned",
                "reverse_lends_lost", "last_reclaim_latency_s")
class CapacityLoanManager:
    """Tracks LOANED rows atop the CRM and drives the loan/reclaim
    state machine.  Driver-side: it reads the driver-local router
    groups' backlog and talks to controllers over plain actor calls."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._lock = threading.Lock()
        self._loans: list[_Loan] = []
        self._rloans: list[_ReverseLend] = []
        self._cooldown_until = 0.0
        self._serve_idle: dict[bytes, float] = {}   # ctl_key -> since
        self.loans_total = 0
        self.reclaims_total = 0
        self.loans_lost = 0
        self.reverse_lends_total = 0
        self.reverse_lends_returned = 0
        self.reverse_lends_lost = 0
        self.last_reclaim_latency_s = 0.0

    # -- the tick (autoscaler round / health probe round) --------------------
    def tick(self, unmet: int = 0) -> None:
        """One loan-manager round.  Non-reentrant by design: overlapping
        beats (autoscaler vs health) skip instead of queueing — the next
        beat re-derives everything from current state."""
        if not self._lock.acquire(blocking=False):
            return
        try:
            self._book_deaths()
            self._advance_reclaims()
            self._advance_releases()
            self._start_reclaims(unmet)
            self._end_stale_releases()
            self._maybe_loan()
            self._maybe_release(unmet)
        finally:
            self._lock.release()

    # -- loss booking (node death mid-loan / mid-reclaim) --------------------
    def _book_deaths(self) -> None:
        crm = self._cluster.crm
        for loan in list(self._loans):
            if crm.row_of(loan.node_id) is not None:
                continue
            # popping the record under the lock IS the exactly-once
            # bookkeeping: later beats see no loan to re-book
            self._loans.remove(loan)
            self.loans_lost += 1
            try:
                if loan.state == "active":
                    _api().get(loan.controller.begin_retire_loaner.remote(
                        loan.key_hex), timeout=10)
                _api().get(loan.controller.finish_retire_loaner.remote(
                    loan.key_hex), timeout=10)
            except Exception:   # noqa: BLE001 — controller may be gone too
                pass
            self._cluster.events.emit(
                "loans", "loan_lost", node_row=loan.row,
                node_id=loan.node_id.hex(), state=loan.state)
        for rl in list(self._rloans):
            if rl.node_id is None or crm.row_of(rl.node_id) is not None:
                continue
            # same exactly-once rule: popping the record IS the booking
            self._rloans.remove(rl)
            self.reverse_lends_lost += 1
            try:
                if rl.state == "draining":
                    _api().get(rl.controller.finish_release_replica.remote(
                        rl.key_hex), timeout=10)
                # serve is made whole with a replacement elsewhere
                _api().get(rl.controller.restore_replica.remote(),
                           timeout=10)
            except Exception:   # noqa: BLE001 — controller may be gone too
                pass
            self._cluster.events.emit(
                "loans", "reverse_lend_lost", node_row=rl.row,
                node_id=rl.node_id.hex(), state=rl.state)

    # -- reclaim state machine -----------------------------------------------
    def _start_reclaims(self, unmet: int) -> None:
        """Begin draining active loans when batch wants its capacity
        back (``unmet`` demand classes) or serve has gone idle for
        ``serve_loan_reclaim_idle_s``."""
        cfg = get_config()
        now = _clk.monotonic()
        idle_keys = set()
        for group in self._groups():
            key = group._controller._actor_id.binary()
            queued, inflight, _ewma = group.backlog()
            if queued == 0 and inflight == 0:
                since = self._serve_idle.setdefault(key, now)
                if now - since >= cfg.serve_loan_reclaim_idle_s:
                    idle_keys.add(key)
            else:
                self._serve_idle.pop(key, None)
        for loan in reversed(self._loans):          # LIFO: newest first
            if loan.state != "active":
                continue
            if unmet > 0 or loan.ctl_key in idle_keys:
                self._begin_reclaim(loan)
                if unmet > 0:
                    unmet -= 1      # one node per pressure unit per tick

    def _begin_reclaim(self, loan: _Loan) -> None:
        try:
            _api().get(loan.controller.begin_retire_loaner.remote(
                loan.key_hex), timeout=10)
        except Exception:   # noqa: BLE001 — death path books it next beat
            return
        # DRAINING semantics: the row leaves every placement view while
        # in-flight work finishes; unlike a node drain there is no
        # removal — the epilogue restores availability instead
        self._cluster.crm.set_draining(loan.node_id, True)
        loan.state = "draining"
        loan.t_drain = _clk.monotonic()
        loan.drain_deadline = loan.t_drain + \
            get_config().serve_loan_drain_timeout_s
        self._cluster.events.emit(
            "loans", "loan_reclaim_started", node_row=loan.row,
            node_id=loan.node_id.hex())

    def _advance_reclaims(self) -> None:
        from ray_tpu_torch.actor_api import ActorMethod
        for loan in list(self._loans):
            if loan.state != "draining":
                continue
            active = 0
            try:
                active = _api().get(
                    ActorMethod(loan.handle, "_active_count").remote(),
                    timeout=5)
            except Exception:   # noqa: BLE001 — unreachable counts as done
                active = 0
            if active > 0 and _clk.monotonic() < loan.drain_deadline:
                continue        # keep draining; poll again next beat
            self._finish_reclaim(loan)

    def _finish_reclaim(self, loan: _Loan) -> None:
        try:
            _api().get(loan.controller.finish_retire_loaner.remote(
                loan.key_hex), timeout=10)
        except Exception:   # noqa: BLE001
            pass
        self._restore_row(loan)
        self._loans.remove(loan)
        self.reclaims_total += 1
        self.last_reclaim_latency_s = \
            round(_clk.monotonic() - loan.t_drain, 4)
        self._cluster.events.emit(
            "loans", "loan_reclaimed", node_row=loan.row,
            node_id=loan.node_id.hex(),
            latency_s=self.last_reclaim_latency_s)

    def _restore_row(self, loan: _Loan) -> None:
        """The restore epilogue: un-drain, drop the loan-shaped
        resource, and add the borrowed availability back (clamped to
        totals by ``add_back``, so a double restore cannot overfill)."""
        crm = self._cluster.crm
        if crm.set_draining(loan.node_id, False) is None:
            return              # node died as the drain converged
        crm.remove_shaped_resources(loan.row,
                                    {"serve_loaned": to_cu(1)})
        if loan.borrowed:
            crm.add_back(loan.row,
                         ResourceRequest.from_cu_dict(loan.borrowed))
        crm.set_loaned(loan.row, False)
        self._cluster.wake_raylets()    # parked batch work fits again

    # -- reverse lend state machine ------------------------------------------
    def _advance_releases(self) -> None:
        """Poll draining released replicas; once in-flight hits zero
        (or the drain deadline passes) kill the replica — the node's
        availability returns to the CRM and batch placement fits."""
        from ray_tpu_torch.actor_api import ActorMethod
        for rl in list(self._rloans):
            if rl.state != "draining":
                continue
            active = 0
            try:
                active = _api().get(
                    ActorMethod(rl.handle, "_active_count").remote(),
                    timeout=5)
            except Exception:   # noqa: BLE001 — unreachable counts as done
                active = 0
            if active > 0 and _clk.monotonic() < rl.drain_deadline:
                continue
            try:
                _api().get(rl.controller.finish_release_replica.remote(
                    rl.key_hex), timeout=10)
            except Exception:   # noqa: BLE001 — death path books it next beat
                continue
            rl.state = "lent"
            self._cluster.wake_raylets()    # parked batch work fits now
            self._cluster.events.emit(
                "loans", "reverse_lend_active", node_row=rl.row,
                node_id=rl.node_id.hex() if rl.node_id else "")

    def _end_stale_releases(self) -> None:
        """Serve wants its capacity back: a deployment whose replica is
        out on a reverse lend built up backlog — end the lend (a fresh
        replica replaces the lent one)."""
        if not self._rloans:
            return
        cfg = get_config()
        bar = max(1, cfg.serve_loan_backlog // 2)
        pressured = set()
        for group in self._groups():
            queued, _inflight, _ewma = group.backlog()
            if queued >= bar:
                pressured.add(group._controller._actor_id.binary())
        for rl in reversed(list(self._rloans)):     # LIFO: newest first
            if rl.ctl_key in pressured:
                self._end_release(rl)

    def _end_release(self, rl: _ReverseLend) -> None:
        # reclaim notice BEFORE the replica returns: batch/train work
        # on the lent row (the elastic trainer's gang) vacates as a
        # PLANNED resize, making room for the restored replica
        try:
            self._cluster.pubsub.publish(
                "node", {"event": "loan_reclaim", "row": rl.row,
                         "node_id": rl.node_id.hex() if rl.node_id
                         else ""})
        except Exception:   # noqa: BLE001 — notice is best-effort
            pass
        try:
            if rl.state == "draining":
                _api().get(rl.controller.finish_release_replica.remote(
                    rl.key_hex), timeout=10)
            _api().get(rl.controller.restore_replica.remote(), timeout=10)
        except Exception:   # noqa: BLE001 — death path books it next beat
            return
        self._rloans.remove(rl)
        self.reverse_lends_returned += 1
        self._cluster.events.emit(
            "loans", "reverse_lend_returned", node_row=rl.row,
            node_id=rl.node_id.hex() if rl.node_id else "")

    def _maybe_release(self, unmet: int) -> None:
        """Reverse direction: batch/train demand is unmet, no idle
        batch row exists to loan the normal way, and a deployment is
        quiet — borrow a serve node by releasing its newest replica."""
        cfg = get_config()
        now = _clk.monotonic()
        if unmet <= 0 or now < self._cooldown_until:
            return
        if self._loans or len(self._rloans) >= cfg.train_borrow_max:
            return      # never both directions at once
        if self._pick_idle_row() is not None:
            return      # plain batch capacity exists; no need to raid serve
        for group in self._groups():
            queued, _inflight, _ewma = group.backlog()
            if queued > 0:
                continue
            controller = group._controller
            try:
                handle = _api().get(
                    controller.begin_release_replica.remote(), timeout=10)
            except Exception:   # noqa: BLE001
                continue
            if handle is None:
                continue        # at the autoscaling floor
            row = self._row_of_handle(handle)
            node_id = self._cluster.crm.id_of(row) if row >= 0 else None
            rl = _ReverseLend(node_id, row, handle,
                              controller._actor_id.binary(), controller)
            rl.drain_deadline = now + cfg.serve_loan_drain_timeout_s
            self._rloans.append(rl)
            self.reverse_lends_total += 1
            self._cooldown_until = now + cfg.serve_loan_cooldown_s
            self._cluster.events.emit(
                "loans", "reverse_lend_started", node_row=row,
                node_id=node_id.hex() if node_id else "",
                deployment=group.cfg().get("name", ""))
            return              # at most one lend per tick

    def _row_of_handle(self, handle) -> int:
        am = getattr(self._cluster, "actor_manager", None)
        if am is None:
            return -1
        rec = am._actors.get(handle._actor_id)
        return rec.row if rec is not None else -1

    # -- loan path ------------------------------------------------------------
    def _maybe_loan(self) -> None:
        cfg = get_config()
        now = _clk.monotonic()
        if now < self._cooldown_until:
            return
        if len(self._loans) >= cfg.serve_loan_max_nodes:
            return
        for group in self._groups():
            gcfg = group.cfg()
            if not gcfg or not gcfg.get("at_max"):
                continue
            queued, _inflight, _ewma = group.backlog()
            if queued < cfg.serve_loan_backlog:
                continue
            if self._loan_to(group):
                self._cooldown_until = _clk.monotonic() + \
                    cfg.serve_loan_cooldown_s
                return              # at most one loan per tick

    def _loan_to(self, group) -> bool:
        row = self._pick_idle_row()
        if row is None:
            return False
        cluster = self._cluster
        crm = cluster.crm
        node_id = crm.id_of(row)
        if node_id is None:
            return False
        totals, avail, _mask = crm.arrays()
        borrowed = {crm.resource_index.name(int(col)):
                    int(avail[row][col])
                    for col in np.flatnonzero(avail[row])}
        # order matters: mark LOANED and zero availability BEFORE the
        # shaped resource appears, so no batch round can slip work in
        crm.set_loaned(row, True)
        if borrowed:
            crm.force_subtract(row,
                               ResourceRequest.from_cu_dict(borrowed))
        crm.add_shaped_resources(row, {"serve_loaned": to_cu(1)})
        controller = group._controller
        try:
            handle = _api().get(controller.add_loaner.remote(
                {"resources": {"serve_loaned": 1}, "num_cpus": 0}),
                timeout=30)
        except Exception:   # noqa: BLE001 — unwind: the row stays batch
            crm.remove_shaped_resources(row, {"serve_loaned": to_cu(1)})
            if borrowed:
                crm.add_back(row,
                             ResourceRequest.from_cu_dict(borrowed))
            crm.set_loaned(row, False)
            return False
        self._loans.append(_Loan(node_id, row, handle,
                                 controller._actor_id.binary(),
                                 controller, borrowed))
        self.loans_total += 1
        cluster.events.emit("loans", "loan_started", node_row=row,
                            node_id=node_id.hex(),
                            deployment=group.cfg().get("name", ""))
        return True

    def _pick_idle_row(self) -> int | None:
        """An idle, fully-free, healthy batch row (never the head,
        never a draining/suspect/already-loaned one)."""
        cluster = self._cluster
        crm = cluster.crm
        totals, avail, mask = crm.arrays()
        for row, raylet in sorted(cluster.raylets.items()):
            if row == cluster._head_row or not mask[row]:
                continue
            if crm.is_draining(row) or crm.is_loaned(row) or \
                    bool(crm.suspect[row]):
                continue
            if not (avail[row] == totals[row]).all():
                continue
            if not raylet.is_idle():
                continue
            return row
        return None

    # -- introspection ---------------------------------------------------------
    def _groups(self) -> list:
        # serve's router is not ported yet (ROADMAP.md A.16): no router
        # group exists in this process
        return []

    def active_loans(self) -> list[dict]:
        with self._lock:
            return [{"node_id": loan.node_id.hex(), "row": loan.row,
                     "state": loan.state,
                     "age_s": round(_clk.monotonic() - loan.t_loaned, 3)}
                    for loan in self._loans]

    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        return {"loans_total": self.loans_total,
                "reclaims_total": self.reclaims_total,
                "loans_lost": self.loans_lost,
                "loans_active": len(self._loans),
                "reverse_lends_total": self.reverse_lends_total,
                "reverse_lends_returned": self.reverse_lends_returned,
                "reverse_lends_lost": self.reverse_lends_lost,
                "reverse_lends_active": len(self._rloans),
                "last_reclaim_latency_s": self.last_reclaim_latency_s}

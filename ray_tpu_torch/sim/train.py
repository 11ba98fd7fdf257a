"""Simulated elastic training plane: a gang of workers sharing the
pool with serve, surviving worker SIGKILL, head SIGKILL and drains.

The live plane (``ray_tpu_torch/train/elastic.py``) journals epoch state
through the GCS-snapshotted KV, syncs weights over the broadcast tree
and replicates checkpoints off the writing node.  The simulator models
the SAME control decisions as discrete events on the virtual clock:

* **Epoch pipeline.**  form gang -> weight sync (a real
  :class:`SimBroadcastWave` rooted at the head, appended to
  ``cluster.broadcast_waves`` so campaign kill loops and broadcast
  invariants cover it) -> train for ``train_epoch_s`` -> write the
  checkpoint on the first gang member -> replicate it off-node -> ack.
  The epoch is journaled into ``cluster.persist["train"]`` ONLY once
  the checkpoint holds ``train_ckpt_replicas`` live copies and the
  head is alive — so acked epochs never regress by construction, and a
  promoted standby inherits the journal (``cluster.persist`` is
  cluster-scoped, exactly like the GCS snapshot the live head journals
  through).  Samples are booked at ack time, never earlier: goodput is
  committed samples over wall time, Gavel's effective-throughput
  framing (PAPERS.md 2008.09213).
* **SIGKILL mid-epoch.**  A gang member killed while training blocks
  the collective for ``train_collective_timeout_s`` virtual seconds
  (the bounded-timeout contract of ``util/collective.GangMemberLost``),
  then the epoch aborts and the gang re-forms from the last acked
  epoch.  A kill during weight sync is cheaper: the broadcast layer
  notices the dead peer immediately.
* **Planned resizes.**  A draining member (campaign drain fault or
  autoscaler reclaim) is removed WITHOUT the collective-timeout burn —
  the drain notice arrives before the death, the live trainer's
  no-``max_failures``-burn contract.
* **Checkpoint durability.**  Copy-holder death triggers
  re-replication to another live node; the ``ckpt-durable`` invariant
  fires if the newest acked checkpoint ever loses every copy, or stays
  under-replicated past the replication grace.
* **Reverse loaning (Aryl both directions).**  At each epoch boundary
  the gang borrows idle serve replicas through
  ``SimServePlane.begin_lend`` while serve sits in its diurnal trough
  (up to ``train_borrow_max``), and returns them — drain-reclaim
  semantics, lender-side booked — the moment ``wants_back`` turns on.

Determinism contract: the plane draws NOTHING from the RNG — every
decision is a function of cluster state and the virtual clock — and it
only exists when a ``train_diurnal`` campaign installs it, so every
other campaign's replay hash is untouched.
"""

from __future__ import annotations

from ..common.config import get_config
from .broadcast import SimBroadcastWave

__all__ = ["SimTrainPlane"]

_FORM_RETRY_S = 1.0     # re-poll period while the gang is under-strength
_SYNC_POLL_S = 1.0      # weight-sync wave terminal poll period
_TICK_S = 2.5           # sweep period (drains, borrows, re-replication)
_ACK_RETRY_S = 1.0      # journal retry period while the head is down
_SAMPLES_PER_WORKER = 64    # samples one worker contributes per epoch


class SimTrainPlane:
    """The training overlay a ``train_diurnal`` campaign installs on a
    :class:`SimCluster` (as ``cluster.train_plane``)."""

    def __init__(self, cluster, duration: float = 200.0,
                 num_workers: int | None = None, serve=None):
        cfg = get_config()
        self.cluster = cluster
        self.serve = serve              # SimServePlane or None
        self.epoch_s = float(cfg.train_epoch_s)
        self.ckpt_replicas = int(cfg.train_ckpt_replicas)
        self.replicate_s = float(cfg.train_ckpt_replicate_s)
        self.borrow_max = int(cfg.train_borrow_max)
        self.coll_timeout_s = float(cfg.train_collective_timeout_s)
        self.target = num_workers if num_workers is not None else \
            max(2, len(cluster.nodes) // 16)
        self.t_end = duration * 0.85

        self.reserved: set[str] = set()     # gang + borrowed rows
        self.gang: list[str] = []           # sorted member node ids
        self.borrowed: list[str] = []       # serve rows we hold
        self._pending_borrows: list[str] = []   # lend draining at serve
        self.state = "idle"
        self.attempt = 0                # bumps cancel stale epoch events
        self._epoch_gang: list[str] = []    # members at epoch start

        self.acked_epoch = 0
        self._hwm_epoch = 0             # acked high-water mark
        self.epochs_committed = 0
        self.epochs_aborted = 0
        self.samples_committed = 0
        # epoch -> {copies, t_write, t_degraded, acked, repl}
        self.ckpts: dict[int, dict] = {}
        self.gang_losses = 0            # SIGKILL -> collective timeout
        self.planned_resizes = 0        # drain/reclaim, no timeout burn
        self.borrows_total = 0
        self.borrows_returned = 0
        self.borrows_lost = 0
        self.head_ack_stalls = 0
        self.resyncs = 0                # weight-sync waves launched
        self.blocked_s = 0.0            # virtual time lost to timeouts
        self.started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        clock, trace = self.cluster.clock, self.cluster.trace
        self.started = True
        trace.rec(clock.monotonic(), "train_start", target=self.target,
                  epoch_s=self.epoch_s, t_end=round(self.t_end, 3))
        self.state = "forming"
        clock.call_later(0.1, self._form)
        clock.call_later(_TICK_S, self._tick)

    @property
    def terminal(self) -> bool:
        return self.started and self.state == "done" and \
            not self.borrowed and not self._pending_borrows and \
            not self.reserved

    # -- helpers -------------------------------------------------------------
    def _node_alive(self, nid: str) -> bool:
        node = self.cluster.nodes.get(nid)
        return node is not None and node.alive

    def _node_draining(self, nid: str) -> bool:
        node = self.cluster.nodes.get(nid)
        return node is not None and node.draining

    def _live_copies(self, entry: dict) -> list[str]:
        return [c for c in sorted(entry["copies"]) if self._node_alive(c)]

    def _free_nodes(self) -> list[str]:
        """Idle batch rows the gang may claim, deterministically ordered
        — never serve's rows, never rows running batch work."""
        out = []
        splane = self.serve
        for nid in sorted(self.cluster.nodes):
            node = self.cluster.nodes[nid]
            if not node.alive or node.draining:
                continue
            if nid in self.reserved:
                continue
            if splane is not None and nid in splane.reserved:
                continue
            if node.running or node.local_queue:
                continue
            out.append(nid)
        return out

    # -- the epoch pipeline --------------------------------------------------
    def _form(self) -> None:
        if not self.cluster.running or self.state == "done":
            return
        if self.state != "forming":
            return      # a stale retry; the pipeline moved on
        clock, trace = self.cluster.clock, self.cluster.trace
        now = clock.monotonic()
        if now >= self.t_end:
            self._finish()
            return
        # sweep members that died or started draining between epochs
        self.gang = [m for m in self.gang
                     if self._node_alive(m) and not self._node_draining(m)
                     and m in self.reserved]
        # return borrows the moment serve wants them back (epoch
        # boundary = the drain-reclaim point of the reverse direction)
        if self.serve is not None and self.borrowed and \
                self.serve.wants_back():
            for nid in list(self.borrowed):
                self._return_borrow(nid)
        # borrowed serve rows join the gang first (they are reserved
        # by us, so _free_nodes never surfaces them)
        for nid in self.borrowed:
            if self._node_alive(nid) and nid not in self.gang:
                self.gang.append(nid)
        # refill from the free pool up to target strength
        for nid in self._free_nodes():
            if len(self.gang) >= self.target:
                break
            self.reserved.add(nid)
            self.gang.append(nid)
        self.gang.sort()
        # opportunistic surge: borrow idle serve replicas at the trough
        if self.serve is not None and \
                len(self.borrowed) + len(self._pending_borrows) < \
                self.borrow_max and self.serve.can_lend() and \
                not self.serve.wants_back():
            nid = self.serve.begin_lend()
            if nid is not None:
                self._pending_borrows.append(nid)
                self.borrows_total += 1
                trace.rec(now, "train_borrow", node=nid)
        if len(self.gang) < 2:
            clock.call_later(_FORM_RETRY_S, self._form)
            return
        # weight sync: (re)joining workers get the current weights down
        # the broadcast tree, never point-to-point
        self.state = "syncing"
        self.attempt += 1
        token = self.attempt
        self.resyncs += 1
        wave = SimBroadcastWave(
            self.cluster, f"train-sync-a{token}", list(self.gang),
            root="head", size_mb=256, fanout=2)
        self.cluster.broadcast_waves.append(wave)
        wave.start()
        trace.rec(now, "train_sync", wave=wave.wave_id,
                  members=len(self.gang), epoch=self.acked_epoch + 1)
        clock.call_later(_SYNC_POLL_S, lambda: self._poll_sync(token, wave))

    def _poll_sync(self, token: int, wave) -> None:
        if not self.cluster.running or token != self.attempt or \
                self.state != "syncing":
            return
        clock = self.cluster.clock
        if not wave.terminal:
            clock.call_later(_SYNC_POLL_S,
                             lambda: self._poll_sync(token, wave))
            return
        synced = set(wave.completed)
        self.gang = [m for m in self.gang if m in synced and
                     self._node_alive(m)]
        if len(self.gang) < 2:
            self.state = "forming"
            clock.call_later(_FORM_RETRY_S, self._form)
            return
        self.state = "training"
        self._epoch_gang = list(self.gang)
        now = clock.monotonic()
        self.cluster.trace.rec(now, "train_epoch_start",
                               epoch=self.acked_epoch + 1,
                               gang=len(self.gang))
        clock.call_later(self.epoch_s, lambda: self._trained(token))

    def _trained(self, token: int) -> None:
        if not self.cluster.running or token != self.attempt or \
                self.state != "training":
            return
        if any(not self._node_alive(m) for m in self.gang):
            # a member died and the collective is blocked: the pending
            # _gang_lost (or the planned-resize sweep) aborts the epoch
            return
        clock, trace = self.cluster.clock, self.cluster.trace
        now = clock.monotonic()
        self.state = "ckpt"
        e = self.acked_epoch + 1
        writer = self.gang[0]
        self.ckpts[e] = {"copies": {writer}, "t_write": now,
                         "t_degraded": None, "acked": False, "repl": 0}
        trace.rec(now, "train_ckpt_write", epoch=e, writer=writer)
        self._replicate(e, self.ckpts[e], token)

    def _replicate(self, e: int, entry: dict, token: int) -> None:
        """Schedule one more off-node copy of checkpoint ``e``."""
        targets = [n for n in self._free_nodes() + self.gang
                   if n not in entry["copies"]]
        if not targets:
            return      # the sweep retries when a target appears
        entry["repl"] += 1
        tgt = targets[0]
        self.cluster.clock.call_later(
            self.replicate_s,
            lambda: self._replicated(e, entry, tgt, token))

    def _replicated(self, e: int, entry: dict, tgt: str,
                    token: int) -> None:
        if not self.cluster.running or self.ckpts.get(e) is not entry:
            return      # epoch aborted meanwhile
        entry["repl"] -= 1
        now = self.cluster.clock.monotonic()
        if self._node_alive(tgt):
            entry["copies"].add(tgt)
            self.cluster.trace.rec(now, "train_ckpt_replica", epoch=e,
                                   node=tgt,
                                   copies=len(self._live_copies(entry)))
        live = len(self._live_copies(entry))
        if live >= self.ckpt_replicas:
            entry["t_degraded"] = None
            if not entry["acked"]:
                self._try_ack(e, entry, token)
        elif live > 0:
            self._replicate(e, entry, token)
        # live == 0 on an unacked entry: the sweep aborts the epoch

    def _try_ack(self, e: int, entry: dict, token: int) -> None:
        if not self.cluster.running or self.ckpts.get(e) is not entry:
            return
        if token != self.attempt or self.state not in ("ckpt", "acking"):
            return
        clock, trace = self.cluster.clock, self.cluster.trace
        head = self.cluster.head
        if head is None or not head.alive:
            # journal write needs the GCS: retry until the restarted (or
            # promoted standby) head is back — the epoch journal rides
            # the snapshot, so the new head inherits it unchanged
            self.state = "acking"
            self.head_ack_stalls += 1
            clock.call_later(_ACK_RETRY_S,
                             lambda: self._try_ack(e, entry, token))
            return
        now = clock.monotonic()
        samples = len(self._epoch_gang) * _SAMPLES_PER_WORKER
        entry["acked"] = True
        self.acked_epoch = e
        self._hwm_epoch = max(self._hwm_epoch, e)
        self.epochs_committed += 1
        self.samples_committed += samples
        jt = self.cluster.persist.setdefault("train", {})
        jt["epoch"] = e
        jt["samples"] = self.samples_committed
        jt["gang"] = len(self._epoch_gang)
        # bounded state: only the newest acked checkpoint stays tracked
        for old in [k for k in self.ckpts if k < e]:
            self.ckpts.pop(old)
        trace.rec(now, "train_epoch_acked", epoch=e, samples=samples,
                  gang=len(self._epoch_gang),
                  copies=len(self._live_copies(entry)))
        self.state = "forming"
        clock.call_later(0.01, self._form)

    def _finish(self) -> None:
        clock, trace = self.cluster.clock, self.cluster.trace
        now = clock.monotonic()
        for nid in list(self.borrowed):
            self._return_borrow(nid)
        for nid in list(self._pending_borrows):
            self._pending_borrows.remove(nid)
            if self.serve is not None:
                self.serve.end_lend(nid)
            self.borrows_returned += 1
        # release the gang back to the batch market; the newest acked
        # checkpoint's copies stay where they are (durable objects, not
        # reservations)
        self.reserved.clear()
        self.gang = []
        self.state = "done"
        trace.rec(now, "train_done", epochs=self.epochs_committed,
                  samples=self.samples_committed,
                  goodput_sps=round(self.goodput_sps(), 3))

    # -- failure plumbing ----------------------------------------------------
    def on_node_killed(self, nid: str) -> None:
        if not self.started or self.state == "done":
            self._book_copy_death(nid)
            return
        clock, trace = self.cluster.clock, self.cluster.trace
        now = clock.monotonic()
        if nid in self.borrowed:
            # the lender (serve) pops its own record and books the loss
            # exactly once; our side just forgets the row
            self.borrowed.remove(nid)
            self.reserved.discard(nid)
            self.borrows_lost += 1
            trace.rec(now, "train_borrow_lost", node=nid)
        if nid in self._pending_borrows:
            self._pending_borrows.remove(nid)
            self.borrows_lost += 1
            trace.rec(now, "train_borrow_lost", node=nid,
                      phase="draining")
        self._book_copy_death(nid)
        if nid not in self.gang:
            return
        if self.state == "training":
            # SIGKILL between barrier and reduce: the collective blocks
            # for the bounded timeout, then GangMemberLost aborts
            token = self.attempt
            trace.rec(now, "train_member_killed", node=nid,
                      timeout_s=self.coll_timeout_s)
            clock.call_later(self.coll_timeout_s,
                             lambda: self._gang_lost(token, nid))
        elif self.state == "syncing":
            # broadcast layer sees the dead peer at once: drop the
            # member, let the wave reach terminal, re-check strength
            self.gang.remove(nid)
            self.reserved.discard(nid)
        elif self.state in ("ckpt", "acking"):
            self.gang.remove(nid)
            self.reserved.discard(nid)
            e = self.acked_epoch + 1
            entry = self.ckpts.get(e)
            if entry is not None and not entry["acked"] and \
                    not self._live_copies(entry):
                self._abort_epoch(planned=False, reason="ckpt-lost")
        else:   # forming
            self.gang.remove(nid)
            self.reserved.discard(nid)

    def _book_copy_death(self, nid: str) -> None:
        now = self.cluster.clock.monotonic()
        for e in sorted(self.ckpts):
            entry = self.ckpts[e]
            if nid not in entry["copies"]:
                continue
            entry["copies"].discard(nid)
            live = len(self._live_copies(entry))
            if live < self.ckpt_replicas and entry["t_degraded"] is None:
                entry["t_degraded"] = now
            self.cluster.trace.rec(now, "train_ckpt_copy_lost", epoch=e,
                                   node=nid, copies=live)

    def _gang_lost(self, token: int, nid: str) -> None:
        if not self.cluster.running or token != self.attempt or \
                self.state != "training":
            return
        self.gang_losses += 1
        self.blocked_s += self.coll_timeout_s
        self.cluster.trace.rec(self.cluster.clock.monotonic(),
                               "train_gang_lost", node=nid,
                               epoch=self.acked_epoch + 1)
        self._abort_epoch(planned=False, reason="gang-member-lost")

    def _abort_epoch(self, planned: bool, reason: str) -> None:
        """Drop the in-flight epoch and re-form from the last acked one
        — the journal is untouched, so acked epochs never regress."""
        clock, trace = self.cluster.clock, self.cluster.trace
        self.attempt += 1       # cancels stale _trained/_poll_sync
        self.epochs_aborted += 1
        e = self.acked_epoch + 1
        entry = self.ckpts.get(e)
        if entry is not None and not entry["acked"]:
            self.ckpts.pop(e)
        self.gang = [m for m in self.gang if self._node_alive(m)
                     and not self._node_draining(m)]
        self.reserved.intersection_update(
            set(self.gang) | set(self.borrowed))
        if planned:
            self.planned_resizes += 1
        trace.rec(clock.monotonic(), "train_epoch_aborted",
                  epoch=e, planned=planned, reason=reason,
                  gang=len(self.gang))
        self.state = "forming"
        clock.call_later(0.01, self._form)

    # -- borrows -------------------------------------------------------------
    def _return_borrow(self, nid: str) -> None:
        self.borrowed.remove(nid)
        self.reserved.discard(nid)
        if nid in self.gang:
            self.gang.remove(nid)
        if self.serve is not None:
            self.serve.end_lend(nid)
        self.borrows_returned += 1
        self.cluster.trace.rec(self.cluster.clock.monotonic(),
                               "train_borrow_return", node=nid)

    # -- the sweep -----------------------------------------------------------
    def _tick(self) -> None:
        if not self.cluster.running:
            return
        clock, trace = self.cluster.clock, self.cluster.trace
        now = clock.monotonic()
        # borrowed rows whose lend finished draining at serve join the
        # reserved set (the gang picks them up at the next _form)
        for nid in list(self._pending_borrows):
            if self.serve is None:
                break
            if self.serve.lend_ready(nid):
                self._pending_borrows.remove(nid)
                self.borrowed.append(nid)
                self.reserved.add(nid)
                trace.rec(now, "train_borrow_ready", node=nid)
            elif nid not in self.serve.lent:
                # died while draining: lender already booked the loss
                self._pending_borrows.remove(nid)
                self.borrows_lost += 1
                trace.rec(now, "train_borrow_lost", node=nid,
                          phase="draining")
        # planned resizes: draining members leave WITHOUT the
        # collective-timeout burn; silently-dead drained members too
        if self.state != "done":
            for nid in [m for m in self.gang
                        if self._node_draining(m)]:
                if nid not in self.gang:
                    continue    # an abort below already swept it
                self.gang.remove(nid)
                self.reserved.discard(nid)
                trace.rec(now, "train_planned_resize", node=nid,
                          state=self.state)
                if self.state in ("training", "syncing"):
                    self._abort_epoch(planned=True, reason="drain")
                else:
                    self.planned_resizes += 1
            # members that died without a kill callback (clean exits)
            for nid in [m for m in self.gang
                        if not self._node_alive(m)]:
                if nid not in self.gang:
                    continue
                self._book_copy_death(nid)
                if self.state == "training":
                    token = self.attempt
                    trace.rec(now, "train_member_killed", node=nid,
                              timeout_s=self.coll_timeout_s)
                    clock.call_later(
                        self.coll_timeout_s,
                        lambda n=nid, t=token: self._gang_lost(t, n))
                else:
                    self.gang.remove(nid)
                    self.reserved.discard(nid)
        # checkpoint repair: re-replicate degraded entries; abort the
        # in-flight epoch if its sole copy is gone
        token = self.attempt
        for e in sorted(self.ckpts):
            entry = self.ckpts[e]
            live = self._live_copies(entry)
            entry["copies"] = set(live)
            if not entry["acked"] and not live and \
                    self.state in ("ckpt", "acking") and \
                    e == self.acked_epoch + 1:
                self._abort_epoch(planned=False, reason="ckpt-lost")
                continue
            if len(live) < self.ckpt_replicas and live and \
                    entry["repl"] == 0:
                self._replicate(e, entry, token)
            if len(live) >= self.ckpt_replicas:
                entry["t_degraded"] = None
        clock.call_later(_TICK_S, self._tick)

    # -- invariants ----------------------------------------------------------
    def check(self, strict: bool = False, now: float | None = None,
              grace: float = 10.0) -> tuple[list[str], int]:
        """Train-plane invariants, called from
        :func:`sim.invariants.check_invariants`."""
        from .invariants import fmt_violation

        violations: list[str] = []
        checks = 0
        if now is None:
            now = self.cluster.clock.monotonic()
        # goodput accounting: committed samples, the journal and the
        # acked-epoch counter must agree, and acks never regress
        checks += 1
        jt = self.cluster.persist.get("train")
        if jt is not None and (jt.get("epoch") != self.acked_epoch or
                               jt.get("samples") !=
                               self.samples_committed):
            violations.append(fmt_violation(
                "goodput-accounting", now,
                f"journal epoch={jt.get('epoch')}/"
                f"samples={jt.get('samples')} != plane "
                f"epoch={self.acked_epoch}/"
                f"samples={self.samples_committed}"))
        checks += 1
        if self.acked_epoch < self._hwm_epoch:
            violations.append(fmt_violation(
                "goodput-accounting", now,
                f"acked epoch regressed: {self.acked_epoch} < "
                f"high-water {self._hwm_epoch}"))
        # checkpoint durability: the newest acked checkpoint always has
        # a live copy, and reaches full replication within grace
        if self.acked_epoch > 0:
            checks += 1
            entry = self.ckpts.get(self.acked_epoch)
            live = [] if entry is None else self._live_copies(entry)
            if not live:
                violations.append(fmt_violation(
                    "ckpt-durable", now,
                    f"acked epoch {self.acked_epoch} checkpoint has "
                    f"no live copy"))
            elif len(live) < self.ckpt_replicas and \
                    entry["t_degraded"] is not None and \
                    now - entry["t_degraded"] > \
                    2.0 * self.replicate_s + grace:
                violations.append(fmt_violation(
                    "ckpt-durable", now,
                    f"acked epoch {self.acked_epoch} stuck at "
                    f"{len(live)}/{self.ckpt_replicas} copies for "
                    f"{now - entry['t_degraded']:.1f}s"))
        if strict:
            checks += 1
            if not self.terminal:
                violations.append(fmt_violation(
                    "gang-terminal", now,
                    f"training not terminal after quiesce: "
                    f"state={self.state} borrowed={len(self.borrowed)} "
                    f"pending={len(self._pending_borrows)} "
                    f"reserved={len(self.reserved)}"))
        return violations, checks

    # -- reporting -----------------------------------------------------------
    def goodput_sps(self) -> float:
        return self.samples_committed / max(self.t_end, 1e-9)

    def stats(self) -> dict:
        return {
            "workers_target": self.target,
            "state": self.state,
            "acked_epoch": self.acked_epoch,
            "epochs_committed": self.epochs_committed,
            "epochs_aborted": self.epochs_aborted,
            "samples_committed": self.samples_committed,
            "goodput_sps": round(self.goodput_sps(), 3),
            "gang_losses": self.gang_losses,
            "planned_resizes": self.planned_resizes,
            "blocked_s": round(self.blocked_s, 3),
            "resyncs": self.resyncs,
            "head_ack_stalls": self.head_ack_stalls,
            "borrows_total": self.borrows_total,
            "borrows_returned": self.borrows_returned,
            "borrows_lost": self.borrows_lost,
        }

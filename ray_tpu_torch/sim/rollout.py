"""Simulated model-version plane: rolling weight hot-swaps under chaos.

The live plane (``ray_tpu_torch/versioning/``) journals a
STAGING -> BROADCASTING -> FLIPPING -> SEALED | ROLLED_BACK state
machine through the KV and flips real replica actors.  The simulator
models the SAME state machine as discrete events on the virtual clock,
layered on :class:`~ray_tpu_torch.sim.serve.SimServePlane`:

* **BROADCASTING** rides a real :class:`SimBroadcastWave` over the
  replica nodes (appended to ``cluster.broadcast_waves``, so the
  campaign kill loops and the broadcast invariants cover it): the new
  weights stream 1->N down the bandwidth-derated tree while routers
  keep serving the old version.
* **FLIPPING** takes replicas one-at-a-time, lowest node id first:
  pull the replica out of routing (``route_ok = False``), poll its
  in-flight load to zero (robust to the replica dying mid-drain —
  accepted work re-dispatches exactly as under any death), re-tag it
  to the new version, run the verification probe, re-enter routing.
* **Session pinning.**  While a rollout is active, every arriving
  session is pinned to the then-serving version; dispatch filters
  power-of-two candidates to the pinned version, so no session is
  served by two versions at once (the ``version-mixed-session``
  invariant counts violations structurally: the pin recorded at
  dispatch vs the replica's tag at completion).  A pin whose version
  has no live replica left migrates to the serving version; pins
  expire after ``rollout_session_idle_s`` of silence and are dropped
  wholesale when the rollout reaches a terminal phase.
* **Failure trips.**  Verification-probe failure (campaign-injected
  via ``probe_fail_at``) and SLO regression (delta-histogram p99 since
  the rollout started exceeding ``rollout_slo_factor`` x the
  pre-rollout p99) roll back: every already-flipped replica re-tags to
  the retained old version.  Replica death mid-flip is tolerated — the
  set shrinks, the rollout continues.
* **Graft-on-pull.**  A replica joining mid-rollout (capacity loan
  warming up) adopts the version matching the phase: the new version
  once flipping started, the old one while still broadcasting.

Determinism contract: the plane draws NOTHING from the RNG — every
decision is a function of cluster state and the virtual clock — and it
only exists when a ``serve_rolling_update`` campaign installs it, so
every other campaign's replay hash is untouched.
"""

from __future__ import annotations

from ..common.config import get_config
from ..versioning import phases
from .broadcast import SimBroadcastWave
from .serve import _LAT_EDGES

__all__ = ["SimRolloutPlane"]

_WAVE_POLL_S = 1.0      # broadcast-terminal poll period
_DRAIN_POLL_S = 0.1     # per-flip drain poll period
_FLIP_GAP_S = 0.01      # spacing between consecutive flips


def _q(hist: list[int], q: float) -> float:
    """Bucket-edge quantile over a latency histogram (same read as
    ``SimServePlane._quantile``, usable on delta histograms)."""
    total = sum(hist)
    if not total:
        return 0.0
    target = q * total
    acc = 0
    for k, cnt in enumerate(hist):
        acc += cnt
        if acc >= target:
            return _LAT_EDGES[k] if k < len(_LAT_EDGES) else \
                _LAT_EDGES[-1] * 2
    return _LAT_EDGES[-1] * 2


class SimRolloutPlane:
    """The model-version overlay a ``serve_rolling_update`` campaign
    installs on a :class:`SimCluster` (as ``cluster.rollout_plane``,
    with ``plane.rollout`` pointing back)."""

    def __init__(self, cluster, plane):
        self.cluster = cluster
        self.plane = plane
        plane.rollout = self
        cluster.rollout_plane = self
        cfg = get_config()
        self.idle_s = float(cfg.rollout_session_idle_s)
        self.fanout = int(cfg.rollout_wave_fanout)
        self.slo_factor = float(cfg.rollout_slo_factor)

        self.serving = "v1"
        self.seq = 1
        for rep in plane.replicas.values():
            rep.version = self.serving
        self.rollouts: list[dict] = []
        self.active: dict | None = None
        self.queued: list[tuple[str, int]] = []
        self.session_pins: dict[int, list] = {}   # session -> [ver, t_last]
        self.req_session: dict[int, int] = {}     # rid -> session
        self.req_tag: dict[int, str] = {}         # rid -> pinned ver at dispatch
        self.mixed_served = 0
        self.migrations = 0
        self.grafts = 0

    # -- lifecycle -----------------------------------------------------------
    def start_rollout(self, artifact: str, probe_fail_at: int = -1) -> str:
        """Stage the next version; queues behind an active rollout
        (one per deployment at a time, like the live registry)."""
        if self.active is not None:
            self.queued.append((artifact, probe_fail_at))
            return "queued"
        self.seq += 1
        new = f"v{self.seq}"
        now = self.cluster.clock.monotonic()
        ro = {
            "id": f"r{self.seq}", "artifact": artifact,
            "from": self.serving, "to": new,
            "phase": phases.STAGING, "flipped": 0, "replicas": 0,
            "old_retained": True, "probe_fail_at": int(probe_fail_at),
            "t_start": now, "t_done": None, "error": "",
            "pre_hist": list(self.plane._hist),
            "pre_p99_s": _q(self.plane._hist, 0.99),
            "during_p99_s": 0.0,
        }
        self.rollouts.append(ro)
        self.active = ro
        self.cluster.trace.rec(now, "rollout_start", rid=ro["id"],
                               from_v=ro["from"], to_v=new,
                               artifact=artifact,
                               probe_fail_at=ro["probe_fail_at"])
        self._phase(ro, phases.BROADCASTING)
        members = sorted(self.plane.replicas)
        wave = SimBroadcastWave(self.cluster, f"rollout-{ro['id']}",
                                members, size_mb=256,
                                fanout=self.fanout)
        self.cluster.broadcast_waves.append(wave)
        wave.start()
        ro["wave"] = wave
        self.cluster.clock.call_later(_WAVE_POLL_S,
                                      lambda: self._poll_wave(ro))
        return ro["id"]

    def _phase(self, ro: dict, phase: str) -> None:
        ro["phase"] = phase
        self.cluster.trace.rec(self.cluster.clock.monotonic(),
                               "rollout_phase", rid=ro["id"],
                               phase=phase)

    def _poll_wave(self, ro: dict) -> None:
        if not self.cluster.running or ro is not self.active:
            return
        if not ro["wave"].terminal:
            self.cluster.clock.call_later(_WAVE_POLL_S,
                                          lambda: self._poll_wave(ro))
            return
        # graft-on-pull: members the wave never reached fetch on their
        # first flip, so a degraded broadcast is not a failed rollout
        self._phase(ro, phases.FLIPPING)
        ro["replicas"] = len(self.plane.replicas)
        self._flip_next(ro)

    # -- the flip sequence ---------------------------------------------------
    def _flip_targets(self, ro: dict) -> list[str]:
        out = []
        for nid in sorted(self.plane.replicas):
            rep = self.plane.replicas[nid]
            if not rep.alive or rep.version == ro["to"]:
                continue
            loan = self.plane.loans.get(nid)
            if loan is not None and loan["state"] == "draining":
                continue    # leaving the pool anyway
            out.append(nid)
        return out

    def _flip_next(self, ro: dict) -> None:
        if not self.cluster.running or ro is not self.active:
            return
        # SLO trip: p99 of completions since the rollout started vs the
        # pre-rollout baseline
        delta = [h - p for h, p in zip(self.plane._hist, ro["pre_hist"])]
        if sum(delta) >= 50 and ro["pre_p99_s"] > 0.0:
            during = _q(delta, 0.99)
            if during > self.slo_factor * ro["pre_p99_s"]:
                ro["during_p99_s"] = during
                self._fail(ro, f"slo: p99 {during:.2f}s > "
                               f"{self.slo_factor}x {ro['pre_p99_s']:.2f}s")
                return
        targets = self._flip_targets(ro)
        if not targets:
            self._seal(ro)
            return
        nid = targets[0]
        rep = self.plane.replicas[nid]
        rep.route_ok = False        # out of routing; drain in-flight
        self._drain_poll(ro, nid, rep.epoch)

    def _drain_poll(self, ro: dict, nid: str, epoch: int) -> None:
        if not self.cluster.running or ro is not self.active:
            return
        clock = self.cluster.clock
        rep = self.plane.replicas.get(nid)
        if rep is None or not rep.alive or rep.epoch != epoch:
            # died mid-flip: accepted work already re-dispatched by
            # _replica_dead; the set shrinks, the rollout continues
            self.cluster.trace.rec(clock.monotonic(), "rollout_flip_dead",
                                   rid=ro["id"], node=nid)
            clock.call_later(_FLIP_GAP_S, lambda: self._flip_next(ro))
            return
        if rep.load() > 0:
            # drain is bounded: no new work routes here and the replica
            # finishes what it holds (or dies, caught above)
            clock.call_later(_DRAIN_POLL_S,
                             lambda: self._drain_poll(ro, nid, epoch))
            return
        # drained: reload + verification probe
        flip_idx = ro["flipped"]
        if ro["probe_fail_at"] >= 0 and flip_idx == ro["probe_fail_at"]:
            rep.route_ok = True     # back into routing on the OLD weights
            self.cluster.trace.rec(clock.monotonic(),
                                   "rollout_probe_fail",
                                   rid=ro["id"], node=nid, flip=flip_idx)
            self._fail(ro, f"probe failed on {nid}")
            return
        rep.version = ro["to"]
        rep.route_ok = True
        ro["flipped"] += 1
        self.cluster.trace.rec(clock.monotonic(), "rollout_flip",
                               rid=ro["id"], node=nid, version=ro["to"],
                               flipped=ro["flipped"])
        clock.call_later(_FLIP_GAP_S, lambda: self._flip_next(ro))

    # -- terminal transitions ------------------------------------------------
    def _seal(self, ro: dict) -> None:
        now = self.cluster.clock.monotonic()
        delta = [h - p for h, p in zip(self.plane._hist, ro["pre_hist"])]
        ro["during_p99_s"] = _q(delta, 0.99)
        ro["phase"] = phases.SEALED
        ro["t_done"] = now
        self.serving = ro["to"]
        self.cluster.trace.rec(now, "rollout_sealed", rid=ro["id"],
                               version=ro["to"], flipped=ro["flipped"],
                               seconds=round(now - ro["t_start"], 4))
        self._finish(ro)

    def _fail(self, ro: dict, error: str) -> None:
        """Roll back: re-tag every already-flipped live replica to the
        retained old version (the retained artifact is replica-local
        after the broadcast, so the re-flip needs no second wave)."""
        now = self.cluster.clock.monotonic()
        ro["error"] = error
        rolled = 0
        for nid in sorted(self.plane.replicas):
            rep = self.plane.replicas[nid]
            if rep.alive and rep.version == ro["to"]:
                rep.version = ro["from"]
                rolled += 1
        delta = [h - p for h, p in zip(self.plane._hist, ro["pre_hist"])]
        ro["during_p99_s"] = _q(delta, 0.99)
        ro["phase"] = phases.ROLLED_BACK
        ro["t_done"] = now
        self.cluster.trace.rec(now, "rollout_rolled_back", rid=ro["id"],
                               error=error, reflipped=rolled,
                               seconds=round(now - ro["t_start"], 4))
        self._finish(ro)

    def _finish(self, ro: dict) -> None:
        ro.pop("wave", None)        # waves stay in cluster.broadcast_waves
        ro.pop("pre_hist", None)
        self.session_pins.clear()   # pins only span an active rollout
        self.active = None
        if self.queued:
            artifact, pf = self.queued.pop(0)
            self.cluster.clock.call_later(
                _FLIP_GAP_S,
                lambda: self.start_rollout(artifact, probe_fail_at=pf))

    # -- serve-plane hooks (every one gated on plane.rollout) ----------------
    def _pin_target(self) -> str:
        """The version a NEW session pins to.  Once the flip frontier
        is moving, new sessions ride the new version — otherwise every
        live session funnels onto the shrinking old-version subset and
        the flip tail melts down mid-peak (old sessions keep their old
        pin until they go idle, exactly like live traffic draining off
        a blue/green edge)."""
        ro = self.active
        if ro is not None and ro["phase"] == phases.FLIPPING and \
                ro["flipped"] > 0:
            return ro["to"]
        return self.serving

    def note_arrival(self, rid: int, session: int, now: float) -> None:
        self.req_session[rid] = session
        if self.active is None:
            return
        pin = self.session_pins.get(session)
        if pin is None or now - pin[1] > self.idle_s:
            # new session (or one idle past the pin window, i.e. ended):
            # pin to the frontier version
            self.session_pins[session] = [self._pin_target(), now]
        else:
            pin[1] = now

    def filter_candidates(self, rid: int, live: list) -> list:
        """Restrict dispatch candidates to the session's pinned
        version; migrate the pin when that version has no live replica
        left, or — at a request boundary, so every single request still
        sees exactly one version — when the pinned side has started
        queuing wall-to-wall (every pinned-version replica at
        ``replica_cap``) while the frontier version has headroom.
        Without the saturation valve a long-lived session population
        funnels onto the shrinking old-version subset as the flip
        frontier advances and the tail of the flip melts down mid-peak.
        Pins only ever move FORWARD (old -> frontier), never back.
        Always returns a non-empty subset of ``live``."""
        session = self.req_session.get(rid)
        pin = None if session is None else self.session_pins.get(session)
        if pin is None:
            self.req_tag.pop(rid, None)
            return live
        subset = [r for r in live if r.version == pin[0]]
        cap = self.plane.p.replica_cap
        if subset and min(r.load() for r in subset) >= cap:
            tgt = self._pin_target()
            if tgt != pin[0]:
                ahead = [r for r in live if r.version == tgt]
                if ahead and min(r.load() for r in ahead) < \
                        min(r.load() for r in subset):
                    pin[0] = tgt
                    self.migrations += 1
                    subset = ahead
        if not subset:
            if pin[0] != self.serving:
                pin[0] = self.serving
                self.migrations += 1
                subset = [r for r in live if r.version == pin[0]]
            if not subset:
                # nothing on the serving version either (mass kill):
                # serving the session beats stalling it
                self.req_tag.pop(rid, None)
                return live
        self.req_tag[rid] = pin[0]
        return subset

    def on_complete(self, rid: int, version: str) -> None:
        self.req_session.pop(rid, None)
        expected = self.req_tag.pop(rid, None)
        if expected is not None and version != expected:
            self.mixed_served += 1

    def on_replica_added(self, nid: str) -> None:
        """Graft-on-pull: a replica joining mid-rollout adopts the
        phase-appropriate version (it pulls the staged artifact from
        the nearest sealed peer rather than re-running the wave)."""
        rep = self.plane.replicas.get(nid)
        if rep is None:
            return
        ro = self.active
        if ro is not None and ro["phase"] == phases.FLIPPING:
            rep.version = ro["to"]
            self.grafts += 1
            self.cluster.trace.rec(self.cluster.clock.monotonic(),
                                   "rollout_graft", rid=ro["id"],
                                   node=nid, version=ro["to"])
        else:
            rep.version = self.serving

    # -- invariants ----------------------------------------------------------
    @property
    def all_terminal(self) -> bool:
        return self.active is None and not self.queued and \
            all(ro["phase"] in phases.TERMINAL for ro in self.rollouts)

    def check(self, strict: bool = False, now: float | None = None,
              grace: float = 10.0) -> tuple[list[str], int]:
        """Rollout invariants, called from
        :func:`sim.invariants.check_invariants`."""
        from .invariants import fmt_violation

        violations: list[str] = []
        checks = 0
        if now is None:
            now = self.cluster.clock.monotonic()
        checks += 1
        if self.mixed_served:
            violations.append(fmt_violation(
                "version-mixed-session", now,
                f"{self.mixed_served} requests served off their "
                f"session's pinned version"))
        checks += 1
        for ro in self.rollouts:
            if ro["phase"] not in phases.TERMINAL and \
                    not ro["old_retained"]:
                violations.append(fmt_violation(
                    "old-version-retained", now,
                    f"rollout {ro['id']} dropped old version "
                    f"{ro['from']} before seal"))
        if strict:
            checks += 1
            open_n = sum(1 for ro in self.rollouts
                         if ro["phase"] not in phases.TERMINAL)
            if open_n or self.queued:
                violations.append(fmt_violation(
                    "rollout-terminal", now,
                    f"{open_n} rollouts not SEALED/ROLLED_BACK and "
                    f"{len(self.queued)} still queued after quiesce"))
        return violations, checks

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        sealed = sum(1 for r in self.rollouts
                     if r["phase"] == phases.SEALED)
        rolled = sum(1 for r in self.rollouts
                     if r["phase"] == phases.ROLLED_BACK)
        return {
            "serving": self.serving,
            "rollouts": len(self.rollouts),
            "sealed": sealed,
            "rolled_back": rolled,
            "mixed_served": self.mixed_served,
            "migrations": self.migrations,
            "grafts": self.grafts,
            "per_rollout": [{
                "id": r["id"], "from": r["from"], "to": r["to"],
                "phase": r["phase"], "flipped": r["flipped"],
                "replicas": r["replicas"], "error": r["error"],
                "pre_p99_s": r["pre_p99_s"],
                "during_p99_s": r["during_p99_s"],
                "seconds": None if r["t_done"] is None else
                round(r["t_done"] - r["t_start"], 4),
            } for r in self.rollouts],
        }

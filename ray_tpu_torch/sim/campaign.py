"""Scripted chaos campaigns over the simulated cluster.

A campaign is a deterministic schedule — built up-front from one Philox
generator keyed by the seed — of background job load plus injected
faults: rolling SIGKILLs, asymmetric partitions, gray-slow links,
drain-under-churn, autoscaler flapping.  The runner executes it on the
virtual clock, checks every invariant after every injected event, then
quiesces (heal everything, restart a dead head, let recovery finish)
and applies the strict final check: every acked job SUCCEEDED.

Every run emits a replayable trace artifact keyed by seed: re-running
``ray_tpu_torch simulate`` with the same (nodes, seed, campaign, faults,
duration) reproduces the identical event trace, asserted by comparing
the sha256 trace hash.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field

from dataclasses import replace

from ..rpc.chaos import _Params
from ..rpc.client import RpcConnectionError
from .cluster import HEAD_ADDR, STANDBY_ADDR, SimCluster, SimParams
from .invariants import check_invariants

__all__ = ["CAMPAIGNS", "CampaignResult", "run_campaign",
           "build_schedule"]

CAMPAIGNS = ("mixed", "rolling_kill", "partitions", "gray_slow",
             "drain_churn", "autoscaler_flap", "broadcast_storm",
             "serve_diurnal", "head_failover_storm",
             "serve_rolling_update", "train_diurnal")

# the failover storm snaps task durations to a small class set so the
# job stream is a repeat-class workload — the shape the lease plane's
# origin routing serves locally
_STORM_CLASSES = (2.0, 4.0, 6.0, 9.0, 12.0, 15.0)

_SETTLE_CAP_S = 900.0       # virtual budget for the quiesce phase


@dataclass
class CampaignResult:
    nodes: int
    seed: int
    campaign: str
    faults_injected: int
    jobs_acked: int
    jobs_completed: int
    events_fired: int
    invariant_checks: int
    violations: list = field(default_factory=list)
    trace_hash: str = ""
    virtual_s: float = 0.0
    wall_s: float = 0.0
    stats: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "nodes": self.nodes, "seed": self.seed,
            "campaign": self.campaign,
            "faults_injected": self.faults_injected,
            "jobs_acked": self.jobs_acked,
            "jobs_completed": self.jobs_completed,
            "events_fired": self.events_fired,
            "invariant_checks": self.invariant_checks,
            "violations": list(self.violations),
            "trace_hash": self.trace_hash,
            "virtual_s": round(self.virtual_s, 3),
            "wall_s": round(self.wall_s, 3),
            "events_per_sec": round(
                self.events_fired / max(self.wall_s, 1e-9)),
            "ok": self.ok,
            "stats": self.stats,
        }


def _node_addr(idx: int) -> str:
    return f"sim://n{idx:05d}"


def build_schedule(campaign: str, rng, num_nodes: int, faults: int,
                   duration: float) -> tuple[list, list]:
    """Deterministic (jobs, faults) schedules.  ``jobs`` is
    ``(t, jid, {tid: duration})``; ``faults`` is ``(t, op, kwargs)``,
    time-sorted with ties broken by build order.  All draws come from
    ``rng`` in a fixed order, so the schedule is a pure function of
    (campaign, seed, nodes, faults, duration)."""
    if campaign not in CAMPAIGNS:
        raise ValueError(f"unknown campaign {campaign!r}; "
                         f"choose from {', '.join(CAMPAIGNS)}")
    storm = campaign == "head_failover_storm"
    jobs = []
    n_jobs = max(8, min(400, num_nodes // 4))
    for k in range(n_jobs):
        t = float(rng.uniform(1.0, duration * 0.7))
        n_tasks = int(rng.integers(2, 9))
        jid = f"job{k:04d}"
        if storm:
            tasks = {f"{jid}.t{i}":
                     _STORM_CLASSES[int(rng.integers(
                         0, len(_STORM_CLASSES)))]
                     for i in range(n_tasks)}
        else:
            tasks = {f"{jid}.t{i}":
                     round(float(rng.uniform(2.0, 18.0)), 3)
                     for i in range(n_tasks)}
        jobs.append((t, jid, tasks))
    jobs.sort(key=lambda e: e[0])

    # fault mix per campaign archetype (weights over op kinds)
    mixes = {
        "mixed": (("kill_node", 0.3), ("partition", 0.25),
                  ("gray_slow", 0.15), ("drain", 0.2),
                  ("kill_head", 0.1)),
        "rolling_kill": (("kill_node", 0.9), ("kill_head", 0.1)),
        "partitions": (("partition", 0.85), ("kill_head", 0.15)),
        "gray_slow": (("gray_slow", 0.8), ("partition", 0.2)),
        "drain_churn": (("drain", 0.7), ("kill_node", 0.3)),
        "autoscaler_flap": (("drain", 0.4), ("kill_node", 0.4),
                            ("gray_slow", 0.2)),
        # weight-distribution waves racing relay-node/root kills and
        # gray links: the broadcast plane's re-parenting under fire
        "broadcast_storm": (("broadcast", 0.45), ("kill_node", 0.3),
                            ("gray_slow", 0.15), ("kill_head", 0.1)),
        # diurnal serve load driving loan->serve->reclaim while kills
        # land on replicas and LOANED rows: the capacity-loan state
        # machine and request re-dispatch under fire
        "serve_diurnal": (("kill_node", 0.5), ("gray_slow", 0.2),
                          ("drain", 0.2), ("kill_head", 0.1)),
        # rolling head SIGKILLs under churn + asymmetric partitions:
        # no scripted restarts — the hot standby must promote every
        # time, and the lease plane must keep dispatching through it
        "head_failover_storm": (("kill_head", 0.35),
                                ("partition", 0.3),
                                ("kill_node", 0.25),
                                ("gray_slow", 0.1)),
        # rolling weight hot-swaps landing mid-peak while kills hit
        # replicas (and the head, mid-broadcast): the model-version
        # plane's flip/rollback machinery and session pinning under fire
        "serve_rolling_update": (("rollout", 0.25), ("kill_node", 0.35),
                                 ("gray_slow", 0.15), ("drain", 0.15),
                                 ("kill_head", 0.1)),
        # train + serve sharing one pool under a diurnal day: rolling
        # SIGKILLs land on gang members, serve replicas and borrowed
        # rows, a head kill lands mid-epoch, drains force planned
        # resizes — loans must flow BOTH directions and acked epochs
        # must never regress
        "train_diurnal": (("kill_node", 0.5), ("drain", 0.2),
                          ("gray_slow", 0.15), ("kill_head", 0.15)),
    }
    ops, weights = zip(*mixes[campaign])
    sched = []
    window = (duration * 0.05, duration * 0.85)
    head_kills = 0
    rollouts = 0
    for _ in range(faults):
        t = float(rng.uniform(*window))
        u = float(rng.random())
        acc, op = 0.0, ops[-1]
        for name, w in zip(ops, weights):
            acc += w
            if u < acc:
                op = name
                break
        target = int(rng.integers(0, num_nodes))
        heal_after = float(rng.uniform(8.0, 25.0))
        if op == "kill_head":
            # bounded: restarts must not overlap (storm runs deeper —
            # the standby chain absorbs each kill, no scripted restart)
            if head_kills >= (4 if storm else 2):
                op = "kill_node"
            else:
                head_kills += 1
                sched.append((t, "kill_head", {}))
                if not storm:
                    sched.append((t + heal_after, "restart_head", {}))
                continue
        if op == "partition":
            kind = int(rng.integers(0, 4 if storm else 3))
            addr = _node_addr(target)
            if kind == 0:       # asymmetric: head cannot reach node
                pairs = [(HEAD_ADDR, addr)]
            elif kind == 1:     # asymmetric: node cannot reach head
                pairs = [(addr, HEAD_ADDR)]
            elif kind == 3:     # asymmetric: standby blind to a live
                pairs = [(STANDBY_ADDR, HEAD_ADDR)]     # head (no
            else:               # split-brain: nodes don't vote)
                pairs = [(HEAD_ADDR, addr), (addr, HEAD_ADDR)]
            sched.append((t, "partition", {"pairs": pairs}))
            sched.append((t + heal_after, "heal", {"pairs": pairs}))
            continue
        if op == "gray_slow":
            addr = _node_addr(target)
            sched.append((t, "gray_slow", {"addr": addr}))
            sched.append((t + heal_after, "gray_heal", {"addr": addr}))
            continue
        if op == "rollout":
            # land mid-peak (the acceptance window the bench measures);
            # a quarter of rollouts carry an injected probe failure so
            # the rollback path is exercised, not just the happy seal
            t_roll = float(rng.uniform(duration * 0.30,
                                       duration * 0.65))
            pf = float(rng.random())
            rollouts += 1
            sched.append((t_roll, "rollout", {
                "artifact": f"weights-{rollouts:03d}",
                "probe_fail_at": target % 8 if pf < 0.25 else -1,
            }))
            continue
        if op == "broadcast":
            count = int(rng.integers(max(2, num_nodes // 3),
                                     num_nodes + 1))
            rows = sorted(int(x) for x in rng.choice(
                num_nodes, size=min(count, num_nodes), replace=False))
            sched.append((t, "broadcast", {
                "members": [f"n{r:05d}" for r in rows],
                "size_mb": int(rng.integers(64, 1025)),
                "fanout": int(rng.integers(2, 5)),
            }))
            continue
        sched.append((t, op, {"node": f"n{target:05d}"}))
    sched.sort(key=lambda e: e[0])
    return jobs, sched


def run_campaign(num_nodes: int, seed: int = 0, campaign: str = "mixed",
                 faults: int = 50, duration: float | None = None,
                 params: SimParams | None = None,
                 autoscale: bool = True, lock_order: bool = False,
                 serve: dict | None = None,
                 train: dict | None = None,
                 out: str | None = None, progress=None,
                 schedule: list | None = None,
                 coverage=None) -> CampaignResult:
    """Execute one campaign; returns a :class:`CampaignResult` whose
    ``trace_hash`` is the replay fingerprint.

    ``schedule`` overrides the generated fault schedule with an explicit
    ``[(t, op, kwargs), ...]`` list (a hunt genome).  The job load is
    still a pure function of (campaign, seed, nodes, duration) — job
    draws precede fault draws on the Philox stream — so a (base args,
    schedule) pair replays bit-identically.  ``coverage`` is an optional
    sink (``hunt.RunCoverage``) attached to the trace; it observes every
    event but never feeds the replay hash."""
    import numpy as np

    if duration is None:
        duration = max(180.0, faults * 4.0)
    wall0 = time.perf_counter()
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 20000))

    rng = np.random.Generator(np.random.Philox(
        key=[int(seed) & (2 ** 64 - 1), 0xC0FFEE]))
    jobs, sched = build_schedule(campaign, rng, num_nodes, faults,
                                 duration)
    if schedule is not None:
        sched = sorted(((float(t), op, dict(kw))
                        for t, op, kw in schedule), key=lambda e: e[0])

    if campaign == "head_failover_storm":
        # the storm IS the lease plane + hot standby under fire
        params = replace(params or SimParams.from_config(),
                         lease_plane=True, standby=True)
    cluster = SimCluster(num_nodes, seed=seed, params=params)
    if coverage is not None:
        cluster.trace.cov = coverage
    plane = None
    rplane = None
    tplane = None
    if campaign in ("serve_diurnal", "serve_rolling_update",
                    "train_diurnal"):
        from .serve import SimServePlane
        plane = SimServePlane(cluster, seed=seed, duration=duration,
                              **(serve or {}))
        cluster.serve_plane = plane
    if campaign == "serve_rolling_update":
        from .rollout import SimRolloutPlane
        rplane = SimRolloutPlane(cluster, plane)
    if campaign == "train_diurnal":
        from .train import SimTrainPlane
        tplane = SimTrainPlane(cluster, duration=duration,
                               serve=plane, **(train or {}))
        cluster.train_plane = tplane
    if lock_order:
        from ..common import lockorder
        if not lockorder.installed():
            lockorder.install()
    acked: list[str] = []
    waves: list = []            # SimBroadcastWave, launch order
    # invariants (bcast-reparent-cycle) audit the live waves directly
    cluster.broadcast_waves = waves
    completed_cache = {"n": 0}
    fault_count = {"n": 0}
    inv_checks = {"n": 0}
    violations: list[str] = []
    clock, trace = cluster.clock, cluster.trace
    driver = cluster.transport.connect(HEAD_ADDR, _sim_src="driver")

    def submit(jid, tasks, attempt=0):
        try:
            if driver.call("job_submit", jid, tasks) == "ack":
                acked.append(jid)
                return
        except RpcConnectionError:
            pass
        if attempt < 40:        # head may be down: keep retrying
            clock.call_later(3.0, lambda: submit(jid, tasks,
                                                 attempt + 1))

    def check(stage):
        v, n = check_invariants(cluster, acked)
        inv_checks["n"] += n
        trace.rec(clock.monotonic(), "invariant_check", stage=stage,
                  checks=n, violations=len(v))
        for msg in v:
            if len(violations) < 100:
                violations.append(f"[{stage}] {msg}")

    def apply_fault(op, kw):
        t = clock.monotonic()
        if op == "kill_head":
            cluster.kill_head()
            for w in waves:
                w.on_node_killed("head")
            trace.rec(t, "fault", op=op)
        elif op == "restart_head":
            if cluster.head is None:
                cluster.start_head()
            trace.rec(t, "fault", op=op)
        elif op == "kill_node":
            hit = cluster.kill_node(kw["node"])
            if hit:
                for w in waves:
                    w.on_node_killed(kw["node"])
                if plane is not None:
                    plane.on_node_killed(kw["node"])
                if tplane is not None:
                    tplane.on_node_killed(kw["node"])
            trace.rec(t, "fault", op=op, node=kw["node"], hit=hit)
        elif op == "rollout":
            rid = ""
            if rplane is not None:
                rid = rplane.start_rollout(
                    kw["artifact"],
                    probe_fail_at=kw.get("probe_fail_at", -1))
            trace.rec(t, "fault", op=op, artifact=kw["artifact"],
                      probe_fail_at=kw.get("probe_fail_at", -1),
                      rollout=rid)
        elif op == "broadcast":
            from .broadcast import SimBroadcastWave
            w = SimBroadcastWave(cluster, f"w{len(waves)}",
                                 kw["members"], size_mb=kw["size_mb"],
                                 fanout=kw["fanout"])
            waves.append(w)
            w.start()
            trace.rec(t, "fault", op=op, wave=w.wave_id,
                      members=len(kw["members"]),
                      size_mb=kw["size_mb"], fanout=kw["fanout"])
        elif op == "drain":
            ok = False
            if cluster.head is not None and cluster.head.alive:
                ok = cluster.head.start_drain(kw["node"], "campaign")
            trace.rec(t, "fault", op=op, node=kw["node"], hit=ok)
        elif op == "partition":
            for pair in kw["pairs"]:
                cluster.chaos.partitions.add(tuple(pair))
            trace.rec(t, "fault", op=op, pairs=kw["pairs"])
        elif op == "heal":
            for pair in kw["pairs"]:
                cluster.chaos.partitions.discard(tuple(pair))
            trace.rec(t, "fault", op=op, pairs=kw["pairs"])
        elif op == "gray_slow":
            cluster.chaos.links[kw["addr"]] = _Params(
                drop_p=0.25, dup_p=0.05, delay_p=0.9, delay_ms=350.0)
            trace.rec(t, "fault", op=op, addr=kw["addr"])
        elif op == "gray_heal":
            cluster.chaos.links.pop(kw["addr"], None)
            trace.rec(t, "fault", op=op, addr=kw["addr"])
        fault_count["n"] += 1
        check(f"after:{op}")

    try:
        with cluster:
            if autoscale:
                cluster.enable_autoscaler(
                    min_nodes=num_nodes,
                    max_nodes=num_nodes + max(8, num_nodes // 10))
            if plane is not None:
                plane.start()
            if tplane is not None:
                tplane.start()
            for t, jid, tasks in jobs:
                clock.call_later(
                    t, lambda jid=jid, tasks=tasks: submit(jid, tasks))
            for t, op, kw in sched:
                clock.call_later(
                    t, lambda op=op, kw=kw: apply_fault(op, kw))

            clock.run_until(duration)
            if progress:
                progress(f"campaign phase done at t={duration:.0f}s "
                         f"virtual, {fault_count['n']} faults")

            # -- quiesce: heal the world, let recovery converge ----------
            cluster.chaos.partitions.clear()
            cluster.chaos.links.clear()
            if cluster.head is None and cluster.standby is None:
                # with a hot standby, promotion — not a scripted
                # restart — brings the head back (racing start_head
                # against it would double-bind the head address)
                cluster.start_head()
            trace.rec(clock.monotonic(), "quiesce")

            def all_done():
                head = cluster.head
                if head is None or not head.alive:
                    return False
                done = sum(1 for jid in acked
                           if head.jobs.get(jid, {}).get("status") ==
                           "succeeded")
                completed_cache["n"] = done
                return done == len(acked) and \
                    all(w.terminal for w in waves) and \
                    (plane is None or plane.terminal) and \
                    (rplane is None or rplane.all_terminal) and \
                    (tplane is None or tplane.terminal)

            settle_end = duration + _SETTLE_CAP_S
            while not all_done() and clock.monotonic() < settle_end:
                clock.advance(cluster.params.heartbeat_period_s)
            check("final")
            v, n = check_invariants(cluster, acked, strict=True)
            inv_checks["n"] += n
            trace.rec(clock.monotonic(), "invariant_check",
                      stage="final_strict", checks=n, violations=len(v))
            for msg in v:
                if len(violations) < 100:
                    violations.append(f"[final] {msg}")
            all_done()
    finally:
        cluster.close()
        sys.setrecursionlimit(old_limit)

    wall = time.perf_counter() - wall0
    result = CampaignResult(
        nodes=num_nodes, seed=int(seed), campaign=campaign,
        faults_injected=fault_count["n"], jobs_acked=len(acked),
        jobs_completed=completed_cache["n"],
        events_fired=clock.fired, invariant_checks=inv_checks["n"],
        violations=violations, trace_hash=trace.hash(),
        virtual_s=clock.monotonic(), wall_s=wall,
        stats=cluster.stats())
    if plane is not None:
        result.stats["serve"] = plane.stats()
    if rplane is not None:
        result.stats["rollout"] = rplane.stats()
    if tplane is not None:
        result.stats["train"] = tplane.stats()
    if out:
        write_artifact(out, result, trace, duration, faults,
                       schedule=schedule, params=cluster.params)
    return result


# config-knob prefixes snapshotted into every trace artifact: the full
# resolved values reproduction depends on, so a replay is a pure
# function of the artifact, never of the ambient env
_KNOB_PREFIXES = ("chaos_", "lease_", "serve_", "sim_", "standby_",
                  "rollout_", "version_", "train_", "collective_",
                  "rpc_breaker_", "rtlint_runtime_lock_order",
                  "rtlint_runtime_locksets")


def knob_snapshot() -> dict:
    """Resolved ``chaos_*``/``lease_*``/``serve_*``/``sim_*``/
    ``standby_*`` knob values at run time (env overrides folded in)."""
    from ..common.config import get_config
    cfg = get_config().to_dict()
    return {k: cfg[k] for k in sorted(cfg)
            if k.startswith(_KNOB_PREFIXES)}


def write_artifact(path: str, result: CampaignResult, cluster_trace,
                   duration: float | None, faults: int | None = None,
                   extra: dict | None = None,
                   schedule: list | None = None,
                   params: SimParams | None = None) -> None:
    """The replayable trace artifact: seed + parameters reproduce the
    run; the hash proves the reproduction matched.  ``replay`` holds
    the exact ``run_campaign`` arguments (``faults`` is the *requested*
    count — the schedule key — not the injected total; an explicit
    ``schedule`` override is embedded verbatim), ``knobs`` the full
    resolved config the run saw and ``params`` the resolved
    :class:`SimParams` — so reproduction is a pure function of the
    artifact, not of the ambient env."""
    from dataclasses import asdict

    doc = {
        "format": "ray_tpu-sim-trace/1",
        "replay": {"nodes": result.nodes, "seed": result.seed,
                   "campaign": result.campaign, "faults": faults,
                   "duration": duration},
        "knobs": knob_snapshot(),
        "result": result.to_dict(),
        "events_total": cluster_trace.total,
        "events_stored": len(cluster_trace.events),
        "events": cluster_trace.events,
    }
    if schedule is not None:
        doc["replay"]["schedule"] = [[t, op, kw]
                                     for t, op, kw in schedule]
    if params is not None:
        doc["params"] = asdict(params)
    if extra:
        doc.update(extra)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")

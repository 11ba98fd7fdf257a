"""The invariants a campaign checks after every injected event.

Each check returns a list of violation strings; the campaign runner
fails (and the trace artifact records the violation) the moment one is
non-empty.  Checks are grace-aware: a transiently broken state (a lease
on a just-killed node, a drain mid-flight) is NOT a violation until the
recovery machinery has had its deadline plus slack to act.  With the
head down, head-derived checks are skipped (the campaign always
restarts the head before the final strict pass).

Every violation string is self-describing — ``[inv:<name> @t=<virtual
seconds>] <detail>`` — so a failing campaign surfaces WHICH invariant
fired and WHEN without digging through the trace; ``violation_names``
parses the name back out (the hunt's failure signature and the
minimizer's reproduction predicate both key on it).

The invariants, and the machinery each one proves:

- **acked-job-lost** — persistence-before-ack + head restore (doubles
  as the failover check: acked jobs must survive a standby promotion,
  because promotion is just ``start_head()`` over the same persisted
  tables)
- **lease-stuck** / **leased-quiet** — lost-ack lease requeue + death
  declaration; lease-plane form: a locally-admitted grant the raylet
  stopped reporting must be revoked+requeued by the TTL sweep
- **drain-stuck** — drain protocol + deadline force-removal
- **lineage-hole** / **job-incomplete** (strict) — object-loss repair
  by re-running producers (a job whose lost outputs were never rebuilt
  cannot finish)
- **lock-order-cycle** — the runtime lock-order recorder
  (``common/lockorder.py``), when installed, over the real locks the
  simulation exercises (chaos links, breakers)
- **serve-accounting** / **serve-conservation** / **loan-drain-stuck**
  / **loan-conservation** / **serve-incomplete** / **loans-outstanding**
  — the serve plane (when a ``serve_diurnal`` campaign installed one):
  every accepted request is accounted for in some queue (strictly:
  completed), and capacity loans conserve —
  ``loans_total == active + reclaimed + lost`` even across
  SIGKILL-mid-reclaim — and converge to reclaimed-or-booked-lost
- **lease-double-exec** — lease plane (r15): once the head revokes a
  node's epoch, no task may *start* on that node under the revoked
  epoch past the grace window.  The raylet self-fences at the same
  horizon the head uses to declare it dead, so every start in
  ``cluster.exec_log`` must carry an epoch that is current for its
  node — or predate the revocation + grace.
- **object-copies** (r16) — the head's object registry never claims a
  replica on a node it has itself declared DEAD/REMOVED: no object is
  "lost" behind a phantom copy while a real replica's node is alive.
  Death declaration, drain removal and late gray-window done-acks must
  all keep the copy map consistent with the node table.
- **bcast-reparent-cycle** (r16) — broadcast re-parenting never forms
  a cycle: every live member of an active wave reaches the root
  through finitely many parents.
- **bcast-wave-terminal** / **bcast-live-replica** (strict) — by
  quiesce every wave reached a terminal state and every live member
  holds a full replica (previously inline in the campaign runner).
- **revocation-epoch-monotonic** (r16) — a node's revocation epochs
  strictly increase, across head kills and standby promotions: a
  promoted head that re-issued a journaled epoch would break the
  at-most-once execution fence.
- **budget-conservation** (r17) — with the lease plane on, a raylet's
  locally-admitted count for a class never exceeds the budget the head
  emitted for it under the node's current epoch (the closed dispatch
  loop: budgets priced by the scheduling beat must bound what the
  local cache actually admits).  Nodes mid-revocation (cache epoch
  behind the grantor's) and classes the grantor LRU-evicted (eviction
  does not bump the epoch) are out of scope.
- **goodput-accounting** / **ckpt-durable** / **gang-terminal**
  (r19) — the training plane (when a ``train_diurnal`` campaign
  installed one): committed samples, the KV epoch journal and the
  acked-epoch counter agree, and acked epochs never regress (the
  journal is written only after checkpoint replication, so a head kill
  or standby promotion can stall an ack but never roll one back); the
  newest acked checkpoint always holds a live copy and re-replicates
  to ``train_ckpt_replicas`` within the replication grace after a
  copy-holder dies; strictly, training reaches its terminal state by
  quiesce with every borrowed serve row returned and every
  reservation released.
- **version-mixed-session** / **rollout-terminal** /
  **old-version-retained** (r18) — the model-version plane (when a
  ``serve_rolling_update`` campaign installed one): no accepted
  request is served off its session's pinned version (session-sticky
  routing keeps every live session on ONE version across the flip
  sequence; the pin migrates forward — at a request boundary — only
  when its version has no live replica left or is queuing
  wall-to-wall while the frontier has headroom, so per-request
  consistency holds either way); strictly, every rollout reaches
  SEALED or ROLLED_BACK by
  quiesce; and an in-flight rollout never drops the old version's
  retained artifact before seal (rollback must always have weights to
  re-flip onto).
"""

from __future__ import annotations

import re

__all__ = ["check_invariants", "INVARIANTS", "violation_names"]

# name -> what the invariant proves (the fire/quiet twin tests and the
# hunt's coverage signal both enumerate this registry)
INVARIANTS = {
    "acked-job-lost": "persist-before-ack + head restore/promotion",
    "lease-stuck": "lost-ack lease requeue by the monitor",
    "leased-quiet": "quiet locally-admitted grants revoked by TTL sweep",
    "drain-stuck": "drain convergence + deadline force-removal",
    "lineage-hole": "lost outputs rebuilt by re-running producers",
    "job-incomplete": "strict final: every acked job SUCCEEDED",
    "lock-order-cycle": "runtime lock acquisition digraph acyclic",
    "serve-accounting": "outstanding counter == structural queue sum",
    "serve-conservation": "accepted == completed + outstanding",
    "loan-drain-stuck": "loan reclaim drains converge by deadline",
    "loan-conservation": "loans_total == active + reclaimed + lost",
    "serve-incomplete": "strict final: every accepted request completed",
    "loans-outstanding": "strict final: no loan left unreclaimed",
    "lease-double-exec": "no start under a revoked epoch past grace",
    "object-copies": "no phantom replica on a DEAD/REMOVED node",
    "bcast-reparent-cycle": "broadcast parent chains stay acyclic",
    "revocation-epoch-monotonic": "revocation epochs strictly increase",
    "bcast-wave-terminal": "strict final: every wave reaches terminal",
    "bcast-live-replica": "strict final: live wave members hold replicas",
    "budget-conservation":
        "locally-admitted grants never exceed head-emitted budgets",
    "version-mixed-session":
        "no request served off its session's pinned model version",
    "rollout-terminal": "strict final: every rollout SEALED/ROLLED_BACK",
    "old-version-retained": "old weights retained until the seal",
    "goodput-accounting":
        "committed samples == journal; acked epochs never regress",
    "ckpt-durable": "newest acked checkpoint keeps live replicated copies",
    "gang-terminal": "strict final: training terminal, borrows returned",
}

_NAME_RE = re.compile(r"\[inv:([a-z0-9-]+) @t=")


def violation_names(violations) -> frozenset:
    """The set of invariant names present in a violation list — the
    failure signature the hunt dedupes on and the minimizer preserves."""
    names = set()
    for v in violations:
        m = _NAME_RE.search(v)
        if m:
            names.add(m.group(1))
    return frozenset(names)


def fmt_violation(name: str, now: float, msg: str) -> str:
    return f"[inv:{name} @t={now:.1f}] {msg}"


def _check_exec_log(cluster, grace: float, now: float
                    ) -> tuple[list[str], int]:
    """Scan lease-plane starts against the revocation log.  Incremental:
    starts already audited are dropped, so a 10k-node campaign pays for
    each start once.  A start under epoch ``e`` on node ``n`` violates
    iff some revocation ``(e_r, t_r)`` of ``n`` has ``e_r > e`` and the
    start happened after ``t_r + grace`` (inside the window the
    recovery machinery is still allowed to race)."""
    violations: list[str] = []
    log = cluster.exec_log
    checks = len(log)
    for tid, nid, epoch, t_start in log:
        if epoch < 0:
            continue        # non-lease exec path start: out of scope
        revs = cluster.revocation_log.get(nid)
        if not revs:
            continue
        for e_r, t_r in revs:
            if e_r > epoch and t_start > t_r + grace:
                violations.append(fmt_violation(
                    "lease-double-exec", now,
                    f"{tid} started on {nid} at t={t_start:.3f} under "
                    f"epoch {epoch}, revoked to {e_r} at t={t_r:.3f}"))
                break
    # a start can never become violating later (a future revocation's
    # t_r is >= now > t_start): audited entries are done for good
    cluster.exec_audited += checks
    del log[:]
    return violations, checks


def _check_object_copies(head, now: float) -> tuple[list[str], int]:
    """object-copies: every replica the registry claims lives on a node
    the head still considers ALIVE or DRAINING.  Death declaration and
    removal scrub synchronously, so no grace window is needed."""
    violations: list[str] = []
    checks = 0
    dead_rows = {nid for nid, row in head.nodes.items()
                 if row["state"] in ("dead", "removed")}
    for oid, obj in head.objects.items():
        checks += 1
        if not dead_rows:
            continue
        phantom = [nid for nid in obj["copies"] if nid in dead_rows]
        if phantom:
            violations.append(fmt_violation(
                "object-copies", now,
                f"{oid} claims replicas on dead/removed "
                f"{','.join(phantom)} (live copies: "
                f"{len(obj['copies']) - len(phantom)})"))
    return violations, checks


def _check_broadcast_cycles(cluster, now: float) -> tuple[list[str], int]:
    """bcast-reparent-cycle: in every active wave, each live member's
    parent chain reaches the root in <= |members|+1 hops."""
    violations: list[str] = []
    checks = 0
    waves = getattr(cluster, "broadcast_waves", None) or ()
    for w in waves:
        if w.t_done is not None:
            continue
        bound = len(w.members) + 1
        ok: set = {w.root}
        for m in w.members:
            if not w._alive(m):
                continue
            checks += 1
            node, path, hops = m, [], 0
            while node is not None and node not in ok and hops <= bound:
                path.append(node)
                node = w.parent_of.get(node)
                hops += 1
            if hops > bound:
                violations.append(fmt_violation(
                    "bcast-reparent-cycle", now,
                    f"wave {w.wave_id}: {m}'s parent chain cycles "
                    f"({'->'.join(path[:6])}...)"))
            else:
                ok.update(path)
    return violations, checks


def _check_waves_final(cluster, now: float) -> tuple[list[str], int]:
    """Strict final wave checks: every wave terminal, every live member
    holding a full replica (re-parenting converged, no lost chunks — a
    completed member received every chunk exactly once by construction
    of the delivery model)."""
    violations: list[str] = []
    checks = 0
    for w in (getattr(cluster, "broadcast_waves", None) or ()):
        checks += 1
        if not w.terminal:
            violations.append(fmt_violation(
                "bcast-wave-terminal", now,
                f"broadcast wave {w.wave_id} never became terminal"))
            continue
        left = w.unreached_live()
        if left:
            violations.append(fmt_violation(
                "bcast-live-replica", now,
                f"broadcast wave {w.wave_id}: {len(left)} live "
                f"members without a replica"))
    return violations, checks


def _check_epoch_monotonic(cluster, now: float) -> tuple[list[str], int]:
    """revocation-epoch-monotonic: per node, revocation epochs strictly
    increase in revocation order — across kills and promotions."""
    violations: list[str] = []
    checks = 0
    for nid, revs in cluster.revocation_log.items():
        checks += 1
        prev = None
        for epoch, t_r in revs:
            if prev is not None and epoch <= prev:
                violations.append(fmt_violation(
                    "revocation-epoch-monotonic", now,
                    f"{nid} revoked to epoch {epoch} at t={t_r:.3f} "
                    f"after already reaching {prev}"))
                break
            prev = epoch
    return violations, checks


def _check_budget_conservation(cluster, head, now: float
                               ) -> tuple[list[str], int]:
    """budget-conservation: for every alive lease-plane node whose
    cache epoch matches the grantor's, each class's locally-admitted
    count is bounded by the head-emitted budget.  Classes the grantor
    LRU-evicted (eviction never bumps the epoch) are skipped — the node
    may legitimately drain admissions the head no longer tracks."""
    violations: list[str] = []
    checks = 0
    grantor = head.grantor
    if grantor is None:
        return violations, checks
    for nid, node in cluster.nodes.items():
        lease = getattr(node, "lease", None)
        if lease is None or not node.alive:
            continue
        epoch, grants = grantor.snapshot_for(nid)
        if lease.epoch != epoch:
            continue    # revocation in flight: discard underway
        for ck, entry in lease._classes.items():
            emitted = grants.get(ck)
            if emitted is None:
                continue
            checks += 1
            if entry[1] > emitted:
                violations.append(fmt_violation(
                    "budget-conservation", now,
                    f"{nid} admitted {entry[1]} of class {ck} against "
                    f"head-emitted budget {emitted} (epoch {epoch})"))
    return violations, checks


def check_invariants(cluster, acked_jobs, strict: bool = False
                     ) -> tuple[list[str], int]:
    """Run every invariant; returns (violations, predicates_evaluated).

    ``strict`` is the end-of-campaign form: every acked job must have
    SUCCEEDED (which subsumes 'lineage reconstruction completes' — a
    job whose lost outputs were never rebuilt cannot finish).
    """
    violations: list[str] = []
    checks = 0
    head = cluster.head
    now = cluster.clock.monotonic()
    p = cluster.params
    grace = 2.0 * p.heartbeat_period_s

    def v(name: str, msg: str) -> None:
        violations.append(fmt_violation(name, now, msg))

    if head is not None and head.alive:
        # acked-job-lost
        for jid in acked_jobs:
            checks += 1
            if jid not in head.jobs:
                v("acked-job-lost", f"acked job lost: {jid}")
        # lease-stuck / leased-quiet (monitor requeues at lease_timeout)
        for nid in head._node_order:
            row = head.nodes.get(nid)
            if row is None:
                continue
            for tid in row["running"]:
                t = head.tasks.get(tid)
                if t is None or t["state"] != "running":
                    continue
                checks += 1
                if now - t["granted_at"] > p.lease_timeout_s + grace:
                    v("lease-stuck",
                      f"{tid} on {nid} running for "
                      f"{now - t['granted_at']:.1f}s")
            # lease-plane form: a locally-admitted grant the raylet
            # stopped reporting must be revoked+requeued by the sweep
            for tid, last in row["leased"].items():
                checks += 1
                if now - last > p.lease_timeout_s + grace:
                    v("leased-quiet",
                      f"{tid} on {nid} quiet for {now - last:.1f}s")
            # drain-stuck (deadline force-removal backstop)
            if row["state"] == "draining":
                checks += 1
                started = row["drain_started"]
                if started is not None and \
                        now - started > p.drain_deadline_s + grace:
                    v("drain-stuck",
                      f"{nid} draining for {now - started:.1f}s")
        # lineage: an output every incomplete job still needs must
        # have a copy, or its producer must already be requeued/running
        for jid, job in head.jobs.items():
            if job["status"] == "succeeded":
                continue
            for tid in job["tasks"]:
                t = head.tasks[tid]
                if t["state"] != "done":
                    continue        # pending/running == being rebuilt
                checks += 1
                obj = head.objects.get(t["oid"])
                if (obj is None or not obj["copies"]) and strict:
                    v("lineage-hole",
                      f"{t['oid']} of {jid} has no copies and "
                      f"producer {tid} is not requeued")
        if strict:
            for jid in acked_jobs:
                checks += 1
                job = head.jobs.get(jid)
                if job is not None and job["status"] != "succeeded":
                    n_done = sum(
                        1 for tid in job["tasks"]
                        if head.tasks[tid]["state"] == "done")
                    v("job-incomplete",
                      f"acked job incomplete after quiesce: {jid} "
                      f"({n_done}/{len(job['tasks'])} tasks done)")
        # object-copies: registry vs node-table consistency
        cv, cn = _check_object_copies(head, now)
        violations.extend(cv)
        checks += cn
        # budget-conservation: local admissions bounded by emitted
        # budgets (needs the live head's grantor book)
        if p.lease_plane and getattr(head, "grantor", None) is not None:
            gv, gn = _check_budget_conservation(cluster, head, now)
            violations.extend(gv)
            checks += gn

    # serve plane (when a serve_diurnal campaign installed one)
    plane = getattr(cluster, "serve_plane", None)
    if plane is not None and plane.started:
        sv, sn = plane.check(strict=strict, now=now, grace=grace)
        violations.extend(sv)
        checks += sn

    # training plane (when a train_diurnal campaign installed one)
    tplane = getattr(cluster, "train_plane", None)
    if tplane is not None and tplane.started:
        tv, tn = tplane.check(strict=strict, now=now, grace=grace)
        violations.extend(tv)
        checks += tn

    # model-version plane (when a serve_rolling_update campaign
    # installed one)
    rplane = getattr(cluster, "rollout_plane", None)
    if rplane is not None:
        rv, rn = rplane.check(strict=strict, now=now, grace=grace)
        violations.extend(rv)
        checks += rn

    # lease-double-exec; head-independent: the logs live on the
    # cluster, so this audits through head-down windows and across
    # standby promotions
    if cluster.params.lease_plane:
        ev, en = _check_exec_log(cluster, grace, now)
        violations.extend(ev)
        checks += en

    # bcast-reparent-cycle over the campaign's live waves
    bv, bn = _check_broadcast_cycles(cluster, now)
    violations.extend(bv)
    checks += bn
    if strict:
        wv, wn = _check_waves_final(cluster, now)
        violations.extend(wv)
        checks += wn

    # revocation-epoch-monotonic (head-independent, like the exec log)
    mv, mn = _check_epoch_monotonic(cluster, now)
    violations.extend(mv)
    checks += mn

    # lock-order-cycle (when the recorder is armed — see
    # rtlint_runtime_lock_order)
    from ..common import lockorder
    if lockorder.installed():
        checks += 1
        try:
            lockorder.assert_acyclic()
        except AssertionError as e:
            v("lock-order-cycle", str(e))

    # empty-lockset shared write (when the Eraser recorder is armed —
    # see rtlint_runtime_locksets)
    from ..common import locksets
    if locksets.installed():
        checks += 1
        try:
            locksets.assert_no_races()
        except AssertionError as e:
            v("lockset-race", str(e))

    return violations, checks

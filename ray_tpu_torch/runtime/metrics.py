"""Prometheus metrics endpoint (observability floor).

Reference parity: upstream exports core metrics (scheduler queue depths,
object store usage, worker counts) via OpenCensus to a Prometheus
scrape endpoint on ``metrics_export_port`` (``src/ray/stats/metric_defs.cc``,
``python/ray/_private/metrics_agent.py`` — SURVEY.md §1 layer 12, §5.5;
mount empty).

Pull-model: gauges are computed at scrape time straight from the live
runtime objects (CRM arrays, raylet queues, store/pull/lineage stats) —
no sampling thread, no drift.  Text exposition format 0.0.4, the one
Prometheus scrapes.  ``metrics_export_port`` 0 disables; passing port 0
to ``MetricsExporter`` directly binds an ephemeral port (tests).
"""

from __future__ import annotations

from .http_server import BackgroundHTTPServer


def _fmt(name: str, value, help_text: str, labels: dict | None = None,
         out: list | None = None) -> None:
    out.append(f"# HELP ray_tpu_{name} {help_text}")
    out.append(f"# TYPE ray_tpu_{name} gauge")
    if labels:
        lbl = ",".join(f'{k}="{v}"' for k, v in labels.items())
        out.append(f"ray_tpu_{name}{{{lbl}}} {value}")
    else:
        out.append(f"ray_tpu_{name} {value}")


def render_metrics(cluster) -> str:
    """One scrape: the cluster's live state as Prometheus text."""
    out: list[str] = []
    raylets = list(cluster.raylets.items())

    # scheduler: queue depths + placement latency
    pending = placed = running = 0
    durations: list[float] = []
    workers_alive = workers_expected = 0
    for _row, r in raylets:
        qs = r.queue_stats()
        pending += qs["pending"]
        placed += qs["placed"]
        running += qs["running"]
        durations.extend(qs["round_durations"])
        workers_alive += r.pool.num_alive()
        workers_expected += r.pool.expected()
    _fmt("scheduler_pending_tasks", pending,
         "Tasks awaiting placement across raylets", out=out)
    _fmt("scheduler_placed_tasks", placed,
         "Tasks placed, awaiting dispatch", out=out)
    _fmt("scheduler_running_tasks", running,
         "Tasks currently executing", out=out)
    if durations:
        durations.sort()
        p50 = durations[len(durations) // 2]
        _fmt("scheduler_placement_round_p50_seconds", f"{p50:.6f}",
             "Median scheduling-round duration", out=out)
    _fmt("num_nodes", len(raylets), "Live nodes", out=out)
    _fmt("num_workers_alive", workers_alive, "Live worker processes",
         out=out)
    _fmt("num_workers_expected", workers_expected,
         "Configured worker pool size", out=out)

    # object store
    ss = cluster.store.stats()
    _fmt("object_store_objects", ss["num_objects"], "Sealed objects",
         out=out)
    _fmt("object_store_arena_bytes_in_use", ss["arena_bytes_in_use"],
         "Shared-memory arena bytes in use", out=out)
    _fmt("object_store_arena_capacity_bytes", ss["arena_capacity"],
         "Shared-memory arena capacity", out=out)
    _fmt("object_store_spilled_bytes_total", ss["spilled_bytes"],
         "Bytes spilled to disk (cumulative)", out=out)
    _fmt("object_store_restored_bytes_total", ss["restored_bytes"],
         "Bytes restored from spill (cumulative)", out=out)
    _fmt("object_store_pinned_objects", ss["num_pinned"],
         "Objects pinned by outstanding descriptors", out=out)

    # object transfer
    ps = cluster.pull_manager.stats()
    _fmt("pull_manager_pulls_total", ps["num_pulls"],
         "Completed pulls (cumulative)", out=out)
    _fmt("pull_manager_bytes_pulled_total", ps["bytes_pulled"],
         "Bytes transferred by pulls (cumulative)", out=out)
    _fmt("pull_manager_inflight_bytes", ps["inflight_bytes"],
         "Bytes in active transfers", out=out)
    obj_plane = getattr(cluster, "plane", None)
    if obj_plane is not None:
        _fmt("object_plane_blacklisted_sources",
             len(obj_plane.blacklisted_sources()),
             "Transfer sources currently blacklisted for repeated "
             "failures", out=out)

    # broadcast plane (1->N relay trees)
    broadcasts = getattr(cluster, "broadcasts", None)
    if broadcasts is not None:
        bs = broadcasts.stats()
        _fmt("broadcast_active_trees", bs["bcast_active_trees"],
             "Broadcast trees currently distributing", out=out)
        _fmt("broadcast_trees_completed_total",
             bs["bcast_trees_completed"],
             "Broadcast trees fully distributed (cumulative)", out=out)
        _fmt("broadcast_members_reached_total",
             bs["bcast_members_reached"],
             "Replicas sealed through broadcast trees (cumulative)",
             out=out)
        _fmt("broadcast_joins_total", bs["bcast_joins"],
             "Concurrent pulls grafted onto an active tree "
             "(cumulative)", out=out)
        _fmt("broadcast_relay_fanout", bs["bcast_relay_fanout"],
             "Mean children per relaying node, last tree", out=out)
        _fmt("broadcast_time_to_all_ewma_seconds",
             bs["bcast_time_to_all_ewma_s"],
             "Smoothed time-to-all-replicas across broadcasts", out=out)
        if obj_plane is not None:
            es = obj_plane.bcast.stats()
            _fmt("broadcast_chunks_relayed_total",
                 es["bcast_chunks_relayed"],
                 "Chunks served from live relay sessions (cumulative)",
                 out=out)
            _fmt("broadcast_chunks_pulled_total",
                 es["bcast_chunks_pulled"],
                 "Chunks fetched from parents by relay sessions "
                 "(cumulative)", out=out)

    # ownership / lineage
    ts = cluster.task_manager.stats()
    _fmt("lineage_retained_specs", ts["num_done_retained"],
         "Completed specs retained for reconstruction", out=out)
    _fmt("lineage_bytes", ts["lineage_bytes"],
         "Bytes of retained lineage", out=out)
    rs = cluster.ref_counter.stats()
    _fmt("refcounted_objects", rs["num_tracked"],
         "Objects with live references", out=out)
    _fmt("reconstructions_total", cluster.recovery.num_reconstructions,
         "Objects reconstructed from lineage (cumulative)", out=out)

    # health + autoscaler + events
    _fmt("health_nodes_declared_dead_total", cluster.health.num_detected,
         "Nodes declared dead by health checks (cumulative)", out=out)
    hs = cluster.health.stats()
    _fmt("health_suspect_nodes", hs["num_suspect"],
         "Nodes flagged suspect (loop-lag or breaker quarantine)",
         out=out)
    _fmt("health_quarantined_nodes", hs["num_quarantined"],
         "Nodes with an OPEN circuit breaker on their plane link",
         out=out)
    from ..rpc import breaker as _breaker
    bs = _breaker.stats()
    _fmt("rpc_breakers_open",
         sum(1 for b in bs.values() if b["state"] == "open"),
         "Peer circuit breakers currently open", out=out)
    _fmt("rpc_breaker_opens_total",
         sum(b["opens"] for b in bs.values()),
         "Circuit-breaker open transitions (cumulative)", out=out)
    from ..rpc import chaos as _chaos
    ch = _chaos.active()
    if ch is not None:
        cs = ch.status()
        for key, help_text in (
                ("num_dropped", "Messages dropped by chaos injection"),
                ("num_duplicated",
                 "Messages duplicated by chaos injection"),
                ("num_delayed", "Messages delayed by chaos injection"),
                ("num_partitioned",
                 "Messages dropped by directed partitions")):
            _fmt(f"chaos_{key}", cs[key], help_text + " (cumulative)",
                 out=out)
    if cluster.autoscaler is not None:
        a = cluster.autoscaler.stats()
        _fmt("autoscaler_nodes_launched_total", a["num_launched"],
             "Nodes launched (cumulative)", out=out)
        _fmt("autoscaler_nodes_terminated_total", a["num_terminated"],
             "Idle nodes terminated (cumulative)", out=out)
    ev = getattr(cluster, "events", None)
    if ev is not None:
        _fmt("events_emitted_total", ev.num_events,
             "Structured events emitted (cumulative)", out=out)

    # serve request plane (per-deployment, only when apps run in this
    # process — the router registry is process-local)
    try:
        from ..serve.router import request_plane_stats
        plane = request_plane_stats()
    except Exception:   # noqa: BLE001 — serve absent/unused
        plane = {}
    for dep, s in sorted(plane.items()):
        lbl = {"deployment": dep}
        _fmt("serve_replicas", s.get("replicas", 0),
             "Live replicas", lbl, out)
        _fmt("serve_queued_requests", s.get("queued", 0),
             "Requests parked in the router queue", lbl, out)
        _fmt("serve_inflight_requests", s.get("inflight", 0),
             "Requests dispatched and unfinished", lbl, out)
        _fmt("serve_qps", s.get("qps", 0),
             "Completed requests per second (5s window)", lbl, out)
        _fmt("serve_latency_p50_ms", s.get("p50_ms", 0),
             "Request latency p50 (recent window)", lbl, out)
        _fmt("serve_latency_p99_ms", s.get("p99_ms", 0),
             "Request latency p99 (recent window)", lbl, out)
        _fmt("serve_latency_ewma_ms", s.get("latency_ewma_ms", 0),
             "Request latency EWMA (autoscaler signal)", lbl, out)
        _fmt("serve_shed_requests_total", s.get("shed", 0),
             "Requests shed by admission control (cumulative)", lbl,
             out)
        _fmt("serve_expired_requests_total", s.get("expired", 0),
             "Requests dropped at deadline before dispatch "
             "(cumulative)", lbl, out)
        _fmt("serve_completed_requests_total", s.get("completed", 0),
             "Requests completed (cumulative)", lbl, out)
        if s.get("batches"):
            _fmt("serve_batches_total", s["batches"],
                 "Micro-batches executed (cumulative)", lbl, out)
            _fmt("serve_batch_size_mean", s["batch_size_mean"],
                 "Mean micro-batch size", lbl, out)
        _fmt("serve_router_shards", s.get("shards", 1),
             "Router shards for this deployment's request plane", lbl,
             out)
        _fmt("serve_gossip_digest_size", s.get("gossip_digest", 0),
             "Replica load entries on the gossip board", lbl, out)

    # model-version plane (per-deployment: current version plus any
    # in-flight rollout's phase and flip progress)
    try:
        from ..versioning import VersionRegistry
        versions = VersionRegistry().all()
    except Exception:   # noqa: BLE001 — versioning absent/unused
        versions = {}
    _PHASE_IDS = {"STAGING": 1, "BROADCASTING": 2, "FLIPPING": 3,
                  "PAUSED": 4, "SEALED": 5, "ROLLED_BACK": 6}
    for dep, rec in sorted(versions.items()):
        lbl = {"deployment": dep}
        _fmt("serve_model_version",
             int(str(rec.get("current", "v1")).lstrip("v") or 1),
             "Current model version number", lbl, out)
        ro = rec.get("rollout")
        if ro is None:
            continue
        _fmt("serve_rollout_phase", _PHASE_IDS.get(ro["phase"], 0),
             "Rollout phase (1=STAGING 2=BROADCASTING 3=FLIPPING "
             "4=PAUSED 5=SEALED 6=ROLLED_BACK)", lbl, out)
        _fmt("serve_rollout_flipped_replicas", ro.get("flipped", 0),
             "Replicas flipped to the rollout's target version", lbl,
             out)
        _fmt("serve_rollout_total_replicas", ro.get("replicas", 0),
             "Replicas the rollout set out to flip", lbl, out)

    # gossiped load board (process-local, shared by every deployment)
    try:
        from ..serve.gossip import board
        gs = board.stats()
        _fmt("serve_gossip_folds_total", gs["folds"],
             "Shard-digest folds onto the load board (cumulative)",
             out=out)
        _fmt("serve_gossip_evictions_total", gs["evicted_replicas"],
             "Replica entries evicted on membership change "
             "(cumulative)", out=out)
    except Exception:   # noqa: BLE001 — serve absent/unused
        pass

    # elastic serve<->batch capacity loaning
    loans = getattr(cluster, "loans", None)
    if loans is not None:
        ls = loans.stats()
        _fmt("serve_loans_active", ls["loans_active"],
             "Batch nodes currently loaned to the serve plane", out=out)
        _fmt("serve_loans_total", ls["loans_total"],
             "Capacity loans taken (cumulative)", out=out)
        _fmt("serve_loan_reclaims_total", ls["reclaims_total"],
             "Loans reclaimed through drain semantics (cumulative)",
             out=out)
        _fmt("serve_loans_lost_total", ls["loans_lost"],
             "Loaned nodes lost to failure, booked once (cumulative)",
             out=out)
        _fmt("serve_loan_last_reclaim_seconds",
             ls["last_reclaim_latency_s"],
             "Drain-to-restore latency of the last reclaim", out=out)
        _fmt("reverse_lends_active", ls.get("reverse_lends_active", 0),
             "Serve nodes currently lent to batch/train", out=out)
        _fmt("reverse_lends_total", ls.get("reverse_lends_total", 0),
             "Reverse lends taken (cumulative)", out=out)
        _fmt("reverse_lends_returned_total",
             ls.get("reverse_lends_returned", 0),
             "Reverse lends ended by serve pressure (cumulative)",
             out=out)
        _fmt("reverse_lends_lost_total",
             ls.get("reverse_lends_lost", 0),
             "Lent nodes lost to failure, booked once (cumulative)",
             out=out)

    # elastic training plane (driver-local ElasticTrainer runs)
    try:
        from ..train.elastic import active_train_stats
        runs = active_train_stats()
    except Exception:   # noqa: BLE001 — train plane unused
        runs = []
    for ts in runs:
        lbl = {"run": ts.get("run", "")}
        _fmt("train_epoch", ts.get("epoch") or 0,
             "Last journaled (acked) epoch of the run", labels=lbl,
             out=out)
        _fmt("train_gang_losses_total", ts.get("gang_losses", 0),
             "Gang members lost mid-collective (cumulative)",
             labels=lbl, out=out)
        _fmt("train_planned_resizes_total",
             ts.get("planned_resizes", 0),
             "Drain/loan-reclaim restarts, no failure burn "
             "(cumulative)", labels=lbl, out=out)
        _fmt("train_failures_total", ts.get("failures", 0),
             "Unexplained gang failures charged to max_failures "
             "(cumulative)", labels=lbl, out=out)
        _fmt("train_world_size", ts.get("world", 0),
             "Current gang world size", labels=lbl, out=out)
        _fmt("train_sync_broadcasts_total",
             ts.get("sync_broadcasts", 0),
             "Checkpoint fan-outs over the broadcast tree "
             "(cumulative)", labels=lbl, out=out)
        _fmt("train_ckpt_replications_total",
             ts.get("ckpt_replications", 0),
             "Checkpoint replication rounds off the writer "
             "(cumulative)", labels=lbl, out=out)
        _fmt("train_goodput_eps", ts.get("goodput_eps", 0.0),
             "Acked epochs per wall second of fit(), recovery "
             "stalls included", labels=lbl, out=out)

    # lease plane (process-local registry: agent cache, head grantor,
    # standby — whichever roles live in this process)
    try:
        from ..leasing import aggregate_stats
        lz = aggregate_stats()
    except Exception:   # noqa: BLE001 — lease plane disabled
        lz = {}
    if lz.get("sources"):
        _fmt("leases_granted_local", lz["leases_granted_local"],
             "Tasks admitted from a local lease, no head RPC "
             "(cumulative)", out=out)
        _fmt("spillbacks", lz["spillbacks"],
             "Lease misses spilled back to the head (cumulative)",
             out=out)
        _fmt("lease_revocations", lz["lease_revocations"],
             "Grants revoked by epoch advance (cumulative)", out=out)
        _fmt("lease_hit_rate", lz["lease_hit_rate"],
             "Local-grant fraction of lease decisions", out=out)
        standby = lz["sources"].get("standby") or {}
        if standby:
            _fmt("standby_promotions_total",
                 standby.get("promotions", 0),
                 "Standby-to-primary promotions (cumulative)", out=out)
            fo = standby.get("failover_ms") or []
            if fo:
                _fmt("failover_ms", fo[-1],
                     "Head-death to promoted-head-serving window of "
                     "the last failover", out=out)

    # user-defined metrics (ray_tpu_torch.util.metrics) share the endpoint
    from ..util.metrics import render_user_metrics
    out.extend(render_user_metrics())
    return "\n".join(out) + "\n"


class MetricsExporter(BackgroundHTTPServer):
    """Scrape endpoint: ``GET /metrics`` on ``metrics_export_port``."""

    def __init__(self, cluster, port: int, host: str = "127.0.0.1"):
        self._cluster = cluster
        super().__init__(host=host, port=port, name="metrics")

    def route(self, request) -> None:
        if request.path.rstrip("/") not in ("", "/metrics"):
            self.not_found(request)
            return
        self.reply(request, render_metrics(self._cluster).encode(),
                   "text/plain; version=0.0.4")

"""Single-table configuration registry with environment overrides.

Reference parity: upstream Ray's C++ ``RayConfig`` is one macro table,
``src/ray/common/ray_config_def.h`` — ``RAY_CONFIG(type, name, default)`` —
where every entry is overridable via an ``RAY_<name>`` environment variable and
via the ``_system_config`` JSON passed at init.  [Cited per SURVEY.md §5.6;
reference mount empty, line numbers unavailable.]

We reproduce the same three-layer precedence with a dataclass-free registry:

    default  <  RT_<NAME> environment variable  <  system_config dict

``Config`` is process-global (like the reference) but ``instance()`` can be
re-initialised in tests via ``Config.reset(system_config={...})``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable

_ENV_PREFIX = "RT_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}

# ---------------------------------------------------------------------------
# The table.  (type, default, doc)
# Names follow the reference's knobs where a counterpart exists
# (scheduler_spread_threshold etc. — SURVEY §5.6 lists the north-star-relevant
# ones); TPU-specific knobs are new.
# ---------------------------------------------------------------------------
_CONFIG_DEFS: dict[str, tuple[type, Any, str]] = {
    # -- scheduling (north star) -------------------------------------------
    "scheduler_spread_threshold": (
        float, 0.5,
        "Hybrid policy: nodes with critical-resource utilization below this "
        "score like 0 (=> pack by traversal order); above it, rank by score "
        "(=> spread). Mirrors reference RAY_scheduler_spread_threshold."),
    "scheduler_top_k_fraction": (
        float, 0.0,
        "Fraction of available nodes to sample among the best-k. 0 disables "
        "sampling (k=1), which is the bit-for-bit parity configuration."),
    "scheduler_top_k_absolute": (
        int, 1,
        "Floor for the top-k node count when top_k_fraction > 0."),
    # (the reference's raylet_report_resources_period_milliseconds has no
    # counterpart here: the in-process CRM is one shared authoritative
    # view, so there is no resource-report staleness to configure)
    "scheduler_device_backend": (
        bool, True,
        "Evaluate batched placement on the device kernel; False forces the CPU "
        "oracle everywhere (debugging / parity bisection)."),
    "scheduler_device_batch_min": (
        int, 4096,
        "Minimum uniform-strategy backlog routed to the device kernel in "
        "one round; smaller rounds use the (bit-identical) CPU policy. "
        "The default is kept from the JAX package until the break-even "
        "of a heartbeat on the GPU against the per-placement CPU policy "
        "has been measured (PERF.md)."),
    "scheduler_delta_beats": (
        bool, True,
        "Incremental device heartbeat: keep the CRM mirror + carried key "
        "tensor resident in HBM between beats and upload only the dirty "
        "rows/classes (DeltaScheduler).  False re-uploads the full "
        "snapshot every device round (the pre-delta behavior; parity "
        "bisection)."),
    "scheduler_delta_max_dirty_fraction": (
        float, 0.25,
        "Full-rescore fallback knob: when more than this fraction of "
        "node rows changed since the last beat, the delta path costs "
        "more than one bulk upload + full rescore, so the heartbeat "
        "resyncs everything instead."),
    "scheduler_sharded_state": (
        bool, False,
        "Shard the device scheduler's cluster-state rows over ALL local "
        "devices (jax Mesh on a 'nodes' axis): each device owns N/n_dev "
        "node rows and the water-fill's global reductions lower to XLA "
        "collectives over ICI.  Off (default) keeps single-device "
        "arrays — correct either way (dryrun-proven bit-equality); on "
        "one chip there is nothing to shard."),
    "scheduler_shards": (
        int, 1,
        "Node-shard count for the mesh-sharded delta heartbeat "
        "(ShardedDeltaScheduler): each of S devices holds N/S node rows "
        "of the CRM mirror + key tensor and uploads only its shard's "
        "dirty rows per beat.  1 (default) keeps the single-device "
        "DeltaScheduler; 0 = one shard per local device; values are "
        "clamped to the local device count and rounded DOWN to a power "
        "of two so shards divide the pow2-bucketed node axis evenly."),
    "scheduler_shard_reduce": (
        str, "auto",
        "Mesh topology for the sharded heartbeat's cross-device "
        "reductions: 'flat' = one (1, S) all-ICI axis; 'two_level' = "
        "(2, S/2) slices so psum/pmin lower to ICI within a slice then "
        "DCN across; 'auto' (default) derives slice grouping from the "
        "devices' slice_index when present, else flat."),
    # -- object store -------------------------------------------------------
    "object_store_memory_mb": (
        int, 512,
        "Per-node object store arena size."),
    "object_spilling_threshold": (
        float, 0.8,
        "Fraction of store capacity above which primary copies spill."),
    "object_spilling_dir": (
        str, "",
        "Directory for spilled objects ('' => <session_dir>/spill)."),
    "pull_manager_max_inflight_mb": (
        int, 256,
        "Receiver-driven pull quota (reference PullManager active-pull "
        "memory cap): queued pulls activate only while in-flight bytes "
        "stay under this."),
    "pull_transfer_sim_gbps": (
        float, 0.0,
        "Simulated link rate for pull transfers in the in-process "
        "cluster; 0 = instantaneous (directory update only)."),
    "pull_device_batch_min": (
        int, 128,
        "Minimum activation batch routed to the device pull-source "
        "kernel; smaller batches use the bit-identical numpy oracle."),
    "object_transfer_chunk_mb": (
        int, 8,
        "Chunk size for wire-level arena-to-arena object transfer "
        "between node planes (reference ObjectBufferPool chunking).  "
        "8 MB amortizes per-chunk request/dispatch overhead on the "
        "raw data channel while keeping stripe reassignment granular."),
    "object_transfer_threads": (
        int, 4,
        "Concurrent transfer executors in the pull manager; activation "
        "stays quota-bounded (pull_manager_max_inflight_mb)."),
    "object_transfer_window": (
        int, 8,
        "Chunk requests kept in flight per stripe source (windowed "
        "pipelining over the RPC demux).  Effective window is capped "
        "at pull_manager_max_inflight_mb / object_transfer_chunk_mb so "
        "the pull quota still bounds receive-side memory; 1 with a "
        "single source restores the lockstep request-reply loop."),
    "object_transfer_stripe_min_mb": (
        int, 16,
        "Minimum object size for multi-source striping: when the "
        "directory holds >=2 replicas of an object at least this "
        "large, chunk ranges stripe across the sources (a source dying "
        "mid-transfer reassigns only its unfinished stripes).  Smaller "
        "objects pull from the single best source."),
    "object_transfer_raw_channel": (
        bool, True,
        "Move chunk payloads as codec-bypass raw frames (memoryview "
        "slices out of the shm arena, landed straight into the ingest "
        "buffer).  False falls back to the pickled op_read channel "
        "(parity bisection / debugging)."),
    "pg_device_batch_min": (
        int, 2,
        "Minimum pending placement-group batch routed to the device "
        "gang-placement kernel (ops/bundle_kernel.py); smaller batches "
        "use the bit-identical CPU path."),
    # -- broadcast plane (1->N weight distribution) --------------------------
    "broadcast_fanout": (
        int, 2,
        "Maximum children per node in the broadcast tree.  2 keeps "
        "every uplink at half rate (time-to-all ~ 2*S/U + depth "
        "pipeline fill); raise it on fat-uplink topologies where one "
        "source can feed more receivers at full rate."),
    "broadcast_chunk_mb": (
        int, 8,
        "Relay granularity: a receiver becomes a source for a chunk "
        "the moment that chunk lands (relay-as-you-receive).  Smaller "
        "chunks shorten the per-hop pipeline-fill delay, larger ones "
        "amortize request overhead on the raw channel."),
    "broadcast_window": (
        int, 4,
        "Chunk requests a relay keeps in flight against its parent "
        "(windowed pipelining on one connection, like "
        "object_transfer_window but per broadcast edge)."),
    "broadcast_fetch_timeout_s": (
        float, 60.0,
        "Per-chunk deadline on a broadcast edge: a relay whose parent "
        "produces no chunk completion for this long declares the "
        "parent dead and re-parents to the next fallback ancestor."),
    "broadcast_device_batch_min": (
        int, 128,
        "Minimum member count routed to the device fan-out-plan kernel "
        "(ops/broadcast_kernel.py); smaller trees use the bit-identical "
        "numpy oracle."),
    "broadcast_join_pulls": (
        bool, True,
        "Let the pull manager graft concurrent pulls of an in-flight "
        "broadcast object onto the broadcast tree as new leaves "
        "instead of opening fresh source streams against the origin."),
    "plane_uplink_mbps": (
        float, 0.0,
        "Per-endpoint outbound pacing for object-plane chunk serving "
        "(MB/s across op_fetch/op_read/bc_fetch replies; 0 = uncapped). "
        "Models a bounded node uplink on loopback test rigs so tree "
        "vs naive fan-out shapes are measurable; also usable as a "
        "crude egress throttle on shared NICs."),
    "runtime_env_wheelhouse": (
        str, "",
        "Local wheel directory for runtime_env pip provisioning: "
        "requirements install offline (pip --no-index --find-links) "
        "into a digest-keyed cached package dir workers import from. "
        "'' => validation-only (requirements must already be present)."),
    "streaming_backpressure_items": (
        int, 16,
        "Streaming-generator window: a generator task pauses once this "
        "many yielded items are sealed but not yet consumer-acked "
        "(reference _generator_backpressure_num_objects)."),
    "locality_aware_scheduling": (
        bool, True,
        "Prefer placing default-strategy tasks on the node holding the "
        "most bytes of their plasma args (reference: locality-aware "
        "lease targeting), falling back to hybrid when that node is "
        "busy."),
    "max_direct_call_object_size": (
        int, 100 * 1024,
        "Results at or below this many bytes return in-band to the owner's "
        "memory store; larger go to the object store (reference: 100KB)."),
    # -- runtime ------------------------------------------------------------
    "num_workers_soft_limit": (
        int, 0,
        "Worker pool size; 0 => os.cpu_count()."),
    "worker_lease_timeout_ms": (int, 10_000, "Lease RPC timeout."),
    "worker_pipeline_depth": (
        int, 2,
        "Max tasks committed to one worker: 1 executing + N-1 queued "
        "raylet-side, sent the moment the previous result lands — "
        "removes the result->rescan->dispatch round trip from the "
        "tiny-task critical path (reference: submitters pipeline tasks "
        "onto cached leases, SURVEY §3.2).  1 disables."),
    "env_worker_grace_ms": (
        int, 50,
        "How long a queued task waits for a busy same-env worker to "
        "return before the pool grows a new env worker (cold starts "
        "spawn immediately; growth past one worker per env costs one "
        "grace period per worker)."),
    "actor_max_restarts_default": (int, 0, "Default max_restarts for actors."),
    "task_max_retries_default": (
        int, 3,
        "Default max_retries for tasks (reference default: 3)."),
    "tracing_enabled": (
        bool, False,
        "Propagate trace context through task specs and tag timeline "
        "spans with (trace_id, parent_span) so a request's task tree "
        "is reconstructable (reference: RAY_TRACING_ENABLED + "
        "OpenTelemetry context propagation)."),
    "health_check_period_ms": (int, 1000, "GCS -> raylet ping period."),
    "health_check_failure_threshold": (
        int, 5, "Missed pings before a node is declared dead."),
    # -- rpc gray-failure hardening -----------------------------------------
    "rpc_retry_max_attempts": (
        int, 3,
        "Attempts (1 = no retry) for RPC methods a client marked "
        "retryable; idempotent reads/stats only — mutations never "
        "retry."),
    "rpc_retry_base_ms": (
        float, 50.0,
        "Base backoff for retryable RPCs; attempt i sleeps "
        "uniform(0, min(rpc_retry_max_ms, base * 2^i)) — exponential "
        "backoff with full jitter."),
    "rpc_retry_max_ms": (
        float, 2000.0, "Backoff ceiling for retryable RPCs."),
    "rpc_breaker_failure_threshold": (
        int, 5,
        "Consecutive call failures (timeout/connection loss) that open "
        "a peer's circuit breaker."),
    "rpc_breaker_reset_s": (
        float, 5.0,
        "Cooldown before an open breaker admits a half-open probe."),
    "plane_source_blacklist_failures": (
        int, 3,
        "Transfer failures within the window that blacklist an object-"
        "plane source address from striping/source selection."),
    "plane_source_blacklist_s": (
        float, 30.0,
        "How long a blacklisted source stays excluded (it is still "
        "used when it is the ONLY replica)."),
    # -- network chaos plane (deterministic fault injection) ----------------
    "chaos_enabled": (
        bool, False,
        "Arm the seeded network-chaos plane at first RPC endpoint "
        "creation (rpc/chaos.py); every knob below is scoped by it."),
    "chaos_seed": (
        int, 0,
        "Philox seed for per-link fault streams: the same seed replays "
        "the exact injected-fault trace."),
    "chaos_drop_p": (float, 0.0, "Per-message drop probability."),
    "chaos_dup_p": (float, 0.0, "Per-message duplicate probability."),
    "chaos_delay_p": (float, 0.0, "Per-message delay probability."),
    "chaos_delay_ms": (
        float, 0.0,
        "Delay magnitude: a delayed message sleeps delay_ms*(0.5+u)."),
    "chaos_bandwidth_mbps": (
        float, 0.0,
        "Per-connection bandwidth cap in Mbit/s (0 = uncapped)."),
    "lineage_pinning_memory_mb": (
        int, 256,
        "Budget for pinned task specs kept for lineage reconstruction."),
    # -- autoscaler ---------------------------------------------------------
    "autoscaler_update_interval_ms": (
        int, 1000,
        "Autoscaler demand-collection period (reference: "
        "AUTOSCALER_UPDATE_INTERVAL_S); infeasible arrivals also wake it."),
    "autoscaler_idle_timeout_s": (
        float, 60.0,
        "Idle seconds before a worker node is terminated (reference: "
        "idle_timeout_minutes)."),
    "autoscaler_device_batch_min": (
        int, 4096,
        "Minimum total pending-demand count routed to the device binpack "
        "kernel; smaller rounds use the bit-identical CPU oracle."),
    # -- graceful node drain ------------------------------------------------
    "drain_deadline_s": (
        float, 30.0,
        "Default grace period for Cluster.drain_node: a DRAINING node "
        "still busy past this is force-removed (preemption-notice "
        "semantics)."),
    "drain_poll_ms": (
        int, 50,
        "Drain monitor poll period (empty-check + sole-copy rescan)."),
    "autoscaler_drain_busy": (
        bool, False,
        "Let _scale_down DRAIN busy-but-surplus nodes (graceful "
        "handoff) instead of only terminating fully-idle ones."),
    "autoscaler_drain_surplus_s": (
        float, 10.0,
        "How long a busy node must stay surplus (cluster fits without "
        "it, no pending demand) before the autoscaler drains it."),
    # -- device -------------------------------------------------------------
    # (score scale and max node count are compile-time contract constants in
    # scheduling/contract.py — SCALE, MAX_NODES — not runtime knobs: the key
    # bit layout depends on them.)
    "tpu_group_capacity": (
        int, 128,
        "Padded number of distinct scheduling classes per device batch."),
    # -- serve request plane ------------------------------------------------
    "serve_max_queued_requests": (
        int, 200,
        "Default per-deployment bound on requests queued in the "
        "RequestRouter while every replica is at max_ongoing_requests; "
        "a full queue sheds with BackPressureError (HTTP 503). "
        "Override per deployment via max_queued_requests."),
    "serve_retry_after_s": (
        float, 1.0,
        "Retry-After hint (seconds) the ingress attaches to 503 "
        "load-shed responses."),
    "serve_latency_ewma_alpha": (
        float, 0.2,
        "Smoothing factor for the per-deployment request-latency EWMA "
        "the router feeds the autoscaler (higher = more reactive)."),
    "serve_router_shards": (
        int, 1,
        "Router shards per deployment (the per-ingress router model): "
        "sessions consistent-hash onto shards, each shard routes p2c on "
        "its own counts plus the gossiped load digests of its peers. "
        "1 keeps the single-router behavior; raise it to remove the "
        "central router as the request-plane bottleneck."),
    "serve_gossip_interval_s": (
        float, 0.25,
        "Maximum staleness of the folded per-replica load digests the "
        "router shards route on.  Folds piggyback on the health "
        "manager's probe round and happen opportunistically at pick "
        "time when the merged view is older than this.  Staleness can "
        "only over-queue at a replica, never over-RUN it: the replica "
        "cap is enforced replica-side by max_concurrency."),
    # -- serve<->batch capacity loaning -------------------------------------
    "serve_loan_max_nodes": (
        int, 2,
        "Maximum batch nodes loaned to the serve plane concurrently "
        "(tracked LOANED atop the CRM); 0 disables loaning."),
    "serve_loan_backlog": (
        int, 8,
        "Queued-request backlog (summed across a deployment's router "
        "shards) that, together with an exhausted replica pool, "
        "triggers borrowing an idle batch node."),
    "serve_loan_cooldown_s": (
        float, 2.0,
        "Minimum spacing between consecutive loans, so one backlog "
        "spike cannot strip the whole batch pool at once."),
    "serve_loan_reclaim_idle_s": (
        float, 5.0,
        "How long a deployment must stay backlog-free before its "
        "loaned nodes are voluntarily returned to the batch pool."),
    "serve_loan_drain_timeout_s": (
        float, 10.0,
        "Reclaim drain deadline: a loaner replica still busy past this "
        "is force-killed so the node returns to the batch pool (the "
        "DRAINING machine's preemption-notice semantics)."),
    # -- collective process groups (util/collective.py) ----------------------
    "collective_timeout_s": (
        float, 60.0,
        "Default deadline for process-group collective ops (allreduce/"
        "allgather/reducescatter/broadcast/barrier/send/recv).  A gang "
        "peer SIGKILLed between barrier and reduce leaves the round "
        "incomplete forever; past this deadline the op raises "
        "GangMemberLost naming the missing ranks so the trainer can "
        "re-form the gang from the last journaled step instead of "
        "hanging.  Per-call timeout= overrides."),
    # -- elastic training plane (train/elastic.py + sim/train.py) ------------
    "train_epoch_s": (
        float, 20.0,
        "Virtual seconds one simulated training epoch takes at full "
        "gang strength (SimTrainPlane); partial epochs lost to gang "
        "re-forms are the goodput cost the train_diurnal bench "
        "measures."),
    "train_ckpt_replicas": (
        int, 2,
        "Checkpoint copy target: an epoch is acked only once its "
        "checkpoint object has this many replicas on distinct live "
        "nodes (the writer plus replication peers), and the plane "
        "re-replicates from a surviving copy when a holder dies — the "
        "ckpt-durable invariant fires on a sole copy that persists "
        "past the replication grace."),
    "train_ckpt_replicate_s": (
        float, 2.0,
        "Virtual seconds one checkpoint replica copy takes in the "
        "simulator (and the grace unit the ckpt-durable invariant "
        "allows a sole copy before firing)."),
    "train_borrow_max": (
        int, 2,
        "Maximum serve replicas the training plane may borrow "
        "concurrently (the Aryl reverse direction: train borrows FROM "
        "serve at the diurnal trough, returned with drain semantics "
        "when serve pressure comes back); 0 disables borrowing."),
    "train_collective_timeout_s": (
        float, 15.0,
        "Virtual seconds a simulated gang blocks on a collective after "
        "a member SIGKILL before declaring GangMemberLost and "
        "re-forming from the last journaled epoch (the sim twin of "
        "collective_timeout_s, scaled to virtual epochs)."),
    # -- model-version plane (ray_tpu/versioning/) --------------------------
    "rollout_flip_drain_timeout_s": (
        float, 30.0,
        "Per-replica drain deadline during a rolling update: once a "
        "replica is pulled out of routing (begin_flip) its in-flight "
        "requests — at most max_ongoing_requests deep — must reach "
        "zero within this budget before the weight reload proceeds "
        "anyway."),
    "rollout_probe_timeout_s": (
        float, 10.0,
        "Timeout on the post-reload verification probe (the replica's "
        "__check_health__ plus any operator-supplied probe); a probe "
        "that hangs past this counts as failed and trips rollback."),
    "rollout_slo_factor": (
        float, 2.0,
        "SLO-regression trip: if a deployment's latency EWMA (live) or "
        "delta-p99 (sim) exceeds this multiple of the pre-rollout "
        "baseline while flipping, the rollout rolls back."),
    "rollout_session_idle_s": (
        float, 30.0,
        "Session-version pin expiry: a sticky session idle this long "
        "is considered ended, so its version pin is dropped and new "
        "requests from the session may land on the new version."),
    "rollout_wave_fanout": (
        int, 3,
        "Fanout of the broadcast-tree wave that streams a staged "
        "weight version 1->N to the replica hosts ahead of the flip "
        "sequence."),
    "version_retain_count": (
        int, 2,
        "How many sealed weight versions stay retained (pinned in the "
        "object store / registry) for rollback; the seal step trims "
        "older artifacts past this window."),
    # -- concurrency invariants (rtlint) ------------------------------------
    "rtlint_runtime_lock_order": (
        bool, False,
        "Instrument threading.Lock/RLock construction (common/"
        "lockorder.py) to record the REAL lock-acquisition-order "
        "digraph, keyed by allocation site; the chaos/drain suites "
        "assert it stays acyclic.  Dynamic complement of rtlint's "
        "static W2 rule — catches cross-object nesting static "
        "analysis cannot see.  Test/debug only: adds per-acquire "
        "bookkeeping to every lock constructed while enabled."),
    "rtlint_runtime_locksets": (
        bool, False,
        "Instrument @locksets.track classes (common/locksets.py) to "
        "sample the per-thread held-lock set at every tracked "
        "attribute write, Eraser-style; the chaos/drain suites assert "
        "no attribute is written from two threads with an empty "
        "lockset intersection.  Dynamic complement of rtlint's static "
        "W7 rule — catches sharing through callbacks and fixtures "
        "static analysis cannot see.  Test/debug only: adds a sample "
        "per tracked write while enabled."),
    # -- in-process simulator (ray_tpu/sim/) --------------------------------
    "sim_heartbeat_period_s": (
        float, 5.0,
        "Virtual-time heartbeat period of simulated nodes; also the "
        "simulated head's monitor tick."),
    "sim_heartbeat_miss_threshold": (
        int, 3,
        "Consecutive missed heartbeat periods before the simulated "
        "head declares a node dead and requeues its leases."),
    "sim_lease_timeout_s": (
        float, 20.0,
        "Virtual seconds a granted lease may run without an ack before "
        "the simulated head requeues the task (lost-ack recovery)."),
    "sim_drain_deadline_s": (
        float, 45.0,
        "Virtual deadline for a simulated drain to converge; past it "
        "the node is force-removed and leftover leases requeued."),
    "sim_node_capacity": (
        int, 4,
        "Concurrent lease slots per simulated node."),
    "sim_boot_delay_s": (
        float, 3.0,
        "Virtual delay between an autoscaler launch decision and the "
        "new simulated node registering."),
    # -- lease plane (ray_tpu/leasing/) -------------------------------------
    "lease_plane_enabled": (
        bool, True,
        "Grant steady-state worker leases at the raylet from an "
        "epoch-stamped snapshot leased by the head (ray_tpu/leasing/); "
        "misses and conflicts spill back to the head's scheduler, "
        "which stays the single source of truth."),
    "lease_budget_per_class": (
        int, 0,
        "Concurrent local admissions a raylet may grant per resource "
        "class from its lease before spilling back to the head; 0 "
        "derives the budget from node capacity."),
    "lease_budget_source": (
        str, "beat",
        "Where the head prices per-class lease budgets: 'beat' reads "
        "the scheduling beat's device-computed (class x node) headroom "
        "off the budget board (ray_tpu/leasing/board.py) and falls "
        "back to the host heuristic when no beat has published for the "
        "class; 'heuristic' always uses the host-side "
        "workers x overcommit sizing (the pre-budget-beat behavior). "
        "An explicit lease_budget_per_class overrides both."),
    "lease_budget_min": (
        int, 64,
        "Floor on any derived per-class lease budget (heuristic or "
        "beat-emitted): a beat that prices a class at 0 on a node "
        "still leaves this many admissions so repeat-class pipelines "
        "stay warm — total local admission is separately bounded by "
        "capacity x lease_overcommit raylet-side."),
    "lease_max_classes": (
        int, 64,
        "Resource classes a single node's lease snapshot may cover; "
        "beyond it, least-recently-granted classes are evicted and "
        "their submissions spill back."),
    "lease_ttl_s": (
        float, 30.0,
        "Lease snapshot time-to-live: a raylet that has not confirmed "
        "head contact within the death-declaration horizon fences "
        "itself (stops granting locally); the head waits this long "
        "after a leased task's last report before revoking the node's "
        "epoch and requeueing."),
    "lease_overcommit": (
        float, 2.0,
        "Total locally-admitted tasks (running + locally queued) a "
        "raylet accepts, as a multiple of its concurrent capacity, "
        "before spilling the overflow back to the head."),
    "lease_submit_batch_max": (
        int, 64,
        "Upper bound on worker submissions coalesced into one framed "
        "multi-submit per agent pump cycle on the raw-frame channel."),
    # -- hot-standby head (runtime/standby.py) ------------------------------
    "standby_probe_interval_s": (
        float, 1.0,
        "How often the hot-standby head probes the primary (and "
        "re-tails the persisted job table + journal sidecar)."),
    "standby_probe_misses": (
        int, 3,
        "Consecutive failed probes before the standby considers the "
        "primary dead (its own veto in the promotion quorum)."),
    "standby_quorum": (
        float, 0.34,
        "Fraction of known raylets whose head-down votes (plus the "
        "standby's own failed probe) promote the standby; guards "
        "against promotion on an asymmetric partition that only "
        "isolates the standby."),
    "sim_lease_plane": (
        bool, False,
        "Route simulated dispatch through the lease plane (origin-node "
        "batched submits, local grants, spillback, epoch revocation) "
        "instead of one head exec RPC per task; off by default so "
        "pre-r15 campaign trace hashes replay unchanged."),
    "sim_standby": (
        bool, False,
        "Run a simulated hot-standby head that is promoted by node "
        "vote quorum after a head kill (head_failover_storm enables "
        "this)."),
    # -- observability ------------------------------------------------------
    "metrics_export_port": (int, 0, "0 disables the Prometheus endpoint."),
    "dashboard_port": (int, 0, "0 disables the dashboard HTTP server."),
    "dashboard_host": (str, "127.0.0.1",
                       "Bind host for the dashboard HTTP server."),
    "event_log_enabled": (bool, True, "Emit timeline events."),
    "log_dir": (str, "", "'' => <session_dir>/logs."),
}


class Config:
    """Resolved configuration. Access values as attributes."""

    _instance: "Config | None" = None
    _lock = threading.Lock()

    def __init__(self, system_config: dict[str, Any] | None = None):
        overrides = dict(system_config or {})
        for name, (typ, default, _doc) in _CONFIG_DEFS.items():
            value = default
            env = os.environ.get(_ENV_PREFIX + name.upper())
            if env is not None:
                value = _PARSERS[typ](env)
            if name in overrides:
                raw = overrides.pop(name)
                value = _PARSERS[typ](raw) if isinstance(raw, str) else typ(raw)
            setattr(self, name, value)
        if overrides:
            raise ValueError(f"unknown config keys: {sorted(overrides)}")

    # -- global accessors ---------------------------------------------------
    @classmethod
    def instance(cls) -> "Config":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls, system_config: dict[str, Any] | None = None) -> "Config":
        with cls._lock:
            cls._instance = cls(system_config)
            return cls._instance

    # -- introspection ------------------------------------------------------
    @classmethod
    def defs(cls) -> dict[str, tuple[type, Any, str]]:
        return dict(_CONFIG_DEFS)

    def to_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in _CONFIG_DEFS}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


def get_config() -> Config:
    return Config.instance()

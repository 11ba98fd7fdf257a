"""The ``ray_tpu_torch`` command line.

Reference parity: ``ray start --head`` boots the head daemon (GCS +
raylet), ``ray stop`` tears it down, ``ray status/memory/timeline``
introspect, ``ray job submit -- <cmd>`` runs entrypoints on the cluster,
``ray microbenchmark`` is the single-node perf suite from
``python/ray/_private/ray_perf.py`` (BASELINE config #1) — SURVEY.md
§1 layer 15, §4; mount empty.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# The daemons' address file and logs: $RAY_TPU_TORCH_STATE_DIR, else
# ray_tpu_torch-state under the temp dir (/tmp), apart from the JAX
# package's ray_tpu-state, so the two CLIs never stop each other's
# daemons.  NOTE the dash: a directory literally named ray_tpu_torch on a
# script's sys.path[0] (e.g. /tmp) would shadow the real package as an
# empty namespace package
STATE_DIR = os.environ.get("RAY_TPU_TORCH_STATE_DIR") or os.path.join(
    tempfile.gettempdir(), "ray_tpu_torch-state")
ADDRESS_FILE = os.path.join(STATE_DIR, "ray_current_cluster")


def _write_address(address: str) -> None:
    os.makedirs(os.path.dirname(ADDRESS_FILE), exist_ok=True)
    with open(ADDRESS_FILE, "w") as f:
        f.write(address)


def _resolve_address(explicit: str | None) -> str:
    if explicit:
        return explicit
    env = os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if env:
        return env
    try:
        with open(ADDRESS_FILE) as f:
            return f.read().strip()
    except FileNotFoundError:
        raise SystemExit(
            "no running cluster found: pass --address, set "
            "RAY_TPU_TORCH_ADDRESS, or run `ray_tpu_torch start --head` first")


def _client(address: str | None):
    from ..rpc import transport as _transport
    return _transport.connect(_resolve_address(address))


# -- subcommands -------------------------------------------------------------

def cmd_head(args) -> int:
    """Foreground daemon (what ``start --head`` detaches)."""
    from ..runtime.head import HeadNode
    resources = json.loads(args.resources) if args.resources else None
    head = HeadNode(resources=resources, num_workers=args.num_workers,
                    port=args.port,
                    persist_path=getattr(args, "persist", None))
    _write_address(head.address)
    print(f"ray_tpu_torch head listening on {head.address}", flush=True)
    if head.xlang is not None:
        print(f"cross-language (C++) gateway on {head.xlang.address}",
              flush=True)
    try:
        head.wait_for_shutdown()
    except KeyboardInterrupt:
        head.stop()
    return 0


def cmd_agent(args) -> int:
    """Foreground worker-node agent: joins a head, serves its workers
    (reference: ``ray start --address=<head>`` boots a worker node)."""
    # only the head holds the card: an agent and the workers it spawns
    # never see a GPU (each stray CUDA context would cost ~500 MB of it)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from ..runtime.node_agent import NodeAgent
    resources = json.loads(args.resources) if args.resources else None
    labels = json.loads(args.labels) if args.labels else None
    num_workers = args.num_workers if args.num_workers is not None else 2
    agent = NodeAgent(args.address, resources=resources,
                      num_workers=num_workers, labels=labels,
                      reconnect_timeout_s=getattr(
                          args, "reconnect_timeout", 60.0),
                      standby_address=getattr(
                          args, "standby_address", None))
    print(f"ray_tpu_torch node agent joined {args.address} as node "
          f"{agent.node_id_hex[:16]}… ({num_workers} workers)",
          flush=True)
    try:
        agent.wait_for_shutdown()
    except KeyboardInterrupt:
        agent.stop()
    return 0


def cmd_standby(args) -> int:
    """Foreground hot-standby head: probes the primary, collects agent
    head-down votes, and promotes itself onto the primary's address
    from the shared persist snapshot when the primary dies."""
    from ..runtime.standby import StandbyHead
    resources = json.loads(args.resources) if args.resources else None
    standby = StandbyHead(args.address, port=args.port,
                          persist_path=getattr(args, "persist", None),
                          resources=resources,
                          num_workers=args.num_workers)
    print(f"ray_tpu_torch standby armed at {standby.address}, "
          f"watching {args.address}", flush=True)
    try:
        standby.wait_for_shutdown()
    except KeyboardInterrupt:
        standby.stop()
    return 0


def cmd_start(args) -> int:
    if args.head and args.address:
        raise SystemExit("--head and --address are mutually exclusive")
    if not args.head and args.address:
        if args.block:          # foreground agent (supervisors)
            return cmd_agent(args)
        # detached worker-node agent joining an existing head
        os.makedirs(STATE_DIR, exist_ok=True)
        log_path = os.path.join(STATE_DIR, "agent.log")
        cmd = [sys.executable, "-m", "ray_tpu_torch", "agent",
               "--address", args.address]
        if args.resources:
            cmd += ["--resources", args.resources]
        if args.num_workers is not None:
            cmd += ["--num-workers", str(args.num_workers)]
        if args.labels:
            cmd += ["--labels", args.labels]
        with open(log_path, "ab") as log_f:
            proc = subprocess.Popen(cmd, stdout=log_f, stderr=log_f,
                                    start_new_session=True)
        print(f"started node agent (pid {proc.pid}) joining "
              f"{args.address}")
        print(f"logs: {log_path}")
        return 0
    if not args.head:
        raise SystemExit("pass --head to start a head, or "
                         "--address=<head> to join one")
    if args.block:
        return cmd_head(args)
    os.makedirs(STATE_DIR, exist_ok=True)
    log_path = os.path.join(STATE_DIR, "head.log")
    cmd = [sys.executable, "-m", "ray_tpu_torch", "head",
           "--port", str(args.port)]
    if args.resources:
        cmd += ["--resources", args.resources]
    if args.num_workers is not None:
        cmd += ["--num-workers", str(args.num_workers)]
    spawn_t = time.time()
    with open(log_path, "ab") as log_f:
        proc = subprocess.Popen(cmd, stdout=log_f, stderr=log_f,
                                start_new_session=True)
    # the daemon writes the address file once its RPC server is up;
    # only a file written AFTER the spawn counts — a stale file from a
    # crashed daemon would hand out a dead address
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if os.path.exists(ADDRESS_FILE) and \
                os.path.getmtime(ADDRESS_FILE) >= spawn_t - 1.0:
            with open(ADDRESS_FILE) as f:
                addr = f.read().strip()
            print(f"started head daemon (pid {proc.pid}) at {addr}")
            print(f"logs: {log_path}")
            print(f'attach with: ray_tpu_torch.init(address="{addr}")')
            return 0
        if proc.poll() is not None:
            raise SystemExit(
                f"head daemon exited rc={proc.returncode}; see {log_path}")
        time.sleep(0.1)
    raise SystemExit("head daemon did not come up within 30s")


def cmd_stop(args) -> int:
    try:
        resolved = _resolve_address(args.address)
    except SystemExit:
        print("no running cluster")
        return 0
    from ..rpc import transport as _transport
    client = _transport.connect(resolved)
    try:
        client.call("stop_daemon", timeout=10.0)
        print("cluster stopping")
    finally:
        client.close()
        # only clear the address file if it records THE cluster we just
        # stopped — `stop --address other:port` must not orphan a
        # still-running local daemon's record
        try:
            with open(ADDRESS_FILE) as f:
                recorded = f.read().strip()
            if recorded == resolved:
                os.unlink(ADDRESS_FILE)
        except FileNotFoundError:
            pass
    return 0


def cmd_status(args) -> int:
    client = _client(args.address)
    try:
        st = client.call("status", timeout=30.0)
    finally:
        client.close()
    print(f"address: {st['address']}  role: {st.get('role', 'primary')}")
    print(f"session: {st['session_dir']}")
    print(f"nodes ({len(st['nodes'])}):")
    for n in st["nodes"]:
        status = n.get("Status", "ALIVE")
        print(f"  {n['NodeID'][:16]}…  row={n['Row']} "
              f"{status:<8} labels={n['Labels']}")
    for d in st.get("drains") or []:
        if d.get("state") == "DRAINING":
            print(f"  draining: {d['node_id'][:16]}… "
                  f"reason={d.get('reason') or '-'} "
                  f"deadline_s={d.get('deadline_s')}")
    health = st.get("health") or {}
    if health.get("num_suspect") or health.get("num_quarantined") \
            or health.get("suspect_rows"):
        print(f"  suspect: rows={health.get('suspect_rows')} "
              f"(loop-lag or quarantine; soft-avoided by the "
              f"scheduler), quarantined={health.get('num_quarantined', 0)}")
    for addr, b in (health.get("breakers") or {}).items():
        print(f"  breaker {addr}: {b['state']} "
              f"failures={b['failures']} opens={b['opens']}")
    ch = st.get("chaos") or {}
    if ch.get("enabled"):
        print(f"chaos: seed={ch['seed']} drop_p={ch['drop_p']} "
              f"dup_p={ch['dup_p']} delay={ch['delay_ms']}ms"
              f"@p={ch['delay_p']} bw={ch['bandwidth_mbps']}MB/s "
              f"partitions={ch['partitions']} "
              f"injected: drop={ch['num_dropped']} "
              f"dup={ch['num_duplicated']} delay={ch['num_delayed']} "
              f"part={ch['num_partitioned']}")
    sched = st.get("scheduler") or {}
    if sched:
        print(f"scheduler: device={sched['device']} "
              f"device_rounds={sched['device_rounds']} "
              f"(delta={sched['delta_rounds']} "
              f"topk={sched['topk_rounds']}) "
              f"host_rounds={sched['host_rounds']} "
              f"launches={sched['launches']}")
    print("resources:")
    total, avail = st["cluster_resources"], st["available_resources"]
    for name in sorted(total):
        print(f"  {avail.get(name, 0.0):.1f}/{total[name]:.1f} {name}")
    op = st.get("object_plane")
    if op:
        mb = 1 << 20
        print("object plane:")
        print(f"  sent {op['plane_bytes_sent'] / mb:.1f} MB "
              f"(raw {op['plane_raw_bytes_sent'] / mb:.1f} / pickled "
              f"{op['plane_pickled_bytes_sent'] / mb:.1f})  "
              f"received {op['plane_bytes_received'] / mb:.1f} MB "
              f"(raw {op['plane_raw_bytes_received'] / mb:.1f} / pickled "
              f"{op['plane_pickled_bytes_received'] / mb:.1f})")
        print(f"  transfers in={op['plane_transfers_in']} "
              f"failed={op['plane_transfers_failed']} "
              f"stripe_retries={op['plane_stripe_retries']}  "
              f"window now={op['plane_window_occupancy']} "
              f"peak={op['plane_window_peak']}  "
              f"last {op['plane_last_transfer_mbps']} MB/s "
              f"(ewma {op['plane_ewma_transfer_mbps']})")
    pulls = st.get("pulls")
    if pulls:
        print(f"pulls: {pulls['num_pulls']} done "
              f"({pulls['bytes_pulled'] / (1 << 20):.1f} MB), "
              f"{pulls['num_failed']} failed, {pulls['queued']} queued, "
              f"{pulls['inflight_bytes'] / (1 << 20):.1f} MB in flight")
    bc = st.get("broadcasts")
    if bc:
        print(f"broadcasts: {bc['bcast_active_trees']} active, "
              f"{bc['bcast_trees_completed']} done, "
              f"{bc['bcast_trees_failed']} degraded; "
              f"{bc['bcast_members_reached']} replicas via tree "
              f"(+{bc['bcast_members_fallback']} pull fallback, "
              f"{bc['bcast_joins']} pull joins)")
        if bc.get("bcast_trees_started"):
            print(f"  relay fanout {bc['bcast_relay_fanout']}  "
                  f"time-to-all ewma {bc['bcast_time_to_all_ewma_s']}s")
        op2 = st.get("object_plane") or {}
        if op2.get("bcast_chunks_pulled") or \
                op2.get("bcast_chunks_relayed"):
            print(f"  chunks relayed={op2['bcast_chunks_relayed']} "
                  f"pulled={op2['bcast_chunks_pulled']} "
                  f"sealed-served={op2['bcast_chunks_sealed_served']}")
    lz = st.get("leasing") or {}
    if lz.get("sources"):
        print(f"leasing: hit_rate={lz.get('lease_hit_rate', 0.0)} "
              f"local={lz.get('leases_granted_local', 0)} "
              f"spillbacks={lz.get('spillbacks', 0)} "
              f"revocations={lz.get('lease_revocations', 0)} "
              f"issued={lz.get('leases_issued', 0)}")
        sb = lz["sources"].get("standby") or {}
        if sb:
            print(f"  standby: role={sb.get('role')} "
                  f"promotions={sb.get('promotions', 0)} "
                  f"failover_ms={sb.get('failover_ms')}")
    if st["jobs"]:
        print(f"jobs ({len(st['jobs'])}):")
        for j in st["jobs"]:
            print(f"  {j['job_id']}  {j['status']:<10} {j['entrypoint']}")
    plane = st.get("serve") or {}
    if plane:
        print(f"serve deployments ({len(plane)}):")
        for name in sorted(plane):
            s = plane[name]
            line = (f"  {name}  replicas={s.get('replicas', 0)} "
                    f"inflight={s.get('inflight', 0)} "
                    f"queued={s.get('queued', 0)} "
                    f"qps={s.get('qps', 0)} "
                    f"p50={s.get('p50_ms', 0)}ms "
                    f"p99={s.get('p99_ms', 0)}ms "
                    f"shed={s.get('shed', 0)} "
                    f"expired={s.get('expired', 0)}")
            if s.get("batches"):
                line += (f" batches={s['batches']}"
                         f"(mean={s['batch_size_mean']})")
            print(line)
    tr = st.get("train") or {}
    for run in tr.get("runs") or []:
        print(f"train run {run.get('run')}: state={run.get('state')} "
              f"epoch={run.get('epoch')} step={run.get('step')} "
              f"world={run.get('world', 0)} "
              f"goodput_eps={run.get('goodput_eps', 0.0)} "
              f"gang_losses={run.get('gang_losses', 0)} "
              f"planned_resizes={run.get('planned_resizes', 0)} "
              f"failures={run.get('failures', 0)} "
              f"sync_broadcasts={run.get('sync_broadcasts', 0)} "
              f"ckpt_replications={run.get('ckpt_replications', 0)}")
    tl = tr.get("loans") or {}
    if tl.get("loans_total") or tl.get("reverse_lends_total"):
        print(f"capacity loans: serve<-batch "
              f"active={tl.get('loans_active', 0)} "
              f"total={tl.get('loans_total', 0)} "
              f"reclaimed={tl.get('reclaims_total', 0)} "
              f"lost={tl.get('loans_lost', 0)}  |  batch<-serve "
              f"active={tl.get('reverse_lends_active', 0)} "
              f"total={tl.get('reverse_lends_total', 0)} "
              f"returned={tl.get('reverse_lends_returned', 0)} "
              f"lost={tl.get('reverse_lends_lost', 0)}")
    versions = st.get("versions") or {}
    if versions:
        print(f"model versions ({len(versions)}):")
        for name in sorted(versions):
            v = versions[name]
            line = (f"  {name}  current={v.get('current')} "
                    f"previous={v.get('previous') or '—'}")
            ro = v.get("rollout")
            if ro:
                line += (f"  rollout->{ro['to']} {ro['phase']} "
                         f"{ro['flipped']}/{ro['replicas']}")
                if ro.get("error"):
                    line += f" ({ro['error']})"
            print(line)
    return 0


def cmd_drain(args) -> int:
    """``ray_tpu_torch drain <node_id>`` — preemption-notice drain
    (reference: ``ray drain-node`` / the DrainNode RPC)."""
    client = _client(args.address)
    try:
        st = client.call("drain_node", args.node_id, args.reason,
                         args.deadline, timeout=30.0)
    finally:
        client.close()
    print(f"{st['node_id'][:16]}…  {st['state']} "
          f"deadline_s={st['deadline_s']} reason={st['reason']}")
    return 0


def cmd_rollout(args) -> int:
    """``ray_tpu_torch rollout <deployment> [artifact]`` — model-version
    plane.  Without an artifact: print the deployment's KV-journaled
    version record (or every deployment's, with no name).
    ``--pause/--resume/--abort`` write the operator control flag the
    driver-side controller polls between flips — routed through the
    head so the flag lands in the GCS-snapshotted KV and survives a
    standby promotion.  With an artifact path: run the rolling update
    from THIS process; the serve control plane is driver-hosted, so
    starting a rollout only works where the app was deployed (scripts
    embedding ``cli.main`` or an interactive driver) — elsewhere use
    ``ray_tpu_torch.versioning.rollout`` on the driver."""
    op = ("pause" if args.pause else "resume" if args.resume
          else "abort" if args.abort else None)
    if op is not None or args.artifact is None:
        client = _client(args.address)
        try:
            out = client.call("rollout", op or "status",
                              deployment=args.deployment or "",
                              timeout=30.0)
        finally:
            client.close()
        print(json.dumps(out, indent=2, default=str))
        return 0
    if not args.deployment:
        raise SystemExit("rollout start needs a deployment (app) name")
    from .. import versioning
    with open(args.artifact, "rb") as f:
        artifact = f.read()
    summary = versioning.rollout(
        artifact, app_name=args.deployment,
        artifact_label=os.path.basename(args.artifact))
    print(json.dumps(summary, indent=2, default=str))
    return 0 if summary.get("phase") == "SEALED" else 1


def cmd_chaos(args) -> int:
    """``ray_tpu_torch chaos`` — control the head's seeded network-chaos
    plane (``rpc/chaos.py``): inject drops/dups/delays, partition and
    heal links, read the injected-fault trace."""
    if args.off:
        op, kw = "off", {}
    elif args.partition:
        op, kw = "partition", {"src": args.partition[0],
                               "dst": args.partition[1]}
    elif args.heal:
        op, kw = "heal", {"src": args.src, "dst": args.dst}
    elif args.trace:
        op, kw = "trace", {}
    elif args.reset_trace:
        op, kw = "reset_trace", {}
    elif any(v is not None for v in (args.seed, args.drop, args.dup,
                                     args.delay_p, args.delay_ms,
                                     args.bandwidth_mbps)):
        op = "set"
        kw = {"seed": args.seed or 0,
              "drop_p": args.drop or 0.0,
              "dup_p": args.dup or 0.0,
              "delay_p": args.delay_p or 0.0,
              "delay_ms": args.delay_ms or 0.0,
              "bandwidth_mbps": args.bandwidth_mbps or 0.0}
    else:
        op, kw = "status", {}
    # every chaos op is idempotent (set replaces, partition/heal are
    # set ops, status/trace read) — retry so the control plane stays
    # usable against the very fault injection it is steering
    from ..rpc import transport as _transport
    client = _transport.connect(_resolve_address(args.address),
                                retryable=frozenset({"chaos"}))
    try:
        out = client.call("chaos", op, **kw, timeout=30.0)
    finally:
        client.close()
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_list(args) -> int:
    """``ray_tpu_torch list tasks|actors|objects|nodes|placement-groups``
    (reference: the ``ray list`` state CLI)."""
    filters = []
    for f in args.filter or []:
        if "=" not in f:
            raise SystemExit(f"--filter needs key=value, got {f!r}")
        k, v = f.split("=", 1)
        filters.append((k, "=", v))
    client = _client(args.address)
    try:
        rows = client.call("state_list", args.kind, filters or None,
                           timeout=30.0)
    finally:
        client.close()
    if args.format == "json":
        print(json.dumps(rows, indent=2, default=str))
        return 0
    if not rows:
        print(f"no {args.kind}")
        return 0
    columns = list(rows[0])
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    print("  ".join(c.ljust(widths[c]) for c in columns))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c])
                        for c in columns))
    return 0


def cmd_memory(args) -> int:
    client = _client(args.address)
    try:
        stats = client.call("memory", timeout=30.0)
    finally:
        client.close()
    for k, v in sorted(stats.items()):
        print(f"{k}: {v}")
    return 0


def cmd_stacks(args) -> int:
    """Live all-thread stacks of every worker (the reference
    dashboard's py-spy stack sampling — SURVEY.md §5.1(c))."""
    client = _client(args.address)
    try:
        stacks = client.call("worker_stacks", args.node_row, 5.0,
                             timeout=40.0)
    finally:
        client.close()
    if not stacks:
        print("no workers replied")
        return 1
    for key in sorted(stacks):
        print(f"===== worker {key} =====")
        print(stacks[key])
    return 0


def cmd_timeline(args) -> int:
    client = _client(args.address)
    try:
        events = client.call("timeline", timeout=30.0)
    finally:
        client.close()
    out = args.output or f"timeline-{int(time.time())}.json"
    with open(out, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events to {out}")
    return 0


def cmd_job(args) -> int:
    client = _client(args.address)
    try:
        if args.job_cmd == "submit":
            import shlex
            # shlex.join, not " ".join: args with spaces/quotes (-c
            # "print('x')") must survive the server-side shlex.split
            entrypoint = shlex.join(args.entrypoint)
            runtime_env = json.loads(args.runtime_env_json) \
                if args.runtime_env_json else None
            job_id = client.call("job_submit", entrypoint, runtime_env,
                                 {"submitter": "cli"}, timeout=30.0)
            print(job_id)
            if args.wait:
                while True:
                    st = client.call("job_status", job_id, timeout=30.0)
                    if st["status"] not in ("PENDING", "RUNNING"):
                        print(st["status"])
                        print(client.call("job_logs", job_id,
                                          timeout=30.0), end="")
                        return 0 if st["status"] == "SUCCEEDED" else 1
                    time.sleep(0.25)
        elif args.job_cmd == "status":
            print(json.dumps(client.call("job_status", args.job_id,
                                         timeout=30.0), indent=2))
        elif args.job_cmd == "logs":
            print(client.call("job_logs", args.job_id, timeout=30.0),
                  end="")
        elif args.job_cmd == "list":
            for j in client.call("job_list", timeout=30.0):
                print(f"{j['job_id']}  {j['status']:<10} "
                      f"{j['entrypoint']}")
        elif args.job_cmd == "stop":
            stopped = client.call("job_stop", args.job_id, timeout=30.0)
            print("stopped" if stopped else "already finished")
    finally:
        client.close()
    return 0


def cmd_simulate(args) -> int:
    """``ray_tpu_torch simulate`` — run a scripted chaos campaign on the
    in-process cluster simulator (``ray_tpu_torch/sim/``): N simulated nodes'
    control planes on a virtual clock, faults injected from seeded
    Philox streams, invariants checked after every event.  Same seed ⇒
    identical trace hash; ``--verify-replay`` proves it inline."""
    from ..sim import run_campaign

    def _run(out=None):
        return run_campaign(
            args.nodes, seed=args.seed, campaign=args.campaign,
            faults=args.faults, duration=args.duration,
            autoscale=not args.no_autoscale, out=out,
            progress=lambda msg: print(f"  {msg}", file=sys.stderr))

    result = _run(out=args.out)
    summary = result.to_dict()
    if args.out:
        print(f"trace artifact: {args.out}", file=sys.stderr)
    if args.verify_replay:
        replay = _run()
        summary["replay_hash"] = replay.trace_hash
        summary["replay_matches"] = \
            replay.trace_hash == result.trace_hash
        if not summary["replay_matches"]:
            print(f"replay hash mismatch:\n  first:  "
                  f"{result.trace_hash}\n  replay: "
                  f"{replay.trace_hash}", file=sys.stderr)
            summary["violations"].append(
                "replay hash mismatch: the campaign is not "
                "deterministic")
    if result.violations:
        # every invariant violation self-describes as
        # [inv:<name> @t=<virtual s>]; surface them (and where the
        # trace went) instead of burying them in the JSON blob
        names = ", ".join(sorted(_violation_names(result.violations)))
        print(f"{len(result.violations)} invariant violation(s) — "
              f"names: {names or 'unstructured'}", file=sys.stderr)
        for v in result.violations[:20]:
            print(f"  {v}", file=sys.stderr)
        if len(result.violations) > 20:
            print(f"  ... {len(result.violations) - 20} more",
                  file=sys.stderr)
        print(f"trace artifact: {args.out}" if args.out else
              "re-run with --out PATH to keep the replayable trace",
              file=sys.stderr)
    print(json.dumps(summary, indent=2))
    return 0 if summary.get("ok") and \
        summary.get("replay_matches", True) else 1


def _violation_names(violations):
    from ..sim.invariants import violation_names
    return violation_names(violations)


def cmd_hunt(args) -> int:
    """``ray_tpu_torch hunt`` — coverage-guided adversarial campaign search
    (``ray_tpu_torch/sim/hunt.py``): mutate fault-schedule genomes from the
    campaign archetypes under a seeded Philox stream, chase coverage,
    and ddmin-minimize every invariant violation to a 1-minimal
    replayable genome.  ``--repro ARTIFACT`` replays a committed
    finding under the artifact's own knobs/params and exits 0 iff it
    still reproduces (hash match + signature refires)."""
    from dataclasses import replace as _dc_replace

    from ..sim.cluster import SimParams
    from ..sim.hunt import hunt, load_finding, replay_finding

    if args.repro:
        doc = load_finding(args.repro)
        res, reproduced = replay_finding(doc)
        print(json.dumps({
            "artifact": args.repro,
            "signature": doc["signature"],
            "expected_hash": doc["trace_hash"],
            "replayed_hash": res.trace_hash,
            "hash_matches": res.trace_hash == doc["trace_hash"],
            "violations": res.violations,
            "reproduced": reproduced,
        }, indent=2))
        if reproduced:
            print(f"reproduced: {'+'.join(doc['signature'])} refired, "
                  f"trace hash matched", file=sys.stderr)
            return 0
        print(f"NOT reproduced (bug fixed, or artifact drifted):\n"
              f"  expected {doc['trace_hash']}\n"
              f"  got      {res.trace_hash}", file=sys.stderr)
        return 1

    params = None
    if args.canary:
        params = _dc_replace(SimParams.from_config(), canary=True)
    campaigns = tuple(args.campaigns.split(",")) if args.campaigns \
        else None
    t0 = time.perf_counter()
    r = hunt(
        budget=args.budget, nodes=args.nodes, seed=args.seed,
        faults=args.faults, duration=args.duration,
        campaigns=campaigns, params=params, out_dir=args.out,
        minimize=not args.no_minimize,
        progress=lambda msg: print(f"  {msg}", file=sys.stderr))
    wall = time.perf_counter() - t0
    report = r.to_dict()
    report["wall_s"] = round(wall, 3)
    report["runs_per_sec"] = round(r.runs / max(wall, 1e-9), 2)
    if args.out:
        report_path = os.path.join(args.out, "hunt-report.json")
        os.makedirs(args.out, exist_ok=True)
        with open(report_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
        print(f"hunt report: {report_path}", file=sys.stderr)
    for f in r.findings:
        where = f.artifact or "(re-run with --out DIR for the artifact)"
        print(f"finding {'+'.join(f.signature)}: "
              f"{len(f.genome.ops)} -> {len(f.minimized.ops)} ops "
              f"({f.ddmin_probes} ddmin probes, found after "
              f"{f.found_after_runs} runs) — repro: "
              f"ray_tpu_torch hunt --repro {where}", file=sys.stderr)
    # stdout JSON stays light: full genomes live in the artifacts
    for f in report["findings"]:
        f.pop("genome", None)
        f.pop("minimized", None)
        f.pop("knobs", None)
        f.pop("params", None)
    print(json.dumps(report, indent=2))
    return 0


def cmd_lint(args) -> int:
    """Run rtlint (``ray_tpu_torch/tools/rtlint``) — the project-native
    concurrency & invariant analyzer — over the package.  Exit 0 when
    every finding is baselined; non-zero otherwise, so it can gate PRs."""
    from ..tools.rtlint.__main__ import main as rtlint_main
    forward = []
    if args.format != "text":
        forward.append(f"--format={args.format}")
    if args.update_baseline:
        forward.append("--update-baseline")
    if args.no_baseline:
        forward.append("--no-baseline")
    if args.rules:
        forward.append(f"--rules={args.rules}")
    return rtlint_main(forward)


def cmd_microbenchmark(args) -> int:
    """Single-node perf suite (reference ``ray microbenchmark``,
    BASELINE config #1: many tiny tasks)."""
    import ray_tpu_torch

    ray_tpu_torch.init()
    results = {}
    try:
        @ray_tpu_torch.remote
        def noop():
            return None

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        # warmup
        ray_tpu_torch.get([noop.remote() for _ in range(50)], timeout=60)

        n = args.num_tasks
        t0 = time.perf_counter()
        ray_tpu_torch.get([noop.remote() for _ in range(n)], timeout=300)
        dt = time.perf_counter() - t0
        results["tasks_per_second"] = n / dt

        actor = Counter.remote()
        ray_tpu_torch.get(actor.inc.remote(), timeout=60)
        m = max(n // 4, 100)
        t0 = time.perf_counter()
        ray_tpu_torch.get([actor.inc.remote() for _ in range(m)], timeout=300)
        dt = time.perf_counter() - t0
        results["actor_calls_per_second"] = m / dt

        t0 = time.perf_counter()
        for _ in range(100):
            ray_tpu_torch.get(ray_tpu_torch.put(b"x" * 1024), timeout=60)
        results["put_get_p50_us"] = (time.perf_counter() - t0) / 100 * 1e6
    finally:
        ray_tpu_torch.shutdown()
    for k, v in results.items():
        print(f"{k}: {v:,.1f}")
    print(json.dumps({"microbenchmark": results}))
    return 0


# -- parser ------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch cluster CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    ph = sub.add_parser("head", help="run the head daemon in foreground")
    ph.add_argument("--port", type=int, default=0)
    ph.add_argument("--resources", default=None)
    ph.add_argument("--num-workers", type=int, default=None)
    ph.add_argument("--persist", default=None,
                    help="GCS snapshot path: enables head fault "
                         "tolerance (restore on restart)")
    ph.set_defaults(fn=cmd_head)

    ps = sub.add_parser("start", help="start cluster daemons")
    ps.add_argument("--head", action="store_true")
    ps.add_argument("--address", default=None,
                    help="join an existing head as a worker node "
                         "(mutually exclusive with --head)")
    ps.add_argument("--port", type=int, default=0)
    ps.add_argument("--resources", default=None,
                    help='JSON, e.g. \'{"CPU": 8, "memory": 16}\'')
    ps.add_argument("--num-workers", type=int, default=None)
    ps.add_argument("--labels", default=None,
                    help="JSON node labels (worker nodes only)")
    ps.add_argument("--block", action="store_true",
                    help="run in the foreground")
    ps.set_defaults(fn=cmd_start)

    pa = sub.add_parser("agent",
                        help="run a worker-node agent in foreground")
    pa.add_argument("--address", required=True,
                    help="head RPC address (host:port)")
    pa.add_argument("--resources", default=None)
    pa.add_argument("--num-workers", type=int, default=2)
    pa.add_argument("--labels", default=None, help="JSON node labels")
    pa.add_argument("--standby-address", default=None,
                    help="hot-standby head to vote at on head-link "
                         "loss (sub-heartbeat failover)")
    pa.add_argument("--reconnect-timeout", type=float, default=60.0,
                    help="seconds to retry a lost head before exiting "
                         "(0 disables; survives head restarts)")
    pa.set_defaults(fn=cmd_agent)

    psb = sub.add_parser(
        "standby",
        help="run a hot-standby head watching a primary")
    psb.add_argument("--address", required=True,
                     help="primary head host:port to watch")
    psb.add_argument("--port", type=int, default=0,
                     help="standby vote/status port (0 = ephemeral)")
    psb.add_argument("--persist", default=None,
                     help="the PRIMARY's persist snapshot path; the "
                          "promoted head restores from it")
    psb.add_argument("--resources", default=None)
    psb.add_argument("--num-workers", type=int, default=None)
    psb.set_defaults(fn=cmd_standby)

    pst = sub.add_parser("stop", help="stop the running cluster")
    pst.add_argument("--address", default=None)
    pst.set_defaults(fn=cmd_stop)

    pq = sub.add_parser("status", help="cluster status")
    pq.add_argument("--address", default=None)
    pq.set_defaults(fn=cmd_status)

    pd = sub.add_parser(
        "drain", help="gracefully retire a node (ALIVE -> DRAINING "
                      "-> removed); running tasks finish, queued work "
                      "and bundles re-place elsewhere")
    pd.add_argument("node_id", help="node id (hex, from `status`)")
    pd.add_argument("--reason", default="cli drain")
    pd.add_argument("--deadline", type=float, default=None,
                    help="grace seconds before force-removal "
                         "(default: drain_deadline_s config)")
    pd.add_argument("--address", default=None)
    pd.set_defaults(fn=cmd_drain)

    pr = sub.add_parser(
        "rollout", help="model-version plane: show the version "
        "journal, pause/resume/abort an in-flight rolling update, or "
        "run one (driver-hosted: start only works where the app runs)")
    pr.add_argument("deployment", nargs="?", default="",
                    help="serve app name (omit to list every "
                         "deployment's version record)")
    pr.add_argument("artifact", nargs="?", default=None,
                    help="path to the new weight artifact — starts a "
                         "rolling update and blocks until SEALED or "
                         "ROLLED_BACK")
    pr.add_argument("--pause", action="store_true",
                    help="hold the flip loop after the current replica")
    pr.add_argument("--resume", action="store_true",
                    help="release a paused rollout")
    pr.add_argument("--abort", action="store_true",
                    help="stop flipping and roll back to the old "
                         "version")
    pr.add_argument("--address", default=None)
    pr.set_defaults(fn=cmd_rollout)

    pc = sub.add_parser(
        "chaos", help="control the seeded network-chaos plane "
        "(drop/dup/delay injection, partitions, fault trace)")
    pc.add_argument("--address", default=None)
    pc.add_argument("--seed", type=int, default=None)
    pc.add_argument("--drop", type=float, default=None,
                    help="per-message drop probability")
    pc.add_argument("--dup", type=float, default=None,
                    help="per-message duplication probability")
    pc.add_argument("--delay-p", type=float, default=None,
                    help="per-message delay probability")
    pc.add_argument("--delay-ms", type=float, default=None,
                    help="mean injected delay (ms)")
    pc.add_argument("--bandwidth-mbps", type=float, default=None,
                    help="per-connection bandwidth cap (MB/s)")
    pc.add_argument("--partition", nargs=2, metavar=("SRC", "DST"),
                    default=None,
                    help="add a directed partition SRC ↛ DST "
                    "('*' = wildcard)")
    pc.add_argument("--heal", action="store_true",
                    help="remove partitions (all, or --src/--dst)")
    pc.add_argument("--src", default=None)
    pc.add_argument("--dst", default=None)
    pc.add_argument("--status", action="store_true")
    pc.add_argument("--trace", action="store_true",
                    help="dump the injected-fault trace")
    pc.add_argument("--reset-trace", action="store_true",
                    help="clear streams+trace (replay from draw 0)")
    pc.add_argument("--off", action="store_true")
    pc.set_defaults(fn=cmd_chaos)

    pl = sub.add_parser("list", help="list live cluster state")
    pl.add_argument("kind", choices=["tasks", "actors", "objects",
                                     "nodes", "placement-groups"])
    pl.add_argument("--filter", action="append", default=None,
                    metavar="KEY=VALUE",
                    help="equality filter, repeatable")
    pl.add_argument("--format", choices=["table", "json"],
                    default="table")
    pl.add_argument("--address", default=None)
    pl.set_defaults(fn=cmd_list)

    pm = sub.add_parser("memory", help="object store stats")
    pm.add_argument("--address", default=None)
    pm.set_defaults(fn=cmd_memory)

    pt = sub.add_parser("timeline", help="dump Chrome trace events")
    pt.add_argument("--address", default=None)
    pt.add_argument("-o", "--output", default=None)
    pt.set_defaults(fn=cmd_timeline)

    ps2 = sub.add_parser("stacks",
                         help="live worker stack dump (py-spy analogue)")
    ps2.add_argument("--address", default=None)
    ps2.add_argument("--node-row", type=int, default=None)
    ps2.set_defaults(fn=cmd_stacks)

    pj = sub.add_parser("job", help="job submission")
    pj.add_argument("--address", default=None)
    jsub = pj.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--runtime-env-json", default=None)
    js.add_argument("--wait", action="store_true",
                    help="block until the job finishes; exit 1 on failure")
    js.add_argument("entrypoint", nargs=argparse.REMAINDER,
                    help="command to run (prefix with --)")
    for name in ("status", "logs", "stop"):
        jx = jsub.add_parser(name)
        jx.add_argument("job_id")
    jsub.add_parser("list")
    pj.set_defaults(fn=cmd_job)

    pb = sub.add_parser("microbenchmark",
                        help="single-node perf suite")
    pb.add_argument("--num-tasks", type=int, default=2000)
    pb.set_defaults(fn=cmd_microbenchmark)

    psim = sub.add_parser(
        "simulate",
        help="run a chaos campaign on the in-process cluster simulator "
             "(virtual clock, seeded faults, invariant checks after "
             "every event); same seed reproduces the identical trace "
             "hash")
    psim.add_argument("--nodes", type=int, default=1000,
                      help="simulated cluster size (default 1000)")
    psim.add_argument("--seed", type=int, default=0,
                      help="Philox seed: keys the job load, the fault "
                           "schedule and every chaos link stream")
    psim.add_argument("--campaign", default="mixed")
    psim.add_argument("--faults", type=int, default=50,
                      help="scheduled fault draws (heals/restarts ride "
                           "along; default 50)")
    psim.add_argument("--duration", type=float, default=None,
                      help="virtual seconds of chaos before quiesce "
                           "(default max(180, 4*faults))")
    psim.add_argument("--out", default=None, metavar="PATH",
                      help="write the replayable trace artifact "
                           "(ray_tpu-sim-trace/1 JSON)")
    psim.add_argument("--verify-replay", action="store_true",
                      help="run the campaign twice and fail unless the "
                           "trace hashes match")
    psim.add_argument("--no-autoscale", action="store_true",
                      help="disable the simulated autoscaler loop")
    psim.set_defaults(fn=cmd_simulate)

    phunt = sub.add_parser(
        "hunt",
        help="coverage-guided adversarial chaos search: mutate fault "
             "schedules, hunt invariant violations, ddmin each failure "
             "to a minimal replayable genome")
    phunt.add_argument("--budget", type=int, default=120,
                       help="exploration sim runs to spend "
                            "(ddmin probes ride on top; default 120)")
    phunt.add_argument("--nodes", type=int, default=24,
                       help="simulated cluster size per run "
                            "(default 24)")
    phunt.add_argument("--seed", type=int, default=0,
                       help="Philox seed for the whole search: same "
                            "(seed, budget) finds the same failures "
                            "in the same order")
    phunt.add_argument("--faults", type=int, default=24,
                       help="fault draws per seed genome (default 24)")
    phunt.add_argument("--duration", type=float, default=160.0,
                       help="virtual seconds of chaos per run "
                            "(default 160)")
    phunt.add_argument("--campaigns", default=None,
                       help="comma-separated archetype seed genomes "
                            "(default: all campaigns)")
    phunt.add_argument("--out", default=None, metavar="DIR",
                       help="write finding artifacts "
                            "(ray_tpu-hunt-finding/1) and the hunt "
                            "report here")
    phunt.add_argument("--repro", default=None, metavar="ARTIFACT",
                       help="replay a finding artifact under its own "
                            "knobs/params; exit 0 iff it reproduces")
    phunt.add_argument("--canary", action="store_true",
                       help="arm the planted canary bug (smoke-tests "
                            "the search itself)")
    phunt.add_argument("--no-minimize", action="store_true",
                       help="skip ddmin on findings")
    phunt.set_defaults(fn=cmd_hunt)

    plint = sub.add_parser(
        "lint",
        help="concurrency & invariant analyzer (rtlint): blocking-"
             "under-lock, lock-order cycles, config-knob discipline, "
             "thread lifecycle, clock seams, host<->device syncs, "
             "lockset races, replay determinism; non-zero exit on "
             "non-baselined findings")
    plint.add_argument("--format", choices=("text", "json", "sarif"),
                       default="text")
    plint.add_argument("--rules", default=None,
                       help="comma-separated subset of "
                            "W1,W2,W3,W4,W5,W6,W7,W8")
    plint.add_argument("--update-baseline", action="store_true",
                       help="accept current findings into "
                            "ray_tpu_torch/tools/rtlint/baseline.json")
    plint.add_argument("--no-baseline", action="store_true",
                       help="report every finding, ignore the baseline")
    plint.set_defaults(fn=cmd_lint)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "entrypoint", None) and args.entrypoint \
            and args.entrypoint[0] == "--":
        args.entrypoint = args.entrypoint[1:]
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

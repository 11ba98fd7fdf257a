"""Dispatch-throughput storm: the lease plane's headline numbers.

Drives a steady repeat-class job stream through a simulated cluster
twice — head-only path vs lease plane — and reports dispatch throughput
over **modeled head service time** (deterministic virtual microseconds:
a scheduling RPC costs ``_HEAD_RPC_US``, a heartbeat touch
``_HEAD_TOUCH_US``, a batched item ``_HEAD_ITEM_US``; see
``sim/cluster.py``).  The ratio is a pure function of RPC counts and
those constants, so the same seed reproduces the same numbers and the
same trace hash, byte for byte.

The failover variant SIGKILLs the head mid-stream with the hot standby
armed and reports the kill→first-post-promotion-placement window.

Used by ``bench.py`` (the committed BENCH artifact) and
``tests/test_leasing.py`` (the acceptance thresholds).
"""

from __future__ import annotations

from .cluster import HEAD_ADDR, SimCluster, SimParams

__all__ = ["run_dispatch_storm", "run_dispatch_comparison"]

# repeat-class workload: durations stand in for interned resource
# request vectors (see SimHead._class_key) — 8 classes, short tasks
_CLASSES = (1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5)


def run_dispatch_storm(num_nodes: int = 200, jobs: int = 200,
                       tasks_per_job: int = 16,
                       classes: tuple = _CLASSES, seed: int = 0,
                       lease_plane: bool = True, standby: bool = False,
                       kill_head_at: float | None = None,
                       submit_period_s: float = 0.25,
                       heartbeat_period_s: float = 5.0,
                       settle_cap_s: float = 1800.0) -> dict:
    """One storm run; returns the throughput/hit-rate/failover record."""
    import numpy as np

    from ..rpc.client import RpcConnectionError

    rng = np.random.Generator(np.random.Philox(
        key=[int(seed) & (2 ** 64 - 1), 0xD15C47C4]))
    params = SimParams(heartbeat_period_s=heartbeat_period_s,
                       lease_plane=lease_plane, standby=standby)
    cluster = SimCluster(num_nodes, seed=seed, params=params)
    clock = cluster.clock
    acked: list[str] = []
    completed = {"n": 0}

    # the whole job stream is drawn up-front so the submission order —
    # and therefore the trace — is a pure function of the seed.  Each
    # job is single-class (an actor pool / map wave of same-shaped
    # tasks): the repeat-class steady state the lease plane serves
    stream = []
    for k in range(jobs):
        jid = f"d{k:05d}"
        duration = classes[int(rng.integers(0, len(classes)))]
        tasks = {f"{jid}.t{i}": duration for i in range(tasks_per_job)}
        stream.append((jid, tasks))

    with cluster:
        driver = cluster.transport.connect(HEAD_ADDR,
                                           _sim_src="sim://driver")

        def submit(jid, tasks, attempt=0):
            try:
                if driver.call("job_submit", jid, tasks) == "ack":
                    acked.append(jid)
                    return
            except RpcConnectionError:
                pass
            if attempt < 60:        # head down (failover window)
                clock.call_later(1.0, lambda: submit(jid, tasks,
                                                     attempt + 1))

        t0 = heartbeat_period_s + 1.0   # past the registration stagger
        for k, (jid, tasks) in enumerate(stream):
            clock.call_later(t0 + k * submit_period_s,
                             lambda jid=jid, tasks=tasks:
                             submit(jid, tasks))
        if kill_head_at is not None:
            clock.call_later(float(kill_head_at), cluster.kill_head)

        def all_done():
            head = cluster.head
            if head is None or not head.alive:
                return False
            done = sum(1 for jid in acked
                       if head.jobs.get(jid, {}).get("status") ==
                       "succeeded")
            completed["n"] = done
            return len(acked) == len(stream) and done == len(acked)

        horizon = t0 + jobs * submit_period_s
        clock.run_until(horizon)
        settle_end = horizon + settle_cap_s
        while not all_done() and clock.monotonic() < settle_end:
            clock.advance(heartbeat_period_s)
        stats = cluster.stats()
    cluster.close()

    rec = {
        "mode": "lease" if lease_plane else "head_only",
        "nodes": num_nodes, "seed": int(seed),
        "jobs": jobs, "tasks": jobs * tasks_per_job,
        "jobs_completed": completed["n"],
        "tasks_done": stats["dispatch"]["tasks_done"],
        "head_busy_s": stats["dispatch"]["head_busy_s"],
        "head_dispatch_s": stats["dispatch"]["head_dispatch_s"],
        "dispatch_throughput_per_s":
            stats["dispatch"]["throughput_per_s"],
        "virtual_s": stats["virtual_s"],
        "trace_hash": cluster.trace.hash(),
    }
    if lease_plane:
        lz = stats["leasing"]
        rec.update({
            "lease_hit_rate": lz["lease_hit_rate"],
            "leases_granted_local": lz["leases_granted_local"],
            "spillbacks": lz["spillbacks"],
            "lease_revocations": lz["lease_revocations"],
            "promotions": lz["promotions"],
            "failover_ms": lz["failover_ms"],
        })
    return rec


def run_dispatch_comparison(num_nodes: int = 200, jobs: int = 200,
                            tasks_per_job: int = 16, seed: int = 0,
                            kill_head_at: float | None = None,
                            **kw) -> dict:
    """Head-only baseline vs lease plane on the identical job stream
    (+ optionally a standby-armed failover run).  The speedup ratio is
    the acceptance number: steady-state dispatch throughput of the
    lease plane over the head-only path."""
    base = run_dispatch_storm(num_nodes, jobs, tasks_per_job,
                              seed=seed, lease_plane=False, **kw)
    lease = run_dispatch_storm(num_nodes, jobs, tasks_per_job,
                               seed=seed, lease_plane=True, **kw)
    out = {
        "head_only": base,
        "lease": lease,
        "speedup": round(
            lease["dispatch_throughput_per_s"] /
            base["dispatch_throughput_per_s"], 3)
        if base["dispatch_throughput_per_s"] else 0.0,
    }
    if kill_head_at is not None:
        out["failover"] = run_dispatch_storm(
            num_nodes, jobs, tasks_per_job, seed=seed,
            lease_plane=True, standby=True,
            kill_head_at=kill_head_at, **kw)
    return out

"""Lease plane + hot-standby head (r15).

Covers the local-grant/spillback state machine, epoch revocation races,
the batched multi-submit framing, the deterministic dispatch-storm
acceptance numbers, and a live SIGKILL-the-head promotion with the
interrupted job completing on the promoted head.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from ray_tpu_torch.leasing import (LeaseGrantor, LocalLeaseCache,
                             aggregate_stats, register_stats,
                             unregister_stats)
from ray_tpu_torch.rpc import RpcClient, wire
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_leasing.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).
# - ``JOB_SCRIPT``'s tasks sleep 1.0 s, not 0.5 s.  The live promotion
#   test kills the head 2.5 s after the first task starts and asserts
#   the job is still running.  Eight tasks of 0.5 s on two one-worker
#   agents can end 2.0 s after the first starts, and they do whenever
#   the head places them evenly (4/4).  The reference's head is still
#   running then only because its first placement round is slow (a jit
#   compile), which leaves a 6/2 split.  At 1.0 s any split runs at
#   least 4.0 s, so the kill lands mid-job whatever the rounds are; the
#   2.5 s wait and every assertion are the reference's.


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- local cache: hit / miss / spillback / fence / epoch ---------------------
class TestLocalLeaseCache:
    def _cache(self, **kw):
        kw.setdefault("capacity", 8)
        kw.setdefault("fence_after_s", 30.0)
        return LocalLeaseCache(**kw)

    def test_miss_then_install_then_hit(self):
        c = self._cache()
        c.on_head_contact(0.0)
        assert not c.try_grant("CPU:1", 1.0)        # no snapshot: spill
        c.install({"CPU:1": 2}, epoch=0)
        assert c.try_grant("CPU:1", 1.0)
        assert c.try_grant("CPU:1", 1.0)
        assert not c.try_grant("CPU:1", 1.0)        # budget exhausted
        c.release("CPU:1")
        assert c.try_grant("CPU:1", 1.0)            # headroom returned
        s = c.stats()
        assert s["leases_granted_local"] == 3
        assert s["spillbacks"] == 2

    def test_overcommit_caps_total_admission(self):
        c = self._cache(capacity=2, overcommit=2.0)
        c.on_head_contact(0.0)
        c.install({"a": 100, "b": 100}, epoch=0)
        grants = sum(c.try_grant("a", 0.0) for _ in range(3)) + \
            sum(c.try_grant("b", 0.0) for _ in range(3))
        assert grants == 4                          # 2 * 2.0, not 6

    def test_fencing_after_lost_head_contact(self):
        c = self._cache(fence_after_s=10.0)
        c.on_head_contact(100.0)
        c.install({"CPU:1": 4}, epoch=0)
        assert c.try_grant("CPU:1", 105.0)
        assert not c.try_grant("CPU:1", 111.0)      # past the fence
        assert c.stats()["fenced_denials"] == 1
        c.on_head_contact(111.0)                    # contact restores
        assert c.try_grant("CPU:1", 112.0)

    def test_epoch_advance_discards_admissions(self):
        c = self._cache()
        c.on_head_contact(0.0)
        c.install({"CPU:1": 2}, epoch=1)
        assert c.try_grant("CPU:1", 0.0)
        assert not c.observe_epoch(1)               # same epoch: no-op
        assert c.observe_epoch(3)                   # head revoked
        assert c.epoch == 3
        assert c.stats()["admitted"] == 0           # counters zeroed
        # stale install from before the bump cannot roll the epoch back
        c.install({"CPU:1": 2}, epoch=2)
        assert c.epoch == 3

    def test_release_after_epoch_bump_is_benign(self):
        # the double-release race: a RUNNING task finishes after the
        # revocation already zeroed its admission counter
        c = self._cache()
        c.on_head_contact(0.0)
        c.install({"CPU:1": 4}, epoch=0)
        assert c.try_grant("CPU:1", 0.0)
        c.observe_epoch(2)
        c.release("CPU:1")                          # must not go negative
        assert c.try_grant("CPU:1", 0.0)
        assert c.stats()["admitted"] == 1

    def test_lru_eviction_at_max_classes(self):
        c = self._cache(max_classes=2)
        c.on_head_contact(0.0)
        c.install({"a": 1}, 0)
        c.install({"b": 1}, 0)
        assert c.try_grant("a", 0.0)                # refresh a's recency
        c.install({"c": 1}, 0)                      # evicts b, not a
        assert c.holds("a") and c.holds("c") and not c.holds("b")


# -- head-side grantor: epochs, revocation, rr origin routing ----------------
class TestLeaseGrantor:
    def test_grant_snapshot_and_revoke_journal(self):
        journal = []
        g = LeaseGrantor(budget_per_class=4,
                         journal=lambda n, e: journal.append((n, e)))
        ep, grants = g.grant("n1", "CPU:1")
        assert ep == 0 and grants == {"CPU:1": 4}
        g.grant("n1", "GPU:1", budget=7)
        assert g.snapshot_for("n1") == (0, {"CPU:1": 4, "GPU:1": 7})
        assert g.revoke("n1") == 1
        assert journal == [("n1", 1)]
        assert g.snapshot_for("n1")[0] == 1         # grants outlive the
        assert g.holds("n1", "CPU:1")               # bump; epoch fences

    def test_drop_node_forgets_grants_and_routing(self):
        g = LeaseGrantor(budget_per_class=2)
        g.grant("n1", "CPU:1")
        assert g.origin_for("CPU:1") == "n1"
        g.drop_node("n1")
        assert g.origin_for("CPU:1") is None
        assert g.snapshot_for("n1") == (1, {})

    def test_origin_round_robins_over_holders(self):
        g = LeaseGrantor(budget_per_class=2)
        g.grant("n1", "CPU:1")
        g.grant("n2", "CPU:1")
        picks = [g.origin_for("CPU:1") for _ in range(4)]
        assert picks == ["n1", "n2", "n1", "n2"]
        picks = [g.origin_for("CPU:1",
                              eligible=lambda n: n == "n2")
                 for _ in range(2)]
        assert picks == ["n2", "n2"]

    def test_restore_never_rolls_epochs_back(self):
        g = LeaseGrantor(budget_per_class=2)
        g.revoke("n1")
        g.revoke("n1")                              # n1 at epoch 2
        g.restore({"n1": 1, "n2": 5})               # stale n1, new n2
        assert g.epoch("n1") == 2 and g.epoch("n2") == 5


# -- stats registry: the /metrics + /api/leases aggregation ------------------
class TestStatsRegistry:
    def test_aggregate_sums_counters_across_sources(self):
        c = LocalLeaseCache(capacity=4, fence_after_s=30.0)
        c.on_head_contact(0.0)
        c.install({"a": 2}, 0)
        c.try_grant("a", 0.0)
        c.try_grant("zzz", 0.0)                     # spill
        g = LeaseGrantor(budget_per_class=2)
        g.grant("n1", "a")
        g.revoke("n1")
        register_stats("_t_agent", c.stats)
        register_stats("_t_head", g.stats)
        try:
            agg = aggregate_stats()
            assert agg["leases_granted_local"] == 1
            assert agg["spillbacks"] == 1
            assert agg["lease_revocations"] == 1
            assert agg["leases_issued"] == 1
            assert agg["lease_hit_rate"] == 0.5
            assert "_t_agent" in agg["sources"]
        finally:
            unregister_stats("_t_agent")
            unregister_stats("_t_head")


# -- wire framing: the batched worker->raylet->head submit path --------------
class TestMultiSubmitFraming:
    def test_round_trip(self):
        entries = [b"alpha", b"", b"b" * 4096, b"\x01\x00tail"]
        frame = wire.pack_multi_submit(entries)
        assert wire.is_multi_submit(frame)
        assert wire.unpack_multi_submit(frame) == entries

    def test_not_multi_submit_frame(self):
        assert not wire.is_multi_submit(b"")
        assert not wire.is_multi_submit(b"\x02plain")

    def test_trailing_garbage_rejected(self):
        frame = wire.pack_multi_submit([b"one", b"two"]) + b"xx"
        with pytest.raises(ConnectionError):
            wire.unpack_multi_submit(frame)


# -- deterministic dispatch storms: the acceptance surface -------------------
class TestDispatchSim:
    def test_lease_plane_beats_head_only_and_replays(self):
        from ray_tpu_torch.sim.dispatch_bench import run_dispatch_comparison
        cmp_ = run_dispatch_comparison(num_nodes=200, jobs=120,
                                       tasks_per_job=8, seed=0)
        assert cmp_["speedup"] >= 2.0, cmp_["speedup"]
        assert cmp_["lease"]["lease_hit_rate"] >= 0.9
        assert cmp_["lease"]["jobs_completed"] == 120
        assert cmp_["head_only"]["jobs_completed"] == 120
        # bit-identical replay: same seed, same trace hash
        from ray_tpu_torch.sim.dispatch_bench import run_dispatch_storm
        again = run_dispatch_storm(num_nodes=200, jobs=120,
                                   tasks_per_job=8, seed=0,
                                   lease_plane=True)
        assert again["trace_hash"] == cmp_["lease"]["trace_hash"]

    def test_head_kill_promotes_standby_within_heartbeat(self):
        from ray_tpu_torch.sim.dispatch_bench import run_dispatch_storm
        rec = run_dispatch_storm(num_nodes=200, jobs=120,
                                 tasks_per_job=8, seed=0,
                                 lease_plane=True, standby=True,
                                 kill_head_at=20.0,
                                 heartbeat_period_s=5.0)
        assert rec["promotions"] == 1, rec
        # ISSUE acceptance: first post-failover placement within one
        # heartbeat interval of the kill
        assert rec["failover_ms"] and \
            rec["failover_ms"][0] <= 5000.0, rec["failover_ms"]
        # no acked job lost across the promotion
        assert rec["jobs_completed"] == 120, rec

    def test_failover_storm_campaign_green_with_promotions(self):
        from ray_tpu_torch.sim import run_campaign
        r = run_campaign(48, seed=0, campaign="head_failover_storm",
                         faults=10, duration=120.0, autoscale=False)
        assert r.ok, r.violations
        assert r.stats["leasing"]["promotions"] >= 1
        r2 = run_campaign(48, seed=0, campaign="head_failover_storm",
                          faults=10, duration=120.0, autoscale=False)
        assert r2.trace_hash == r.trace_hash    # replay fingerprint

    @pytest.mark.slow
    def test_10k_node_acceptance_numbers(self):
        from ray_tpu_torch.sim.dispatch_bench import run_dispatch_comparison
        cmp_ = run_dispatch_comparison(num_nodes=10000, jobs=1000,
                                       tasks_per_job=16, seed=0,
                                       kill_head_at=60.0)
        assert cmp_["speedup"] >= 5.0, cmp_["speedup"]
        assert cmp_["lease"]["lease_hit_rate"] >= 0.9
        fo = cmp_["failover"]
        assert fo["promotions"] == 1
        # failover-to-first-placement within one heartbeat (5s)
        assert fo["failover_ms"][0] <= 5000.0, fo["failover_ms"]
        assert fo["jobs_completed"] == 1000


# -- live promotion: SIGKILL the head, the standby takes its port ------------
JOB_SCRIPT = """
import sys, time
import ray_tpu_torch

ray_tpu_torch.init(address="auto")

@ray_tpu_torch.remote(resources={{"slot": 1}})
def work(i):
    with open({start!r}, "w") as f:   # signals "mid-job" to the test
        f.write("x")
    time.sleep(1.0)
    return i * 2

out = sorted(ray_tpu_torch.get([work.remote(i) for i in range(8)],
                         timeout=120))
assert out == [i * 2 for i in range(8)], out
with open({marker!r}, "w") as f:
    f.write("JOB_DONE")
ray_tpu_torch.shutdown()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    return {**os.environ, "PYTHONPATH": REPO, **extra}


def _start_head(port, persist):
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "head", "--port", str(port),
         "--resources", json.dumps({"CPU": 2, "memory": 2}),
         "--num-workers", "1", "--persist", persist],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())


def _start_standby(address, persist):
    # fast probe so the promotion lands well inside the test budget
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "standby",
         "--address", address, "--persist", persist,
         "--resources", json.dumps({"CPU": 2, "memory": 2}),
         "--num-workers", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(RT_STANDBY_PROBE_INTERVAL_S="0.5",
                 RT_STANDBY_PROBE_MISSES="3"))


def _start_agent(address, standby_address):
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "agent", "--address", address,
         "--resources", json.dumps({"CPU": 2, "slot": 2}),
         "--num-workers", "1", "--reconnect-timeout", "120",
         "--standby-address", standby_address],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())


def _wait_head(address, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            c = RpcClient(address)
            c.call("ping", timeout=5.0)
            return c
        except Exception:
            time.sleep(0.3)
    raise AssertionError("head never came up")


def _wait_line(proc, needle, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if needle in line:
            return line
    raise AssertionError(f"never saw {needle!r}")


def _wait_nodes(client, n, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if len(client.call("nodes", timeout=10.0)) == n:
                return
        except Exception:
            pass
        time.sleep(0.3)
    raise AssertionError(f"never reached {n} nodes")


class TestLiveStandbyPromotion:
    def test_sigkill_head_standby_promotes_job_completes(self, tmp_path):
        port = _free_port()
        address = f"127.0.0.1:{port}"
        persist = str(tmp_path / "gcs.snap")
        marker = str(tmp_path / "job_done.txt")
        start = str(tmp_path / "job_started.txt")
        script = str(tmp_path / "job.py")
        with open(script, "w") as f:
            f.write(JOB_SCRIPT.format(marker=marker, start=start))

        head = _start_head(port, persist)
        standby = None
        agents = []
        try:
            client = _wait_head(address)
            standby = _start_standby(address, persist)
            sb_line = _wait_line(standby, "standby armed at")
            sb_addr = sb_line.split("armed at", 1)[1].split(",")[0].strip()
            agents = [_start_agent(address, sb_addr),
                      _start_agent(address, sb_addr)]
            _wait_nodes(client, 3)
            job_id = client.call(
                "job_submit", f"{sys.executable} {script}",
                timeout=30.0)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if os.path.exists(start):
                    break
                time.sleep(0.02)
            assert os.path.exists(start), "job never started"
            time.sleep(2.5)                 # a persist tick passes
            assert not os.path.exists(marker)
            os.kill(head.pid, signal.SIGKILL)
            head.wait(timeout=30)
            client.close()

            # NO restart here: the standby must detect the death
            # (probe misses + agent votes) and promote itself onto the
            # primary's port from the shared snapshot
            client = _wait_head(address, timeout=60)
            _wait_nodes(client, 3, timeout=120)
            st = client.call("status", timeout=30.0)
            assert st.get("role") == "primary"
            sb_client = RpcClient(sb_addr)
            sb_status = sb_client.call("standby_status", timeout=10.0)
            sb_client.close()
            assert sb_status["role"] == "primary"
            assert sb_status["promotions"] == 1
            assert sb_status["failover_ms"], sb_status

            # the interrupted job re-ran on the promoted head
            deadline = time.monotonic() + 180
            status = None
            while time.monotonic() < deadline:
                status = client.call("job_status", job_id, timeout=10.0)
                if status["status"] in ("SUCCEEDED", "FAILED"):
                    break
                time.sleep(0.5)
            assert status and status["status"] == "SUCCEEDED", status
            assert os.path.exists(marker)
            client.close()
        finally:
            for a in agents:
                if a.poll() is None:
                    a.kill()
                    a.wait(timeout=30)
            if standby is not None and standby.poll() is None:
                standby.kill()
                standby.wait(timeout=30)
            if head.poll() is None:
                head.kill()
            head.wait(timeout=30)

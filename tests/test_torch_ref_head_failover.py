"""Live head failover: kill -9 the head daemon mid-job, restart it, and
the cluster heals — agents reconnect, the interrupted job re-runs to
completion.

Scenario sources: upstream's Redis-backed GCS fault tolerance (head
restart with raylet resync — SURVEY.md §5.4; re-derived, not copied).
Documented divergence: runtime state lives in the head process here, so
interrupted jobs re-execute from their entrypoints instead of resuming
in place.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from ray_tpu_torch.rpc import RpcClient
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_head_failover.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JOB_SCRIPT = """
import sys, time
import ray_tpu_torch

ray_tpu_torch.init(address="auto")

@ray_tpu_torch.remote(resources={{"slot": 1}})
def work(i):
    with open({start!r}, "w") as f:   # signals "mid-job" to the test
        f.write("x")
    time.sleep(0.5)
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


def _env():
    return {**os.environ, "PYTHONPATH": REPO}


def _start_head(port, persist):
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "head", "--port", str(port),
         "--resources", json.dumps({"CPU": 2, "memory": 2}),
         "--num-workers", "1", "--persist", persist],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())


def _start_agent(address):
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "agent", "--address", address,
         "--resources", json.dumps({"CPU": 2, "slot": 2}),
         "--num-workers", "1", "--reconnect-timeout", "120"],
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


class TestHeadFailover:
    def test_kill9_head_midjob_agents_reconnect_job_completes(
            self, tmp_path):
        port = _free_port()
        address = f"127.0.0.1:{port}"
        persist = str(tmp_path / "gcs.snap")
        marker = str(tmp_path / "job_done.txt")
        start = str(tmp_path / "job_started.txt")
        script = str(tmp_path / "job.py")
        with open(script, "w") as f:
            f.write(JOB_SCRIPT.format(marker=marker, start=start))

        head = _start_head(port, persist)
        agents = []
        try:
            client = _wait_head(address)
            agents = [_start_agent(address), _start_agent(address)]
            _wait_nodes(client, 3)
            # a slow job: 8 tasks x 0.5s on one remote worker slot pair
            job_id = client.call(
                "job_submit", f"{sys.executable} {script}",
                timeout=30.0)
            # murder the head the moment a task is observed running —
            # the first task is still in its 0.5s sleep, so the job
            # cannot have finished (a fixed pre-kill sleep raced the
            # job's ~2s runtime and lost on a fast box)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if os.path.exists(start):
                    break
                time.sleep(0.02)
            assert os.path.exists(start), "job never started"
            assert not os.path.exists(marker)
            os.kill(head.pid, signal.SIGKILL)
            head.wait(timeout=30)
            client.close()

            head = _start_head(port, persist)
            client = _wait_head(address)
            # both agents rejoin the restarted head
            _wait_nodes(client, 3, timeout=120)
            # the interrupted job re-ran from its entrypoint and finished
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
            if head.poll() is None:
                try:
                    RpcClient(address).call("stop_daemon", timeout=10.0)
                    time.sleep(1.0)
                except Exception:
                    pass
            if head.poll() is None:
                head.kill()
            head.wait(timeout=30)

    def test_clean_restart_restores_kv_and_named_actors(self, tmp_path):
        """A CLEAN stop + restart with persistence keeps the GCS plane:
        KV entries and named actors are there for new clients."""
        port = _free_port()
        address = f"127.0.0.1:{port}"
        persist = str(tmp_path / "gcs2.snap")

        head = _start_head(port, persist)
        try:
            client = _wait_head(address)
            client.call("kv", "put", b"fo-key", b"fo-value", "", True,
                        timeout=10.0)
            time.sleep(3.0)     # a persist tick passes
            client.call("stop_daemon", timeout=10.0)
            client.close()
            head.wait(timeout=30)

            head = _start_head(port, persist)
            client = _wait_head(address)
            out = client.call("kv", "get", b"fo-key", None, "", True,
                              timeout=10.0)
            assert out == b"fo-value"
            client.close()
        finally:
            if head.poll() is None:
                head.kill()
            head.wait(timeout=30)

"""RPC layer, head daemon + client mode, job submission, CLI.

Scenario sources: upstream ray client (``ray.init("ray://…")`` proxies
the full API), job submission (``ray job submit`` runs entrypoints with
RAY_ADDRESS exported, captures logs, tracks status), and the `ray`
CLI — SURVEY.md §1 layers 2/15, §2.2 (scenarios re-derived, not
copied)."""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from ray_tpu_torch.rpc import RpcClient, RpcServer
from ray_tpu_torch.rpc.client import RemoteRpcError
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_client_and_jobs.py: the reference's file with
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


class TestRpc:
    def test_roundtrip_and_errors(self):
        calls = []

        def echo(x, scale=1):
            calls.append(x)
            return x * scale

        def boom():
            raise ValueError("expected")

        server = RpcServer({"echo": echo, "boom": boom}).start()
        try:
            c = RpcClient(server.address)
            assert c.call("echo", 21, scale=2) == 42
            with pytest.raises(RemoteRpcError, match="ValueError"):
                c.call("boom")
            with pytest.raises(RemoteRpcError, match="no rpc method"):
                c.call("nope")
            # the connection survives handler errors
            assert c.call("echo", 1) == 1
            c.close()
        finally:
            server.stop()

    def test_pipelining_slow_call_does_not_block_fast(self):
        import threading
        release = threading.Event()

        def slow():
            release.wait(10)
            return "slow"

        def fast():
            return "fast"

        server = RpcServer({"slow": slow, "fast": fast}).start()
        try:
            c = RpcClient(server.address)
            out = {}
            t = threading.Thread(
                target=lambda: out.setdefault("slow", c.call("slow")))
            t.start()
            time.sleep(0.05)
            t0 = time.monotonic()
            assert c.call("fast") == "fast"     # not behind slow()
            assert time.monotonic() - t0 < 2.0
            release.set()
            t.join(timeout=10)
            assert out["slow"] == "slow"
            c.close()
        finally:
            server.stop()


@pytest.fixture(scope="module")
def head():
    from ray_tpu_torch.runtime.head import HeadNode
    h = HeadNode(resources={"CPU": 4, "memory": 4}, num_workers=2)
    yield h
    h.stop()


def run_client_driver(head, body: str, timeout: float = 90.0):
    """Run a driver script as a subprocess attached in client mode."""
    script = ("import os, ray_tpu_torch\n"
              "ray_tpu_torch.init(address=os.environ['ADDR'])\n"
              + textwrap.dedent(body)
              + "\nray_tpu_torch.shutdown()\n")
    env = dict(os.environ)
    env["ADDR"] = head.address
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", script],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


class TestClientMode:
    def test_tasks_actors_objects(self, head):
        out = run_client_driver(head, """
            @ray_tpu_torch.remote
            def f(x):
                return x * 2
            print('tasks', ray_tpu_torch.get([f.remote(i) for i in range(4)],
                                       timeout=30))

            @ray_tpu_torch.remote
            class C:
                def __init__(self):
                    self.n = 0
                def inc(self):
                    self.n += 1
                    return self.n
            a = C.remote()
            print('actor', [ray_tpu_torch.get(a.inc.remote(), timeout=30)
                            for _ in range(3)])
            r = ray_tpu_torch.put({'k': [1, 2]})
            print('putget', ray_tpu_torch.get(r, timeout=30))
            ready, pending = ray_tpu_torch.wait([f.remote(9)], timeout=30)
            print('wait', len(ready), len(pending))
        """)
        assert "tasks [0, 2, 4, 6]" in out
        assert "actor [1, 2, 3]" in out
        assert "putget {'k': [1, 2]}" in out
        assert "wait 1 0" in out

    def test_error_propagates_with_type(self, head):
        out = run_client_driver(head, """
            @ray_tpu_torch.remote
            def boom():
                raise KeyError('expected-key')
            try:
                ray_tpu_torch.get(boom.remote(), timeout=30)
                print('NO RAISE')
            except Exception as e:
                print('raised', type(e).__name__)
        """)
        assert "raised" in out and "NO RAISE" not in out

    def test_introspection(self, head):
        out = run_client_driver(head, """
            print('nodes', len(ray_tpu_torch.nodes()))
            print('cpu', ray_tpu_torch.cluster_resources().get('CPU'))
        """)
        assert "nodes 1" in out
        assert "cpu 4.0" in out

    def test_named_actor_across_clients(self, head):
        # detached: survives client 1's disconnect (reference: ephemeral
        # actors die with their job; only detached outlive it)
        run_client_driver(head, """
            @ray_tpu_torch.remote
            class Registry:
                def __init__(self):
                    self.v = 'from-client-1'
                def value(self):
                    return self.v
            Registry.options(name='shared-reg',
                             lifetime='detached').remote()
        """)
        out = run_client_driver(head, """
            h = ray_tpu_torch.get_actor('shared-reg')
            print('got', ray_tpu_torch.get(h.value.remote(), timeout=30))
        """)
        assert "got from-client-1" in out


class TestJobs:
    def test_job_lifecycle(self, head, tmp_path):
        script = tmp_path / "job.py"
        script.write_text(
            "import os, ray_tpu_torch\n"
            "ray_tpu_torch.init(address='auto')\n"
            "f = ray_tpu_torch.remote(lambda: os.environ.get("
            "'RAY_TPU_JOB_ID') is not None)\n"
            "assert ray_tpu_torch.get(f.remote(), timeout=30) in (True, False)\n"
            "print('job-ok')\n"
            "ray_tpu_torch.shutdown()\n")
        job_id = head.jobs.submit(f"{sys.executable} {script}")
        st = head.jobs.wait(job_id, timeout=90)
        logs = head.jobs.logs(job_id)
        assert st["status"] == "SUCCEEDED", logs
        assert "job-ok" in logs
        assert any(j["job_id"] == job_id for j in head.jobs.list())

    def test_job_failure_and_stop(self, head, tmp_path):
        bad = head.jobs.submit(f"{sys.executable} -c 'raise SystemExit(3)'")
        st = head.jobs.wait(bad, timeout=60)
        assert st["status"] == "FAILED" and st["return_code"] == 3

        slow = head.jobs.submit(
            f"{sys.executable} -c 'import time; time.sleep(60)'")
        deadline = time.monotonic() + 10
        while head.jobs.status(slow)["status"] == "PENDING":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert head.jobs.stop(slow) is True
        st = head.jobs.wait(slow, timeout=30)
        assert st["status"] == "STOPPED"

    def test_unknown_job(self, head):
        with pytest.raises(KeyError):
            head.jobs.status("nope")


class TestCli:
    def test_start_status_job_stop(self, tmp_path):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

        def cli(*args, timeout=60.0):
            return subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch", *args],
                capture_output=True, text=True, env=env, cwd=REPO,
                timeout=timeout)

        r = cli("start", "--head", "--resources",
                '{"CPU": 2, "memory": 2}', "--num-workers", "1",
                timeout=90.0)
        assert r.returncode == 0, r.stderr
        try:
            r = cli("status")
            assert r.returncode == 0, r.stderr
            assert "nodes (1)" in r.stdout

            script = tmp_path / "cli_job.py"
            script.write_text("print('cli-job-ran')\n")
            r = cli("job", "submit", "--wait", "--",
                    sys.executable, str(script), timeout=90.0)
            assert r.returncode == 0, r.stdout + r.stderr
            assert "cli-job-ran" in r.stdout
        finally:
            r = cli("stop")
            assert r.returncode == 0, r.stderr


class TestStateListCli:
    def test_list_kinds_filters_and_formats(self, head, capsys):
        import json as _json

        import ray_tpu_torch
        from ray_tpu_torch.scripts.cli import main

        @ray_tpu_torch.remote
        class Listed:
            def ping(self):
                return "pong"

        a = Listed.options(name="list_me").remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
        try:
            assert main(["list", "actors",
                         "--address", head.address]) == 0
            out = capsys.readouterr().out
            assert "list_me" in out and "actor_id" in out

            assert main(["list", "nodes", "--format", "json",
                         "--address", head.address]) == 0
            rows = _json.loads(capsys.readouterr().out)
            assert len(rows) == 1 and rows[0]["state"] == "ALIVE"

            assert main(["list", "actors", "--filter", "name=list_me",
                         "--address", head.address]) == 0
            assert "list_me" in capsys.readouterr().out
            assert main(["list", "actors", "--filter", "name=absent",
                         "--address", head.address]) == 0
            assert "no actors" in capsys.readouterr().out

            # string-coerced filter matches typed fields (row is int)
            assert main(["list", "nodes", "--filter", "row=0",
                         "--format", "json",
                         "--address", head.address]) == 0
            import json as _json2
            assert len(_json2.loads(capsys.readouterr().out)) == 1

            assert main(["list", "tasks",
                         "--address", head.address]) == 0
            assert main(["list", "placement-groups",
                         "--address", head.address]) == 0
            capsys.readouterr()

            with pytest.raises(SystemExit):
                main(["list", "gizmos", "--address", head.address])
            with pytest.raises(SystemExit, match="key=value"):
                main(["list", "actors", "--filter", "bogus",
                      "--address", head.address])
        finally:
            ray_tpu_torch.kill(a)

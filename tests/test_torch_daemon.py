"""The port's daemon half: head daemon, client mode, jobs, CLI, node agents.

Scenario sources: ``tests/test_client_and_jobs.py`` (client mode, job
submission, the CLI) and ``tests/test_node_agent.py`` (remote execution
on worker-node agents, two agents), run against ``ray_tpu_torch`` with
the head's placement programs on the CPU (``scheduler_device="cpu"``;
for the CLI's daemon, ``RT_SCHEDULER_DEVICE=cpu``).  Then what the port
adds: only the head may hold the card, so an agent process and the
workers it spawns load no torch and see no GPU.

One head serves the whole module (``HeadNode`` starts the in-process
runtime, and one process holds one runtime); agents join and leave per
test.  The CLI's daemon runs in its own state dir under ``tmp_path``.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.common.config import Config as PortConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMOTE_RES = {"CPU": 2, "memory": 2, "remote_slot": 2}


@pytest.fixture(autouse=True, scope="module")
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


@pytest.fixture(scope="module")
def head():
    from ray_tpu_torch.runtime.head import HeadNode
    h = HeadNode(resources={"CPU": 4, "memory": 4}, num_workers=2,
                 system_config={"scheduler_device": "cpu"})
    yield h
    h.stop()


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RAY_TPU_TORCH_ADDRESS", "RT_SCHEDULER_DEVICE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _wait_nodes(n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(rt.nodes()) == n:
            return
        time.sleep(0.1)
    raise AssertionError(f"expected {n} nodes, have {len(rt.nodes())}")


def run_client_driver(head, body: str, timeout: float = 90.0):
    """Run a driver script as a subprocess attached in client mode."""
    script = ("import os, ray_tpu_torch as rt\n"
              "rt.init(address=os.environ['ADDR'])\n"
              + textwrap.dedent(body)
              + "\nrt.shutdown()\n")
    r = subprocess.run([sys.executable, "-c", script],
                       capture_output=True, text=True,
                       env=_env(ADDR=head.address), timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@rt.remote
def _pids():
    return os.getpid(), os.getppid()


class TestClientMode:
    def test_tasks_actors_objects(self, head):
        out = run_client_driver(head, """
            @rt.remote
            def f(x):
                return x * 2
            print('tasks', rt.get([f.remote(i) for i in range(4)],
                                  timeout=30))

            @rt.remote
            class C:
                def __init__(self):
                    self.n = 0
                def inc(self):
                    self.n += 1
                    return self.n
            a = C.remote()
            print('actor', [rt.get(a.inc.remote(), timeout=30)
                            for _ in range(3)])
            r = rt.put({'k': [1, 2]})
            print('putget', rt.get(r, timeout=30))
            ready, pending = rt.wait([f.remote(9)], timeout=30)
            print('wait', len(ready), len(pending))
        """)
        assert "tasks [0, 2, 4, 6]" in out
        assert "actor [1, 2, 3]" in out
        assert "putget {'k': [1, 2]}" in out
        assert "wait 1 0" in out

    def test_error_propagates_with_type(self, head):
        out = run_client_driver(head, """
            @rt.remote
            def boom():
                raise KeyError('expected-key')
            try:
                rt.get(boom.remote(), timeout=30)
                print('NO RAISE')
            except Exception as e:
                print('raised', type(e).__name__)
        """)
        assert "raised" in out and "NO RAISE" not in out

    def test_introspection(self, head):
        out = run_client_driver(head, """
            print('nodes', len(rt.nodes()))
            print('cpu', rt.cluster_resources().get('CPU'))
        """)
        assert "nodes 1" in out
        assert "cpu 4.0" in out

    def test_named_actor_across_clients(self, head):
        run_client_driver(head, """
            @rt.remote
            class Registry:
                def __init__(self):
                    self.v = 'from-client-1'
                def value(self):
                    return self.v
            Registry.options(name='shared-reg',
                             lifetime='detached').remote()
        """)
        out = run_client_driver(head, """
            h = rt.get_actor('shared-reg')
            print('got', rt.get(h.value.remote(), timeout=30))
        """)
        assert "got from-client-1" in out

    @pytest.mark.parametrize("kwargs, error, match", [
        ({"address": "auto"}, RuntimeError, "RAY_TPU_TORCH_ADDRESS"),
        ({"address": "127.0.0.1:1", "num_workers": 2}, ValueError,
         "attaches to an existing")])
    def test_init_address_checks(self, head, monkeypatch, kwargs, error,
                                 match):
        from ray_tpu_torch import api
        monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
        monkeypatch.setattr(api, "_runtime", None)  # as a fresh driver
        with pytest.raises(error, match=match):
            api.init(**kwargs)


class TestJobs:
    def test_job_lifecycle(self, head, tmp_path):
        script = tmp_path / "job.py"
        script.write_text(
            "import os, ray_tpu_torch as rt\n"
            "rt.init(address='auto')\n"
            "f = rt.remote(lambda: os.environ.get("
            "'RAY_TPU_JOB_ID') is not None)\n"
            "assert rt.get(f.remote(), timeout=30) in (True, False)\n"
            "print('job-ok', os.environ['RAY_TPU_TORCH_ADDRESS'])\n"
            "rt.shutdown()\n")
        job_id = head.jobs.submit(f"{sys.executable} {script}")
        st = head.jobs.wait(job_id, timeout=90)
        logs = head.jobs.logs(job_id)
        assert st["status"] == "SUCCEEDED", logs
        assert f"job-ok {head.address}" in logs
        assert any(j["job_id"] == job_id for j in head.jobs.list())

    def test_job_failure_and_stop(self, head):
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


class TestStateListCli:
    def test_list_kinds_filters_and_formats(self, head, capsys):
        from ray_tpu_torch.scripts.cli import main

        @rt.remote
        class Listed:
            def ping(self):
                return "pong"

        a = Listed.options(name="list_me").remote()
        assert rt.get(a.ping.remote(), timeout=60) == "pong"
        try:
            assert main(["list", "actors", "--address", head.address]) == 0
            out = capsys.readouterr().out
            assert "list_me" in out and "actor_id" in out

            assert main(["list", "nodes", "--format", "json",
                         "--address", head.address]) == 0
            rows = json.loads(capsys.readouterr().out)
            assert len(rows) == 1 and rows[0]["state"] == "ALIVE"

            assert main(["list", "actors", "--filter", "name=absent",
                         "--address", head.address]) == 0
            assert "no actors" in capsys.readouterr().out
            assert main(["status", "--address", head.address]) == 0
            assert "scheduler: device=cpu" in capsys.readouterr().out
            with pytest.raises(SystemExit, match="key=value"):
                main(["list", "actors", "--filter", "bogus",
                      "--address", head.address])
        finally:
            rt.kill(a)

    @pytest.mark.parametrize("cmd", [["lint"]])
    def test_unported_subcommands_name_their_item(self, cmd, capsys):
        from ray_tpu_torch.scripts.cli import main
        assert main(cmd) == 2
        assert "ROADMAP.md" in capsys.readouterr().err


class TestCli:
    def test_start_status_job_stop(self, tmp_path):
        env = _env(RAY_TPU_TORCH_STATE_DIR=str(tmp_path / "state"),
                   RT_SCHEDULER_DEVICE="cpu")

        def cli(*args, timeout=60.0):
            return subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch", *args],
                capture_output=True, text=True, env=env, cwd=REPO,
                timeout=timeout)

        r = cli("start", "--head", "--resources",
                '{"CPU": 2, "memory": 2}', "--num-workers", "1",
                timeout=90.0)
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "state" / "ray_current_cluster").exists()
        try:
            r = cli("status")
            assert r.returncode == 0, r.stderr
            assert "nodes (1)" in r.stdout
            assert "scheduler: device=cpu" in r.stdout

            script = tmp_path / "cli_job.py"
            script.write_text("print('cli-job-ran')\n")
            r = cli("job", "submit", "--wait", "--",
                    sys.executable, str(script), timeout=90.0)
            assert r.returncode == 0, r.stdout + r.stderr
            assert "cli-job-ran" in r.stdout
        finally:
            r = cli("stop")
            assert r.returncode == 0, r.stderr

    # in their own processes: a campaign installs the port's virtual
    # clock process-wide, which the module's head must never see
    @pytest.mark.parametrize("args,key", [
        (["simulate", "--nodes", "16", "--faults", "4",
          "--verify-replay"], "replay_matches"),
        (["hunt", "--budget", "1"], "coverage_keys"),
    ], ids=["simulate", "hunt"])
    def test_simulator_subcommands_run(self, args, key):
        r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                           capture_output=True, text=True, env=_env(),
                           cwd=REPO, timeout=120.0)
        assert r.returncode == 0, r.stderr
        out = json.loads(r.stdout)
        assert out[key]
        if args[0] == "simulate":
            assert out["ok"] and out["trace_hash"] == out["replay_hash"]
        else:
            assert out["runs"] == 1 and out["findings"] == []


@pytest.fixture
def agent(head):
    from ray_tpu_torch.runtime.node_agent import NodeAgent
    a = NodeAgent(head.address, resources=REMOTE_RES, num_workers=2,
                  labels={"zone": "remote"})
    _wait_nodes(2)
    try:
        yield a
    finally:
        a.stop()
        _wait_nodes(1)


class TestRemoteExecution:
    def test_tasks_run_in_agent_workers(self, head, agent):
        f = _pids.options(resources={"CPU": 1, "remote_slot": 1})
        pids = rt.get([f.remote() for _ in range(4)], timeout=60)
        me = os.getpid()
        for wpid, wppid in pids:
            assert wpid != me
            assert wppid == me      # in-process agent spawned them

    def test_head_and_remote_mix(self, head, agent):
        @rt.remote
        def double(x):
            return 2 * x

        refs = [double.options(
            resources={"CPU": 1, "remote_slot": 1} if i % 2
            else {"CPU": 1}).remote(i) for i in range(8)]
        assert rt.get(refs, timeout=60) == [2 * i for i in range(8)]

    def test_large_objects_cross_the_boundary(self, head, agent):
        ref = rt.put(os.urandom(300_000))

        @rt.remote(resources={"CPU": 1, "remote_slot": 1})
        def length(b):
            return len(b)

        assert rt.get(length.remote(ref), timeout=60) == 300_000

        @rt.remote(resources={"CPU": 1, "remote_slot": 1})
        def produce(n):
            return b"\x07" * n

        out = rt.get(produce.remote(400_000), timeout=60)
        assert len(out) == 400_000 and out[:2] == b"\x07\x07"

    def test_actor_on_remote_node(self, head, agent):
        @rt.remote(resources={"remote_slot": 1})
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

            def where(self):
                return os.getpid()

        c = Counter.remote()
        assert rt.get([c.incr.remote() for _ in range(3)],
                      timeout=60) == [1, 2, 3]
        assert rt.get(c.where.remote(), timeout=60) != os.getpid()
        rt.kill(c)

    def test_node_labels_from_agent(self, head, agent):
        rows = {n["NodeID"]: n for n in rt.nodes()}
        assert any(n["Labels"] == {"zone": "remote"}
                   for n in rows.values())
        assert agent.node_id_hex in rows


class TestMultiAgentTopology:
    def test_two_agents_and_strict_spread_pg(self, head):
        """Two worker machines join; a STRICT_SPREAD placement group
        lands one bundle per node and pinned tasks run in the right
        agent's workers."""
        from ray_tpu_torch.runtime.node_agent import NodeAgent
        from ray_tpu_torch.util.placement_group import (
            placement_group, placement_group_table, remove_placement_group)
        a1 = NodeAgent(head.address, resources={"CPU": 2, "memory": 2},
                       num_workers=1)
        a2 = NodeAgent(head.address, resources={"CPU": 2, "memory": 2},
                       num_workers=1)
        _wait_nodes(3)
        try:
            pg = placement_group([{"CPU": 1}, {"CPU": 1}, {"CPU": 1}],
                                 strategy="STRICT_SPREAD")
            assert pg.wait(timeout_seconds=60)

            @rt.remote(num_cpus=1)
            def who():
                return os.getpid()

            pids = rt.get(
                [who.options(placement_group=pg,
                             placement_group_bundle_index=i).remote()
                 for i in range(3)], timeout=90)
            assert len(set(pids)) == 3, pids
            entry = placement_group_table()[pg.id.hex()]
            assert len(set(entry["node_rows"])) == 3, entry
            remove_placement_group(pg)
        finally:
            a1.stop()
            a2.stop()
            _wait_nodes(1)


def _maps(pid) -> str:
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


class TestCliAgentWithoutCuda:
    def test_cli_agent_and_its_workers_hold_no_cuda(self, head):
        """The agent's CLI process and its workers run tasks, and neither
        loads torch (so neither can open a CUDA context) nor sees a GPU;
        SIGKILL of the agent is node death to the head."""
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "agent",
             "--address", head.address,
             "--resources", json.dumps(REMOTE_RES), "--num-workers", "1"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env())
        try:
            _wait_nodes(2, timeout=90)

            @rt.remote(resources={"CPU": 1, "remote_slot": 1})
            def where():
                import sys as _sys
                return (os.getpid(), os.getppid(),
                        os.environ.get("CUDA_VISIBLE_DEVICES"),
                        "torch" in _sys.modules)

            pid, ppid, visible, has_torch = rt.get(where.remote(),
                                                   timeout=90)
            assert ppid == proc.pid         # the agent's worker
            assert visible == "" and not has_torch
            for pid in (proc.pid, pid):
                maps = _maps(pid)
                assert "libtorch" not in maps and "libcuda" not in maps
            os.kill(proc.pid, signal.SIGKILL)
            _wait_nodes(1, timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)

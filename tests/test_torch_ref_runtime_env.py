"""Runtime environments: env_vars, working_dir, py_modules, pip gating.

Scenario sources: upstream runtime_env behavior — per-task/actor envs,
job-level inheritance with env_vars merge, staging-failure surfaces
RuntimeEnvSetupError on the task result, env workers are cached
(SURVEY.md §1 layer 10; scenarios re-derived, not copied)."""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime.runtime_env import (RuntimeEnvManager,
                                         RuntimeEnvSetupError, env_key)
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_runtime_env.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


class TestManager:
    def test_env_key_canonical(self):
        a = env_key({"env_vars": {"A": "1", "B": "2"}})
        b = env_key({"env_vars": {"B": "2", "A": "1"}})
        assert a == b
        assert env_key(None) is None
        assert env_key({}) is None
        assert a != env_key({"env_vars": {"A": "1"}})

    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError, match="unsupported"):
            env_key({"container": {"image": "x"}})

    def test_pip_gating(self, tmp_path):
        mgr = RuntimeEnvManager(str(tmp_path))
        # numpy is baked in: validation-only provisioning passes
        assert mgr.stage({"pip": ["numpy"]}) is not None
        with pytest.raises(RuntimeEnvSetupError, match="no package egress"):
            mgr.stage({"pip": ["definitely-not-installed-xyz"]})
        # failures are cached (fail fast on resubmission)
        with pytest.raises(RuntimeEnvSetupError):
            mgr.stage({"pip": ["definitely-not-installed-xyz"]})

    def test_pip_dist_name_differs_from_import_name(self, tmp_path):
        # pip requirements name DISTRIBUTIONS; import names can differ
        # (scikit-learn/sklearn, pyyaml/yaml) — validation must check
        # the distribution namespace, not just find_spec
        mgr = RuntimeEnvManager(str(tmp_path))
        assert mgr.stage({"pip": ["scikit-learn", "pyyaml>=5.0"]}) \
            is not None

    def test_concurrent_stage_single_copy(self, tmp_path):
        import threading
        src = tmp_path / "app"
        src.mkdir()
        (src / "data.txt").write_text("x" * 1000)
        mgr = RuntimeEnvManager(str(tmp_path / "session"))
        outs, errs = [], []

        def work():
            try:
                outs.append(mgr.stage({"working_dir": str(src)}))
            except Exception as e:      # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert len(outs) == 8 and all(o is outs[0] for o in outs)
        assert mgr.stats()["num_staged"] == 1   # one copytree, 8 callers

    def test_working_dir_staged_copy(self, tmp_path):
        src = tmp_path / "app"
        src.mkdir()
        (src / "data.txt").write_text("payload")
        mgr = RuntimeEnvManager(str(tmp_path / "session"))
        p = mgr.stage({"working_dir": str(src)})
        assert p["working_dir"] != str(src)
        assert open(os.path.join(p["working_dir"], "data.txt")).read() \
            == "payload"
        # cache: same env stages once
        assert mgr.stage({"working_dir": str(src)}) is p
        assert mgr.stats()["num_staged"] == 1


class TestEndToEnd:
    @pytest.fixture
    def driver(self):
        ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2)
        yield
        ray_tpu_torch.shutdown()

    def test_env_vars_reach_the_task(self, driver):
        @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_FLAG": "on-42"}})
        def read_flag():
            return os.environ.get("MY_FLAG")

        assert ray_tpu_torch.get(read_flag.remote(), timeout=60) == "on-42"

    def test_default_workers_unpolluted(self, driver):
        @ray_tpu_torch.remote(runtime_env={"env_vars": {"POLLUTE": "yes"}})
        def set_it():
            return os.environ.get("POLLUTE")

        @ray_tpu_torch.remote
        def plain():
            return os.environ.get("POLLUTE")

        assert ray_tpu_torch.get(set_it.remote(), timeout=60) == "yes"
        assert ray_tpu_torch.get(plain.remote(), timeout=60) is None

    def test_working_dir_and_module_import(self, driver, tmp_path):
        app = tmp_path / "app"
        app.mkdir()
        (app / "helper_mod_xyz.py").write_text(
            "VALUE = 'imported-from-working-dir'\n")
        (app / "cfg.txt").write_text("cfg-contents")

        @ray_tpu_torch.remote(runtime_env={"working_dir": str(app)})
        def use_env():
            import helper_mod_xyz
            return helper_mod_xyz.VALUE, open("cfg.txt").read()

        val, cfg = ray_tpu_torch.get(use_env.remote(), timeout=60)
        assert val == "imported-from-working-dir"
        assert cfg == "cfg-contents"

    def test_staging_failure_seals_task_error(self, driver):
        @ray_tpu_torch.remote(runtime_env={"pip": ["definitely-not-real-pkg"]})
        def never_runs():
            return 1

        with pytest.raises(RuntimeEnvSetupError):
            ray_tpu_torch.get(never_runs.remote(), timeout=60)

    def test_env_worker_is_cached(self, driver):
        @ray_tpu_torch.remote(runtime_env={"env_vars": {"C": "1"}})
        def pid():
            return os.getpid()

        pids = {ray_tpu_torch.get(pid.remote(), timeout=60) for _ in range(4)}
        assert len(pids) == 1       # one staged worker served all calls

    def test_concurrent_same_env_tasks_get_own_workers(self, driver):
        # regression: a one-worker-per-env cache deadlocks when tasks
        # sharing an env block on each other (e.g. a barrier/collective
        # under a job-level runtime_env) — the cache must grow with
        # concurrent demand, bounded by CPU admission
        import threading

        @ray_tpu_torch.remote(num_cpus=1, runtime_env={"env_vars": {"G": "1"}})
        def rendezvous(rank):
            # both tasks must be IN FLIGHT at once to rendezvous through
            # the KV store; a single shared env worker would serialize
            # them and time out
            from ray_tpu_torch.experimental import internal_kv as kv
            import time
            kv._internal_kv_put(f"arrived-{rank}".encode(), b"1",
                                namespace="rdv")
            deadline = time.monotonic() + 30
            other = f"arrived-{1 - rank}".encode()
            while not kv._internal_kv_exists(other, namespace="rdv"):
                if time.monotonic() > deadline:
                    raise TimeoutError("peer never arrived")
                time.sleep(0.005)
            return os.getpid()

        pids = ray_tpu_torch.get([rendezvous.remote(0), rendezvous.remote(1)],
                           timeout=60)
        assert len(set(pids)) == 2

    def test_child_inherits_parent_task_env(self, driver):
        @ray_tpu_torch.remote(runtime_env={"env_vars": {"PMODE": "p1"}})
        def parent():
            @ray_tpu_torch.remote
            def child():
                return os.environ.get("PMODE")
            return ray_tpu_torch.get(child.remote(), timeout=30)

        assert ray_tpu_torch.get(parent.remote(), timeout=60) == "p1"

    def test_child_inherits_actor_env(self, driver):
        @ray_tpu_torch.remote
        class Spawner:
            def spawn(self):
                @ray_tpu_torch.remote
                def child():
                    return os.environ.get("AMODE")
                return ray_tpu_torch.get(child.remote(), timeout=30)

        a = Spawner.options(
            runtime_env={"env_vars": {"AMODE": "a1"}}).remote()
        assert ray_tpu_torch.get(a.spawn.remote(), timeout=60) == "a1"

    def test_worker_created_actor_inherits_parent_env(self, driver):
        @ray_tpu_torch.remote(runtime_env={"env_vars": {"WMODE": "w1"}})
        def creator():
            @ray_tpu_torch.remote
            class Inner:
                def mode(self):
                    return os.environ.get("WMODE")
            a = Inner.remote()
            return ray_tpu_torch.get(a.mode.remote(), timeout=30)

        assert ray_tpu_torch.get(creator.remote(), timeout=60) == "w1"

    def test_env_tasks_do_not_starve_default_tasks(self, driver):
        # 8+ same-env tasks parked at a rendezvous must not eat the
        # dispatch scan's miss budget: a plain task queued behind them
        # has to dispatch onto an idle default worker promptly
        import time

        @ray_tpu_torch.remote(num_cpus=0,
                        runtime_env={"env_vars": {"BLK": "1"}})
        def parked(rank, world):
            from ray_tpu_torch.experimental import internal_kv as kv
            import time as t
            kv._internal_kv_put(f"pk-{rank}".encode(), b"1",
                                namespace="starve")
            deadline = t.monotonic() + 60
            while len(kv._internal_kv_list(b"pk-",
                                           namespace="starve")) < world:
                if t.monotonic() > deadline:
                    raise TimeoutError("peers missing")
                t.sleep(0.005)
            return rank

        @ray_tpu_torch.remote(num_cpus=0)
        def plain():
            return "ran"

        world = 9
        refs = [parked.remote(r, world) for r in range(world)]
        t0 = time.monotonic()
        assert ray_tpu_torch.get(plain.remote(), timeout=60) == "ran"
        took = time.monotonic() - t0
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(world))
        # the plain task must not have waited for the env cache to grow
        # worker-by-worker behind the whole parked block
        assert took < 10.0

    def test_non_json_env_fails_cleanly(self, driver):
        # a non-JSON value must fail the task (not wedge it) and must
        # not leak the node's resource reservation
        @ray_tpu_torch.remote(runtime_env={"env_vars": {"A": {1, 2}}})
        def bad():
            return 1

        with pytest.raises(RuntimeEnvSetupError):
            ray_tpu_torch.get(bad.remote(), timeout=60)

        @ray_tpu_torch.remote
        def plain():
            return "still-scheduling"

        assert ray_tpu_torch.get(plain.remote(), timeout=60) == \
            "still-scheduling"

    def test_actor_runtime_env(self, driver):
        @ray_tpu_torch.remote
        class EnvActor:
            def flag(self):
                return os.environ.get("ACTOR_FLAG")

        a = EnvActor.options(
            runtime_env={"env_vars": {"ACTOR_FLAG": "actor-on"}}).remote()
        assert ray_tpu_torch.get(a.flag.remote(), timeout=60) == "actor-on"

    def test_job_level_env_merges(self):
        ray_tpu_torch.init(resources={"CPU": 2, "memory": 2}, num_workers=1,
                     runtime_env={"env_vars": {"JOB": "j1", "BOTH": "job"}})
        try:
            @ray_tpu_torch.remote(runtime_env={"env_vars": {"BOTH": "task"}})
            def read():
                return os.environ.get("JOB"), os.environ.get("BOTH")

            assert ray_tpu_torch.get(read.remote(), timeout=60) == ("j1", "task")

            @ray_tpu_torch.remote
            def job_only():
                return os.environ.get("JOB")

            assert ray_tpu_torch.get(job_only.remote(), timeout=60) == "j1"

            # actors inherit the job env too (reference inheritance)
            @ray_tpu_torch.remote
            class A:
                def job(self):
                    return os.environ.get("JOB")

            a = A.remote()
            assert ray_tpu_torch.get(a.job.remote(), timeout=60) == "j1"

            # ...and so do tasks submitted from INSIDE a worker
            @ray_tpu_torch.remote
            def parent():
                @ray_tpu_torch.remote
                def child():
                    return os.environ.get("JOB")
                return ray_tpu_torch.get(child.remote(), timeout=30)

            assert ray_tpu_torch.get(parent.remote(), timeout=60) == "j1"
        finally:
            ray_tpu_torch.shutdown()

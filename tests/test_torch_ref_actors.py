"""Actor runtime: lifecycle, ordering, restarts, named actors.

Scenario sources: upstream ``python/ray/tests/test_actor*.py`` behavioral
contract (SURVEY.md §3.4 / §4; scenarios re-derived, not copied)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime.serialization import ActorDiedError
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_actors.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


@pytest.fixture(scope="module")
def rt():
    ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=4)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def value(self):
        return self.n

    def boom(self):
        raise RuntimeError("actor boom")

    def crash(self):
        import os
        os._exit(1)


class TestActors:
    def test_create_and_call(self, rt):
        c = Counter.remote()
        assert ray_tpu_torch.get(c.incr.remote()) == 1
        assert ray_tpu_torch.get(c.incr.remote(5)) == 6

    def test_ctor_args(self, rt):
        c = Counter.remote(100)
        assert ray_tpu_torch.get(c.value.remote()) == 100

    def test_state_isolated_between_actors(self, rt):
        a, b = Counter.remote(), Counter.remote()
        ray_tpu_torch.get(a.incr.remote())
        assert ray_tpu_torch.get(b.value.remote()) == 0

    def test_ordering_is_fifo(self, rt):
        c = Counter.remote()
        refs = [c.incr.remote() for _ in range(50)]
        assert ray_tpu_torch.get(refs) == list(range(1, 51))

    def test_method_error_propagates(self, rt):
        c = Counter.remote()
        with pytest.raises(RuntimeError, match="actor boom"):
            ray_tpu_torch.get(c.boom.remote())
        # actor survives a method exception
        assert ray_tpu_torch.get(c.incr.remote()) == 1

    def test_ref_args_to_actor(self, rt):
        c = Counter.remote()
        ref = ray_tpu_torch.put(7)
        assert ray_tpu_torch.get(c.incr.remote(ref)) == 7

    def test_actor_death_fails_calls(self, rt):
        c = Counter.remote()
        ray_tpu_torch.get(c.incr.remote())
        with pytest.raises((ActorDiedError, Exception)):
            ray_tpu_torch.get(c.crash.remote(), timeout=20)
        with pytest.raises(Exception):
            ray_tpu_torch.get(c.incr.remote(), timeout=20)

    def test_restart_recreates_state(self, rt):
        c = Counter.options(max_restarts=1).remote(10)
        assert ray_tpu_torch.get(c.incr.remote()) == 11
        try:
            ray_tpu_torch.get(c.crash.remote(), timeout=20)
        except Exception:
            pass
        # restarted incarnation reruns the ctor: state resets to 10
        deadline = time.time() + 20
        while True:
            try:
                v = ray_tpu_torch.get(c.value.remote(), timeout=20)
                break
            except Exception:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        assert v == 10

    def test_kill(self, rt):
        c = Counter.remote()
        ray_tpu_torch.get(c.incr.remote())
        ray_tpu_torch.kill(c)
        with pytest.raises(Exception):
            ray_tpu_torch.get(c.incr.remote(), timeout=20)

    def test_named_actor(self, rt):
        Counter.options(name="global_counter").remote(5)
        h = ray_tpu_torch.get_actor("global_counter")
        assert ray_tpu_torch.get(h.value.remote()) == 5
        with pytest.raises(ValueError):
            ray_tpu_torch.get_actor("no_such_actor")

    def test_handle_passed_to_task(self, rt):
        c = Counter.remote()

        @ray_tpu_torch.remote
        def bump(handle, k):
            return ray_tpu_torch.get(handle.incr.remote(k))

        assert ray_tpu_torch.get(bump.remote(c, 3)) == 3
        assert ray_tpu_torch.get(c.value.remote()) == 3

    def test_actor_created_inside_task(self, rt):
        @ray_tpu_torch.remote
        def make_and_use():
            c = Counter.remote(2)
            return ray_tpu_torch.get(c.incr.remote(2))

        assert ray_tpu_torch.get(make_and_use.remote()) == 4

    def test_terminate_graceful(self, rt):
        c = Counter.remote()
        ray_tpu_torch.get(c.incr.remote())
        ref = c.__ray_terminate__()
        assert ray_tpu_torch.get(ref, timeout=20) is None

    def test_pipelined_calls_survive_blocking_get(self, rt):
        # regression: a pipelined actor_call arriving while the worker
        # waits inside ray_tpu_torch.get must be deferred, not swallowed
        @ray_tpu_torch.remote
        class Waiter:
            def wait_for(self, refs):
                # nested ref: NOT resolved before dispatch, so the worker
                # itself blocks in get while r2 pipelines behind it
                return ray_tpu_torch.get(refs[0]) + 1

            def fast(self):
                return "fast"

        @ray_tpu_torch.remote
        def slow_value():
            time.sleep(1.0)
            return 10

        w = Waiter.remote()
        r1 = w.wait_for.remote([slow_value.remote()])
        r2 = w.fast.remote()            # pipelined behind the blocking call
        assert ray_tpu_torch.get(r1, timeout=30) == 11
        assert ray_tpu_torch.get(r2, timeout=30) == "fast"

    def test_worker_side_get_timeout(self, rt):
        from ray_tpu_torch.runtime.object_store import GetTimeoutError

        @ray_tpu_torch.remote
        def never_done():
            time.sleep(60)

        @ray_tpu_torch.remote
        def try_get(refs):
            try:
                ray_tpu_torch.get(refs[0], timeout=0.3)
                return "no-timeout"
            except GetTimeoutError:
                return "timeout"

        assert ray_tpu_torch.get(try_get.remote([never_done.remote()]),
                           timeout=30) == "timeout"

    def test_dep_from_actor_result_unblocks_task(self, rt):
        # regression: task dep produced by an ACTOR result must wake the
        # raylet scheduling loop
        c = Counter.remote()
        ref = c.incr.remote(5)

        @ray_tpu_torch.remote
        def plus_one(x):
            return x + 1

        assert ray_tpu_torch.get(plus_one.remote(ref), timeout=30) == 6

    def test_kill_pending_actor(self, rt):
        @ray_tpu_torch.remote
        def never():
            time.sleep(60)

        dep = never.remote()
        h = Counter.remote(dep)          # PENDING: dep unresolved
        ray_tpu_torch.kill(h)
        with pytest.raises(Exception):
            ray_tpu_torch.get(h.value.remote(), timeout=20)

    def test_ctor_error_fails_methods(self, rt):
        @ray_tpu_torch.remote
        class Bad:
            def __init__(self):
                raise ValueError("bad ctor")

            def m(self):
                return 1

        b = Bad.remote()
        with pytest.raises(Exception):
            ray_tpu_torch.get(b.m.remote(), timeout=20)

    def test_kill_during_ctor_not_resurrected(self, rt):
        """kill() while the constructor is running must not be undone by
        the actor_ready frame when the ctor finishes."""
        @ray_tpu_torch.remote
        class SlowCtor:
            def __init__(self):
                time.sleep(1.0)

            def ping(self):
                return "pong"

        h = SlowCtor.remote()
        time.sleep(0.3)                  # ctor is running on its worker
        ray_tpu_torch.kill(h)
        time.sleep(1.5)                  # let actor_ready arrive post-kill
        from ray_tpu_torch import api
        state = api._get_runtime().actor_manager.state_of(h._actor_id)
        assert state is not None and state.name == "DEAD"
        with pytest.raises(Exception):
            ray_tpu_torch.get(h.ping.remote(), timeout=20)

    def test_ctor_failure_returns_resources_and_reaps_worker(self, rt):
        """A failing constructor must return the actor's reserved
        resources and kill the dedicated worker (repeated failures must
        not exhaust the node or leak processes)."""
        from ray_tpu_torch import api
        crm = api._get_runtime().crm
        before = crm.snapshot().avail.sum()

        @ray_tpu_torch.remote
        class Boom:
            def __init__(self):
                raise ValueError("ctor boom")

            def m(self):
                return 1

        handles = [Boom.options(resources={"CPU": 1}).remote()
                   for _ in range(3)]
        for h in handles:
            with pytest.raises(Exception):
                ray_tpu_torch.get(h.m.remote(), timeout=20)
        # leak = avail permanently BELOW the starting level; other tests'
        # tasks finishing concurrently can only raise it
        deadline = time.time() + 10
        while time.time() < deadline:
            if crm.snapshot().avail.sum() >= before:
                break
            time.sleep(0.1)
        assert crm.snapshot().avail.sum() >= before

"""Namespaces + detached-actor lifetime.

Scenario sources: upstream's ``ray.init(namespace=...)`` scoping of
named actors, ``lifetime="detached"`` actors outliving their creating
job, and the GCS destroying a job's ephemeral actors at job exit
(``python/ray/actor.py`` options + ``GcsActorManager`` detached
handling — SURVEY.md §3.4; re-derived, not copied).  Documented
divergence: the default namespace is the shared "" (not an anonymous
per-job one); explicit namespaces give the isolation.
"""

import textwrap
import time

import pytest

import ray_tpu_torch
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_namespaces.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


@pytest.fixture
def driver():
    from ray_tpu_torch.api import _get_runtime
    ray_tpu_torch.init(resources={"CPU": 4}, num_workers=2, namespace="testns")
    try:
        yield _get_runtime()
    finally:
        ray_tpu_torch.shutdown()


class TestNamespaces:
    def test_names_scoped_to_namespace(self, driver):
        @ray_tpu_torch.remote
        class A:
            def who(self):
                return "in-testns"

        A.options(name="scoped").remote()
        # visible in the caller's namespace (driver default "testns")
        h = ray_tpu_torch.get_actor("scoped")
        assert ray_tpu_torch.get(h.who.remote(), timeout=30) == "in-testns"
        # explicit same-namespace lookup works too
        h2 = ray_tpu_torch.get_actor("scoped", namespace="testns")
        assert h2._actor_id == h._actor_id
        # invisible from another namespace
        with pytest.raises(ValueError, match="no actor named"):
            ray_tpu_torch.get_actor("scoped", namespace="otherns")

    def test_worker_inherits_job_namespace(self, driver):
        """Tasks resolve and register names in the JOB's namespace —
        a worker has no namespace of its own."""
        @ray_tpu_torch.remote
        class A:
            def who(self):
                return "driver-made"

        A.options(name="jobscoped").remote()

        @ray_tpu_torch.remote
        def lookup_from_worker():
            h = ray_tpu_torch.get_actor("jobscoped")
            return ray_tpu_torch.get(h.who.remote(), timeout=30)

        assert ray_tpu_torch.get(lookup_from_worker.remote(),
                           timeout=60) == "driver-made"

        @ray_tpu_torch.remote
        def create_from_worker():
            @ray_tpu_torch.remote
            class B:
                def who(self):
                    return "worker-made"
            B.options(name="workermade").remote()
            return "ok"

        assert ray_tpu_torch.get(create_from_worker.remote(),
                           timeout=60) == "ok"
        # registered under the job's namespace: driver-side lookup hits
        h = ray_tpu_torch.get_actor("workermade")
        assert ray_tpu_torch.get(h.who.remote(), timeout=60) == "worker-made"

    def test_same_name_in_two_namespaces(self, driver):
        @ray_tpu_torch.remote
        class B:
            def __init__(self, tag):
                self.tag = tag

            def tagv(self):
                return self.tag

        B.options(name="dup", namespace="ns1").remote("one")
        B.options(name="dup", namespace="ns2").remote("two")
        h1 = ray_tpu_torch.get_actor("dup", namespace="ns1")
        h2 = ray_tpu_torch.get_actor("dup", namespace="ns2")
        assert ray_tpu_torch.get(h1.tagv.remote(), timeout=30) == "one"
        assert ray_tpu_torch.get(h2.tagv.remote(), timeout=30) == "two"

    def test_name_collision_within_namespace(self, driver):
        @ray_tpu_torch.remote
        class C:
            pass

        C.options(name="taken").remote()
        with pytest.raises(ValueError, match="already taken"):
            C.options(name="taken").remote()


class TestDetachedLifetime:
    def test_detached_requires_name(self, driver):
        @ray_tpu_torch.remote
        class D:
            pass

        with pytest.raises(ValueError, match="must be named"):
            D.options(lifetime="detached").remote()

    def test_client_disconnect_kills_ephemeral_keeps_detached(self):
        """The done-criterion: a client's ephemeral actors die with its
        connection; its detached actor survives and stays reachable."""
        import os
        import subprocess
        import sys

        from ray_tpu_torch.runtime.head import HeadNode
        from ray_tpu_torch.runtime.serialization import ActorDiedError

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        head = HeadNode(resources={"CPU": 4}, num_workers=2)
        rt = head._rt
        try:
            script = textwrap.dedent("""
                import os, sys
                import ray_tpu_torch
                ray_tpu_torch.init(address=sys.argv[1])

                @ray_tpu_torch.remote
                class Svc:
                    def ping(self):
                        return "pong"

                Svc.options(name="eph").remote()
                Svc.options(name="det", lifetime="detached").remote()
                h = ray_tpu_torch.get_actor("eph")
                assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
                print("CLIENT_READY", flush=True)
                sys.stdin.readline()
                os._exit(0)         # abrupt disconnect
            """)
            proc = subprocess.Popen(
                [sys.executable, "-c", script, head.address],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True, env={**os.environ, "PYTHONPATH": repo})
            assert proc.stdout.readline().strip() == "CLIENT_READY"
            am = rt.actor_manager
            assert am.get_by_name("eph") is not None
            assert am.get_by_name("det") is not None
            proc.stdin.write("\n")
            proc.stdin.flush()
            proc.wait(timeout=30)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                from ray_tpu_torch.runtime.actor_manager import ActorState
                eph = am.get_by_name("eph")
                if eph is None or am.state_of(eph) is ActorState.DEAD:
                    break
                time.sleep(0.2)
            eph = am.get_by_name("eph")
            from ray_tpu_torch.runtime.actor_manager import ActorState
            assert eph is None or am.state_of(eph) is ActorState.DEAD
            # detached survives AND serves
            det = am.get_by_name("det")
            assert det is not None
            assert am.state_of(det) is not ActorState.DEAD
            h = ray_tpu_torch.get_actor("det")
            assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
        finally:
            head.stop()


class TestRuntimeContextAndNamedListing:
    def test_runtime_context_identities(self, driver):
        ctx = ray_tpu_torch.get_runtime_context()
        assert ctx.get_job_id() and ctx.get_node_id()
        assert ctx.get_task_id() is None    # driver, not a task

        @ray_tpu_torch.remote
        def who():
            c = ray_tpu_torch.get_runtime_context()
            return (c.get_task_id(), c.get_job_id(), c.get_node_id(),
                    c.get_actor_id())

        tid, jid, nid, aid = ray_tpu_torch.get(who.remote(), timeout=60)
        assert tid and jid and nid
        assert aid is None                  # plain task, not an actor
        assert nid == ctx.get_node_id()     # same (head) node

        @ray_tpu_torch.remote
        class Who:
            def who(self):
                c = ray_tpu_torch.get_runtime_context()
                return c.get_actor_id(), c.get_node_id()

        a = Who.remote()
        aid2, nid2 = ray_tpu_torch.get(a.who.remote(), timeout=60)
        assert aid2 and nid2
        assert aid2 == a._actor_id.hex()
        ray_tpu_torch.kill(a)

    def test_list_named_actors(self, driver):
        @ray_tpu_torch.remote
        class N:
            def ping(self):
                return "ok"

        a = N.options(name="listed-a").remote()
        b = N.options(name="listed-b", namespace="other").remote()
        ray_tpu_torch.get([a.ping.remote(), b.ping.remote()], timeout=60)
        names = {r["name"] for r in ray_tpu_torch.list_named_actors()}
        assert "listed-a" in names and "listed-b" not in names
        every = {(r["namespace"], r["name"])
                 for r in ray_tpu_torch.list_named_actors(
                     all_namespaces=True)}
        # the module driver inits with namespace="testns"
        assert ("testns", "listed-a") in every and \
            ("other", "listed-b") in every
        ray_tpu_torch.kill(a)
        ray_tpu_torch.kill(b)

    def test_worker_namespace_and_listing(self, driver):
        @ray_tpu_torch.remote
        class Named:
            def ping(self):
                return "ok"

        n = Named.options(name="ctx-listed").remote()
        ray_tpu_torch.get(n.ping.remote(), timeout=60)

        @ray_tpu_torch.remote
        def inside():
            c = ray_tpu_torch.get_runtime_context()
            rows = ray_tpu_torch.list_named_actors()
            return c.namespace, {r["name"] for r in rows}

        ns, names = ray_tpu_torch.get(inside.remote(), timeout=60)
        assert ns == "testns"           # the module driver's namespace
        assert "ctx-listed" in names    # listed from INSIDE a worker
        ray_tpu_torch.kill(n)


class TestGetIfExists:
    def test_get_or_create(self, driver):
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        a = Counter.options(name="goc", get_if_exists=True).remote()
        assert ray_tpu_torch.get(a.inc.remote(), timeout=60) == 1
        # second call REUSES: same instance state, no collision error
        b = Counter.options(name="goc", get_if_exists=True).remote()
        assert b._actor_id == a._actor_id
        assert ray_tpu_torch.get(b.inc.remote(), timeout=60) == 2
        ray_tpu_torch.kill(a)

    def test_requires_name(self, driver):
        @ray_tpu_torch.remote
        class X:
            pass

        with pytest.raises(ValueError, match="requires a name"):
            X.options(get_if_exists=True).remote()

"""Trace-context propagation through task trees.

Scenario sources: upstream tracing hooks (RAY_TRACING_ENABLED +
OpenTelemetry context carried in task specs, SURVEY.md §5.1) —
re-derived: spans tag (trace_id, span, parent) and nested submissions
link to their submitting task's span."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import tracing
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_tracing.py: the reference's file with
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
def traced_driver():
    ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2,
                 system_config={"tracing_enabled": True})
    yield
    ray_tpu_torch.shutdown()


def _spans_settled(trace_id, n, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        spans = tracing.get_trace(trace_id)
        if len(spans) >= n:
            return spans
        time.sleep(0.05)
    raise TimeoutError(f"only {len(tracing.get_trace(trace_id))} spans")


class TestTracing:
    def test_disabled_by_default(self):
        ray_tpu_torch.init(resources={"CPU": 2, "memory": 2}, num_workers=1)
        try:
            @ray_tpu_torch.remote
            def f():
                return 1

            ref = f.remote()
            assert ray_tpu_torch.get(ref, timeout=30) == 1
            # no trace ids anywhere in the timeline
            events = ray_tpu_torch.timeline()
            assert not any((e.get("args") or {}).get("trace_id")
                           for e in events)
        finally:
            ray_tpu_torch.shutdown()

    def test_parent_child_linkage(self, traced_driver):
        @ray_tpu_torch.remote
        def child(x):
            return x + 1

        @ray_tpu_torch.remote
        def parent():
            return ray_tpu_torch.get(child.remote(41), timeout=30)

        ref = parent.remote()
        trace_id = None
        # the root span's trace id comes from the spec we just built
        assert ray_tpu_torch.get(ref, timeout=60) == 42
        events = ray_tpu_torch.timeline()
        ids = {(e.get("args") or {}).get("trace_id")
               for e in events} - {None}
        assert len(ids) == 1
        trace_id = ids.pop()
        spans = _spans_settled(trace_id, 2)
        by_name = {s["name"]: s for s in spans}
        p = next(s for s in spans if s["parent_id"] == "driver")
        c = next(s for s in spans if s["parent_id"] != "driver")
        assert c["parent_id"] == p["span_id"]
        tree = tracing.trace_tree(trace_id)
        assert len(tree["roots"]) == 1
        assert len(tree["roots"][0]["children"]) == 1
        assert by_name  # spans carry names

    def test_separate_roots_get_separate_traces(self, traced_driver):
        @ray_tpu_torch.remote
        def f():
            return 1

        ray_tpu_torch.get([f.remote(), f.remote()], timeout=30)
        events = ray_tpu_torch.timeline()
        ids = {(e.get("args") or {}).get("trace_id")
               for e in events} - {None}
        assert len(ids) >= 2        # each root submission = one trace

    def test_actor_hop_stays_linked(self, traced_driver):
        @ray_tpu_torch.remote
        def grandchild():
            return "gc"

        @ray_tpu_torch.remote
        class Hop:
            def call(self):
                return ray_tpu_torch.get(grandchild.remote(), timeout=30)

        @ray_tpu_torch.remote
        def root():
            a = Hop.remote()
            return ray_tpu_torch.get(a.call.remote(), timeout=30)

        assert ray_tpu_torch.get(root.remote(), timeout=60) == "gc"
        ids = {(e.get("args") or {}).get("trace_id")
               for e in ray_tpu_torch.timeline()} - {None}
        assert len(ids) == 1
        spans = _spans_settled(ids.pop(), 3)    # root, actor call, gc
        by_parent = {s["span_id"]: s for s in spans}
        chain = [s for s in spans if s["parent_id"] == "driver"]
        assert len(chain) == 1
        # the actor call's parent is the root task; the grandchild's
        # parent is the actor call — the hop does not break the chain
        mid = next(s for s in spans
                   if s["parent_id"] == chain[0]["span_id"])
        leaf = next(s for s in spans
                    if s["parent_id"] == mid["span_id"])
        assert by_parent[leaf["span_id"]] is leaf

    def test_span_scope_groups_submissions(self, traced_driver):
        @ray_tpu_torch.remote
        def f(i):
            return i

        with tracing.span_scope("my-trace", "my-root"):
            refs = [f.remote(i) for i in range(3)]
        assert ray_tpu_torch.get(refs, timeout=30) == [0, 1, 2]
        spans = _spans_settled("my-trace", 3)
        assert len(spans) == 3
        assert all(s["parent_id"] == "my-root" for s in spans)
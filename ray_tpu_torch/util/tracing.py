"""Trace-context propagation + trace reconstruction.

Reference parity: ``python/ray/util/tracing/`` — OpenTelemetry spans
behind ``RAY_TRACING_ENABLED``, with trace context carried inside task
specs so a request's task tree links up across workers (SURVEY.md
§5.1; mount empty).

Here the context is ``(trace_id, parent_span_id)``: the driver mints a
trace id per root submission, every task's span id is its task id, and
nested submissions inherit the executing task's span as parent.  Spans
land in the cluster timeline (``runtime/events.py``) tagged with both
ids; ``get_trace`` rebuilds the tree.
"""

from __future__ import annotations

import os
import threading

_local = threading.local()      # driver-side ambient context


def enabled() -> bool:
    """Tracing needs BOTH knobs: spans land in the event log, so with
    ``event_log_enabled`` off they could never be recorded — better a
    consistent no-op than specs stamped with contexts nobody stores."""
    from ..common.config import get_config
    cfg = get_config()
    return bool(cfg.tracing_enabled and cfg.event_log_enabled)


def current_context() -> tuple | None:
    """(trace_id, span_id) of the active scope, or None."""
    return getattr(_local, "ctx", None)


def context_for_new_task(task_id) -> tuple | None:
    """The trace_ctx for a spec being submitted from THIS scope.

    An ambient scope always propagates (workers inherit it from the
    exec frame and do NOT share the driver's config, so the flag is
    only consulted at the ROOT); with no ambient scope, a fresh trace
    starts when tracing is enabled."""
    ambient = current_context()
    if ambient is not None:
        return (ambient[0], ambient[1])
    if not enabled():
        return None
    return (os.urandom(8).hex(), "driver")


class span_scope:       # noqa: N801 — context-manager idiom
    """Make ``(trace_id, span_id)`` the ambient scope (worker exec
    loops enter this around task execution; drivers may use it to group
    submissions under one trace)."""

    def __init__(self, trace_id: str, span_id: str):
        self._ctx = (trace_id, span_id)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_local, "ctx", None)
        _local.ctx = self._ctx
        return self

    def __exit__(self, *exc):
        _local.ctx = self._prev
        return False


def get_trace(trace_id: str) -> list[dict]:
    """All spans of one trace from the driver's timeline, each with
    ``span_id``/``parent_id``, sorted by start time."""
    from ..api import _get_runtime
    rt = _get_runtime()
    if not hasattr(rt, "cluster"):
        raise RuntimeError("get_trace is driver-only")
    by_span: dict[str, dict] = {}
    for ev in rt.cluster.events.timeline():
        args = ev.get("args") or {}
        if args.get("trace_id") != trace_id:
            continue
        span = {"name": ev.get("name"),
                "start_us": ev.get("ts"),
                "duration_us": ev.get("dur"),
                "span_id": args.get("span_id"),
                "parent_id": args.get("parent_id")}
        prev = by_span.get(span["span_id"])
        # lineage reconstruction re-executes a spec under the SAME span
        # id: keep the latest attempt only, or the tree would duplicate
        # the re-executed subtree once per attempt
        if prev is None or (span["start_us"] or 0) > \
                (prev["start_us"] or 0):
            by_span[span["span_id"]] = span
    spans = sorted(by_span.values(), key=lambda s: s["start_us"] or 0)
    return spans


def trace_tree(trace_id: str) -> dict:
    """Spans nested parent->children.  Roots are spans whose parent has
    no span in this trace — the synthetic ``"driver"`` parent, custom
    ``span_scope`` roots, and orphans whose parent span is missing
    (still running, or evicted from the timeline ring) all surface
    instead of silently disappearing."""
    spans = get_trace(trace_id)
    span_ids = {s["span_id"] for s in spans}
    children: dict[str, list] = {}
    roots: list[dict] = []
    for s in spans:
        if s["parent_id"] in span_ids:
            children.setdefault(s["parent_id"], []).append(s)
        else:
            roots.append(s)

    def build(s: dict) -> dict:
        return dict(s, children=[build(c)
                                 for c in children.get(s["span_id"], ())])

    return {"trace_id": trace_id, "roots": [build(s) for s in roots]}

"""The state API: queryable live cluster state.

Reference parity: ``ray.util.state`` — ``list_tasks/list_actors/
list_objects/list_nodes/list_placement_groups`` return structured rows
sourced from GCS/raylet state, with simple equality filters and a task
summary (``python/ray/util/state/`` — SURVEY.md §1 layer 12, §2.2;
mount empty).  Driver-only, like the reference's default source (the
head's state aggregator).
"""

from __future__ import annotations

from collections import Counter
from typing import Any


def _cluster():
    from ..api import _get_runtime
    rt = _get_runtime()
    if not hasattr(rt, "cluster"):
        raise RuntimeError("the state API is driver-only")
    return rt


def _apply_filters(rows: list[dict],
                   filters: list[tuple] | None) -> list[dict]:
    """``[(key, "=", value)]`` equality filters (the reference's
    predicate shape)."""
    if not filters:
        return rows
    for key, op, value in filters:
        if op not in ("=", "=="):
            raise ValueError(f"unsupported filter op {op!r}")
        # string-coerced fallback: CLI filters arrive as strings, so
        # `--filter row=0` must match the int field (the reference's
        # state CLI compares string forms the same way)
        rows = [r for r in rows
                if r.get(key) == value or str(r.get(key)) == str(value)]
    return rows


def list_nodes(filters: list[tuple] | None = None) -> list[dict]:
    from .. import api
    rows = [{"node_id": n["NodeID"],
             "state": n.get("Status", "ALIVE"),
             "row": n["Row"], "labels": n["Labels"]}
            for n in api.nodes()]
    return _apply_filters(rows, filters)


def list_actors(filters: list[tuple] | None = None) -> list[dict]:
    rt = _cluster()
    rows = [{"actor_id": r["ActorID"], "state": r["State"],
             "name": r["Name"], "pending_calls": r["Pending"],
             "inflight_calls": r["InFlight"]}
            for r in rt.actor_manager.list_actors()]
    return _apply_filters(rows, filters)


def list_tasks(filters: list[tuple] | None = None) -> list[dict]:
    rt = _cluster()
    return _apply_filters(rt.cluster.task_manager.list_rows(), filters)


def list_objects(filters: list[tuple] | None = None) -> list[dict]:
    rt = _cluster()
    store = rt.cluster.store
    directory = rt.cluster.directory
    rows = []
    for oid, size, kind in store.list_objects():
        rows.append({"object_id": oid.hex(), "size_bytes": size,
                     "kind": kind,
                     "locations": list(directory.locations(oid))})
    return _apply_filters(rows, filters)


def list_placement_groups(filters: list[tuple] | None = None) \
        -> list[dict]:
    from .placement_group import placement_group_table
    table = placement_group_table()
    rows = [dict(v, placement_group_id=k) for k, v in table.items()]
    return _apply_filters(rows, filters)


def summarize_tasks() -> dict[str, Any]:
    counts = Counter(r["state"] for r in list_tasks())
    return {"total": sum(counts.values()), "by_state": dict(counts)}


def summarize_actors() -> dict[str, Any]:
    counts = Counter(r["state"] for r in list_actors())
    return {"total": sum(counts.values()), "by_state": dict(counts)}

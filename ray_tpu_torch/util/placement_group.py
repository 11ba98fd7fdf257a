"""Public placement-group API — gang scheduling of resource bundles.

Reference parity: ``python/ray/util/placement_group.py`` —
``placement_group(bundles, strategy)`` returning a ``PlacementGroup``
handle with ``.ready()``/``.wait()``, ``remove_placement_group``,
``placement_group_table`` (SURVEY.md §3.5; mount empty).  Creation flows
to the cluster's ``PlacementGroupManager`` (the GcsPlacementGroupManager
analogue): bundle placement by the contract in
``ray_tpu_torch/scheduling/bundles.py`` (device twin ``ops/bundle_kernel.py``),
then 2-phase prepare/commit reservation surfacing shaped
``{res}_group_{i}_{pgid}`` resources that pg-strategy tasks consume.

Tasks/actors join a group via ``.options(placement_group=pg,
placement_group_bundle_index=i)``; their resource demand is rewritten onto
the shaped bundle resources (reference: tasks under a
``PlacementGroupSchedulingStrategy`` request ``CPU_group_...``).
"""

from __future__ import annotations

from ..common.ids import ObjectID, PlacementGroupID, TaskID
from ..runtime.object_ref import ObjectRef
from ..scheduling.bundles import PlacementStrategy

__all__ = ["PlacementGroup", "placement_group", "remove_placement_group",
           "placement_group_table"]


def _ready_oid(pg_id: PlacementGroupID) -> ObjectID:
    """Deterministic ready-marker object id (the manager's formula, so
    worker-created groups can await readiness without a round-trip)."""
    from ..runtime.placement_group_manager import ready_oid_for
    return ready_oid_for(pg_id)


class PlacementGroup:
    """Handle to a (possibly still-pending) placement group."""

    def __init__(self, pg_id: PlacementGroupID,
                 bundles: list[dict[str, float]] | None = None):
        self.id = pg_id
        self.bundle_specs = [dict(b) for b in (bundles or [])]

    def ready(self) -> ObjectRef:
        """ObjectRef resolved when all bundles are reserved (reference:
        ``pg.ready()`` is get-able)."""
        return ObjectRef(_ready_oid(self.id))

    def wait(self, timeout_seconds: float | None = None) -> bool:
        from .. import api
        from ..runtime.serialization import RayError
        ready, _ = api.wait([self.ready()], num_returns=1,
                            timeout=timeout_seconds)
        if not ready:
            return False
        # a group removed while pending seals its marker with an error so
        # waiters wake — that is NOT a ready group
        try:
            api.get(self.ready(), timeout=1)
        except RayError:
            return False
        return True

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()[:12]}…)"


def _check_bundles(bundles: list[dict[str, float]]) -> None:
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError(f"invalid bundle {b!r}: must be a non-empty "
                             "dict of resource -> amount")
        if any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b!r}: negative amount")


def placement_group(bundles: list[dict[str, float]],
                    strategy: str = "PACK",
                    name: str | None = None) -> PlacementGroup:
    """Reserve a gang of resource bundles atomically.

    strategy: PACK | SPREAD | STRICT_PACK | STRICT_SPREAD (reference
    semantics: STRICT_SPREAD <=1 bundle/node, STRICT_PACK all on one).
    Returns immediately; the group may still be pending — ``pg.ready()``.
    """
    from .. import api
    _check_bundles(bundles)
    try:
        strat = PlacementStrategy[strategy]
    except KeyError:
        raise ValueError(
            f"unknown placement strategy {strategy!r}; expected one of "
            f"{[s.name for s in PlacementStrategy]}") from None
    rt = api._get_runtime()
    if rt.is_driver:
        pg_id = PlacementGroupID.of(rt.job_id)
        rt.cluster.pg_manager.create(pg_id, bundles, strat, name=name)
    else:
        cur = rt.current_task_id
        from ..common.ids import JobID
        job_id = cur.job_id() if cur else JobID.from_int(0)
        pg_id = PlacementGroupID.of(job_id)
        rt.create_placement_group(pg_id, bundles, strat.name, name)
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release the group's reservations (reference:
    ``remove_placement_group``).  Shaped resources vanish; base resources
    return to their nodes."""
    from .. import api
    rt = api._get_runtime()
    if rt.is_driver:
        rt.cluster.pg_manager.remove(pg.id)
    else:
        rt.remove_placement_group(pg.id)


def placement_group_table() -> dict:
    """State of every placement group (reference: ``placement_group_table``)."""
    from .. import api
    rt = api._get_runtime()
    if not rt.is_driver:
        raise RuntimeError("placement_group_table() is driver-only")
    return rt.cluster.pg_manager.table()

"""User-facing scheduling strategy objects.

Reference parity: ``python/ray/util/scheduling_strategies.py`` —
``PlacementGroupSchedulingStrategy`` and ``NodeAffinitySchedulingStrategy``
passed as ``.options(scheduling_strategy=...)`` (plus the plain strings
"DEFAULT" / "SPREAD") — SURVEY.md §1 layer 9; mount empty.  These resolve
to the internal ``common.task_spec.SchedulingStrategy`` at submission.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..common.ids import NodeID
from ..common.task_spec import SchedulingStrategy, SchedulingStrategyKind
from .placement_group import PlacementGroup

__all__ = ["PlacementGroupSchedulingStrategy",
           "NodeAffinitySchedulingStrategy",
           "NodeLabelSchedulingStrategy", "resolve_strategy"]


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: PlacementGroup
    placement_group_bundle_index: int = -1


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: NodeID
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    """Restrict placement to nodes whose labels match ``hard`` (all pairs
    must match); ``soft=True`` falls back to any node when no labeled
    node can take the task (reference
    ``NodeLabelSchedulingStrategy(hard=..., soft=...)``)."""
    hard: dict
    soft: bool = False


def resolve_strategy(value) -> SchedulingStrategy:
    """Map a user-facing strategy (string or strategy object) to the
    internal SchedulingStrategy."""
    if value is None or value == "DEFAULT":
        return SchedulingStrategy()
    if value == "SPREAD":
        return SchedulingStrategy(kind=SchedulingStrategyKind.SPREAD)
    if isinstance(value, PlacementGroupSchedulingStrategy):
        from ..api import _check_bundle_index
        _check_bundle_index(value.placement_group,
                            value.placement_group_bundle_index)
        return SchedulingStrategy(
            kind=SchedulingStrategyKind.PLACEMENT_GROUP,
            placement_group_id=value.placement_group.id,
            bundle_index=value.placement_group_bundle_index)
    if isinstance(value, NodeAffinitySchedulingStrategy):
        return SchedulingStrategy(
            kind=SchedulingStrategyKind.NODE_AFFINITY,
            node_id=value.node_id, soft=value.soft)
    if isinstance(value, NodeLabelSchedulingStrategy):
        return SchedulingStrategy(
            kind=SchedulingStrategyKind.NODE_LABEL,
            label_selector=tuple(sorted(value.hard.items())),
            soft=value.soft)
    if isinstance(value, SchedulingStrategy):
        return value
    raise TypeError(f"unsupported scheduling_strategy {value!r}")

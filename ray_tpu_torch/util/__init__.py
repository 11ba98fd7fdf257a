"""ray_tpu_torch.util — utility namespace.

Reference parity: upstream ``ray.util`` hosts ``placement_group``, the
state API, and user metrics (``python/ray/util/`` — SURVEY.md §1 layers
9/12; mount empty).  Populated incrementally; importing the package must
always succeed because ``ray_tpu_torch.__getattr__`` resolves ``ray_tpu_torch.util``
lazily.
"""

from __future__ import annotations

from .actor_pool import ActorPool
from .placement_group import (PlacementGroup, placement_group,
                              placement_group_table,
                              remove_placement_group)
from .scheduling_strategies import (NodeAffinitySchedulingStrategy,
                                    NodeLabelSchedulingStrategy,
                                    PlacementGroupSchedulingStrategy)

__all__ = ["ActorPool", "PlacementGroup", "placement_group",
           "placement_group_table", "remove_placement_group",
           "PlacementGroupSchedulingStrategy",
           "NodeAffinitySchedulingStrategy",
           "NodeLabelSchedulingStrategy"]

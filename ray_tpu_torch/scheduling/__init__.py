from .bundles import PlacementStrategy, schedule_bundles
from .cluster_resources import ClusterResourceManager
from .contract import (AVAIL_SHIFT, INFEASIBLE_KEY, MAX_NODES, SCALE,
                       compute_keys, compute_keys_batch, threshold_fp,
                       unpack_key)
from .oracle import (ClusterState, expand_group_counts, group_requests,
                     schedule_grouped_oracle, schedule_one, schedule_tasks)
from .policy import (CompositeSchedulingPolicy, DeltaScheduler,
                     HybridSchedulingPolicy, ISchedulingPolicy,
                     NodeAffinitySchedulingPolicy, RandomSchedulingPolicy,
                     SchedulingOptions, SchedulingType,
                     SpreadSchedulingPolicy)
from .sharded_delta import make_delta_scheduler, resolve_shards

__all__ = [
    "PlacementStrategy", "schedule_bundles",
    "ClusterResourceManager", "ClusterState", "CompositeSchedulingPolicy",
    "DeltaScheduler",
    "HybridSchedulingPolicy", "ISchedulingPolicy", "INFEASIBLE_KEY",
    "MAX_NODES", "NodeAffinitySchedulingPolicy", "RandomSchedulingPolicy",
    "SCALE", "AVAIL_SHIFT", "SchedulingOptions", "SchedulingType",
    "make_delta_scheduler", "resolve_shards",
    "SpreadSchedulingPolicy", "compute_keys", "compute_keys_batch",
    "expand_group_counts",
    "group_requests", "schedule_grouped_oracle", "schedule_one",
    "schedule_tasks", "threshold_fp", "unpack_key",
]

from .config import Config, get_config
from .ids import (ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID,
                  WorkerID)
from .resources import (CU_PER_UNIT, MAX_TOTAL_CU, PREDEFINED_RESOURCES,
                        NodeResources, ResourceIndex, ResourceRequest,
                        from_cu, to_cu)
from .task_spec import (DEFAULT_STRATEGY, SchedulingStrategy,
                        SchedulingStrategyKind, TaskSpec, TaskType)

__all__ = [
    "ActorID", "JobID", "NodeID", "ObjectID", "PlacementGroupID", "TaskID",
    "WorkerID", "Config", "get_config", "NodeResources", "ResourceIndex",
    "ResourceRequest", "from_cu", "to_cu", "CU_PER_UNIT", "MAX_TOTAL_CU",
    "PREDEFINED_RESOURCES", "TaskSpec", "TaskType", "SchedulingStrategy",
    "SchedulingStrategyKind", "DEFAULT_STRATEGY",
]

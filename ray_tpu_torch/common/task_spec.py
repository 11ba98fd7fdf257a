"""Task specifications — the unit of work the scheduler places.

Reference parity: upstream Ray's ``TaskSpecification``
(``src/ray/common/task/task_spec.h``, wire form ``TaskSpec`` in
``src/ray/protobuf/common.proto``) carries function descriptor, args (inline
or ObjectRef), resource demands, scheduling strategy, retry policy, and — the
field the scheduler keys on — a *scheduling class* interning the (resource
request, strategy, function) triple so equal tasks share lease pools.
[Cited per SURVEY.md §1/§3.2; reference mount empty, line numbers unavailable.]

TPU-first: the scheduling class is load-bearing here — the device kernel
batches pending tasks *by scheduling class* (identical demand vectors are
water-fill-able as one group, see ray_tpu_torch/ops/hybrid_kernel.py), so the class
key is computed eagerly at spec construction.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any

from .ids import ActorID, JobID, NodeID, PlacementGroupID, TaskID
from .resources import ResourceRequest


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2
    DRIVER_TASK = 3


class SchedulingStrategyKind(enum.Enum):
    DEFAULT = 0            # hybrid policy
    SPREAD = 1             # round-robin over feasible nodes
    NODE_AFFINITY = 2      # pin to node (soft or hard)
    PLACEMENT_GROUP = 3    # pin to a reserved bundle
    NODE_LABEL = 4         # restrict to nodes matching a label selector


@dataclass(frozen=True)
class SchedulingStrategy:
    kind: SchedulingStrategyKind = SchedulingStrategyKind.DEFAULT
    # NODE_AFFINITY
    node_id: NodeID | None = None
    soft: bool = False
    # PLACEMENT_GROUP
    placement_group_id: PlacementGroupID | None = None
    bundle_index: int = -1
    # NODE_LABEL: sorted ((key, value), ...) pairs (tuple: frozen+hashable)
    label_selector: tuple = ()

    def key(self) -> tuple:
        return (self.kind.value,
                self.node_id.binary() if self.node_id else b"",
                self.soft,
                self.placement_group_id.binary()
                if self.placement_group_id else b"",
                self.bundle_index,
                self.label_selector)


DEFAULT_STRATEGY = SchedulingStrategy()


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function_descriptor: str          # module:qualname for normal tasks
    args: tuple = ()                  # mixed inline values / ObjectRefs
    kwargs: dict = field(default_factory=dict)
    num_returns: int = 1
    resources: ResourceRequest = field(default_factory=ResourceRequest)
    strategy: SchedulingStrategy = DEFAULT_STRATEGY
    max_retries: int = 0
    actor_id: ActorID | None = None   # set for actor creation/actor tasks
    # per-task runtime environment (env_vars/working_dir/py_modules/pip)
    runtime_env: dict | None = None
    # tracing: (trace_id, parent_span_id) propagated caller -> task
    # when ``tracing_enabled`` (reference: OpenTelemetry context in
    # task specs behind RAY_TRACING_ENABLED)
    trace_ctx: tuple | None = None
    # lineage: object deps this spec needs (resolved by DependencyManager)
    dependencies: tuple = ()
    # retry bookkeeping (mutated by TaskManager)
    attempt_number: int = 0
    # worker recycling (reference @ray.remote(max_calls=N)): the
    # executing worker retires after this many invocations of the
    # function — the pressure valve for tasks that leak native memory
    max_calls: int = 0

    def scheduling_class(self) -> tuple:
        """Interned identity for batch grouping — equal classes are
        order-equivalent inside one scheduling round."""
        return (self.resources.key(), self.strategy.key())

    def is_actor_task(self) -> bool:
        return self.task_type in (TaskType.ACTOR_TASK,
                                  TaskType.ACTOR_CREATION_TASK)

"""Host runtime: object store, worker pool, raylet, task management.

The control plane of the framework (SURVEY.md §1 layers 4/6/7/9 — raylet,
object store, core worker, Python API).  Device math lives in ray_tpu_torch/ops;
everything here is host-side orchestration around it.
"""

from .object_directory import ObjectDirectory
from .object_ref import ObjectRef
from .object_store import MemoryStore, ObjectLostError, GetTimeoutError
from .pull_manager import PullManager, PullPriority
from .serialization import RayTaskError, WorkerCrashedError

__all__ = ["ObjectDirectory", "ObjectRef", "MemoryStore", "ObjectLostError",
           "GetTimeoutError", "PullManager", "PullPriority", "RayTaskError",
           "WorkerCrashedError"]

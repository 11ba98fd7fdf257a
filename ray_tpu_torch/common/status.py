"""Status / error taxonomy for the runtime.

Reference parity: upstream Ray's ``ray::Status`` (``src/ray/common/status.h``)
plus the user-visible exception hierarchy in ``python/ray/exceptions.py``
(``RayTaskError``, ``RayActorError``, ``ObjectLostError``,
``GetTimeoutError``, ...).  [SURVEY.md §1; reference mount empty.]
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base for all framework errors."""


class TaskError(RayTpuError):
    """A task raised; re-raised at ray_tpu_torch.get() with the remote traceback."""

    def __init__(self, function_descriptor: str, cause_repr: str,
                 traceback_str: str = ""):
        self.function_descriptor = function_descriptor
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str
        super().__init__(
            f"task {function_descriptor} failed: {cause_repr}\n{traceback_str}")


class ActorError(RayTpuError):
    """The actor died before or during this method call."""


class ActorUnavailableError(ActorError):
    pass


class ObjectLostError(RayTpuError):
    """Object is gone and lineage reconstruction was impossible/exhausted."""


class ObjectReconstructionError(ObjectLostError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class BackPressureError(RayTpuError):
    """A deployment's bounded request queue is full; the request was
    shed instead of queued (reference: ``serve.exceptions.BackPressureError``
    raised when ``max_queued_requests`` is exceeded)."""


class WorkerCrashedError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError):
    pass


class InfeasibleError(RayTpuError):
    """No node in the cluster can ever satisfy the request."""


class RuntimeEnvSetupError(RayTpuError):
    pass

"""Serialization + task error types.

Reference parity: upstream serializes with pickle5 + cloudpickle and wraps
user exceptions in ``RayTaskError`` so a failed task's error propagates
through ``ray.get`` at the caller (``python/ray/_private/serialization.py``,
``python/ray/exceptions.py`` — SURVEY.md §2.2; mount empty).

cloudpickle handles closures, lambdas and ``__main__``-defined functions,
which plain pickle cannot ship to spawned workers.
"""

from __future__ import annotations

import traceback

import cloudpickle


def serialize(value) -> bytes:
    return cloudpickle.dumps(value)


def deserialize(data: bytes):
    return cloudpickle.loads(data)


class RayError(Exception):
    """Base for framework-raised errors."""


class RayTaskError(RayError):
    """A task raised; re-raised at every ray.get of its outputs.

    Stored AS the task's result objects, so any number of gets — local or
    remote, now or later — observe the failure (reference behavior).
    """

    def __init__(self, function_name: str, tb: str,
                 cause: BaseException | None = None):
        self.function_name = function_name
        self.tb = tb
        self.cause = cause
        super().__init__(
            f"task {function_name} failed:\n{tb}")

    def __reduce__(self):
        # Exception's default reduce replays self.args (the formatted
        # message) into __init__, which has a different signature
        return (RayTaskError, (self.function_name, self.tb, self.cause))

    @classmethod
    def from_exception(cls, function_name: str,
                       exc: BaseException) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc,
                                                exc.__traceback__))
        # keep the cause only if it survives pickling (user exceptions may
        # hold unpicklable state; the traceback string always survives)
        try:
            cloudpickle.dumps(exc)
            cause = exc
        except Exception:
            cause = None
        return cls(function_name, tb, cause)


class WorkerCrashedError(RayError):
    """The worker process executing the task died (reference:
    ``ray.exceptions.WorkerCrashedError``)."""


class TaskCancelledError(RayError):
    """The task was cancelled before/while running (reference:
    ``ray.exceptions.TaskCancelledError``)."""


class ActorDiedError(RayError):
    """The actor died before/while executing the method call (reference:
    ``ray.exceptions.RayActorError``)."""

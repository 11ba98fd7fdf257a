"""ray_tpu_torch.workflow — durable DAG execution with resume.

Reference parity: ``ray.workflow`` (``python/ray/workflow/``) — a DAG of
task nodes built with ``.bind()`` runs under a workflow id; every step's
result is persisted to workflow storage before dependents run, so a
crashed/interrupted run resumes from the last completed step instead of
recomputing (``workflow.run/resume/get_status/list_all`` — SURVEY.md §1
layer 14, §5.4; mount empty).
"""

from .execution import (StepNode, get_output, get_status, list_all,
                        resume, run, step)

__all__ = ["StepNode", "get_output", "get_status", "list_all", "resume",
           "run", "step"]

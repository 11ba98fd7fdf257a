"""Workflow DAG build + durable topological execution.

Step results persist to ``<storage>/<workflow_id>/<step_id>.pkl``
BEFORE any dependent runs; resume replays completion state from disk
and only executes the missing suffix of the DAG (the reference's
storage-backed step checkpointing — ``python/ray/workflow/``; mount
empty).  Step ids are deterministic (function name + DAG position) so a
resumed run lines up with the original's artifacts.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Callable

# apart from the JAX package's ~/.ray_tpu_workflows: a resume must never
# load the other package's pickled steps
_DEFAULT_STORAGE = os.path.expanduser("~/.ray_tpu_torch_workflows")


class StepNode:
    """One DAG node: a function plus args that may be other nodes."""

    def __init__(self, fn: Callable, args: tuple, kwargs: dict,
                 name: str | None = None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or getattr(fn, "__name__", "step")

    def bind(self, *args, **kwargs) -> "StepNode":
        raise TypeError("already bound; bind the decorated function")


class _Step:
    """``@workflow.step``-style wrapper: ``.bind`` builds DAG nodes."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self.__name__ = getattr(fn, "__name__", "step")

    def bind(self, *args, **kwargs) -> StepNode:
        return StepNode(self._fn, args, kwargs)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def step(fn: Callable) -> _Step:
    return _Step(fn)


# -- storage -----------------------------------------------------------------

def _wf_dir(workflow_id: str, storage: str | None) -> str:
    return os.path.join(storage or _DEFAULT_STORAGE, workflow_id)


def _meta_path(wf_dir: str) -> str:
    return os.path.join(wf_dir, "workflow.json")


def _write_meta(wf_dir: str, meta: dict) -> None:
    tmp = _meta_path(wf_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, _meta_path(wf_dir))     # atomic: no torn meta


def _read_meta(wf_dir: str) -> dict | None:
    try:
        with open(_meta_path(wf_dir)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _step_path(wf_dir: str, step_id: str) -> str:
    return os.path.join(wf_dir, f"{step_id}.pkl")


# -- execution ---------------------------------------------------------------

def _assign_ids(node: StepNode) -> dict[int, str]:
    """Deterministic step ids by post-order position (stable across a
    re-run of the same DAG shape, which is what resume requires)."""
    ids: dict[int, str] = {}
    counter = [0]

    def visit(n: Any) -> None:
        if not isinstance(n, StepNode) or id(n) in ids:
            return
        for a in list(n.args) + list(n.kwargs.values()):
            visit(a)
        ids[id(n)] = f"{counter[0]:04d}_{n.name}"
        counter[0] += 1

    visit(node)
    return ids


def _execute(node: StepNode, wf_dir: str, ids: dict[int, str],
             done: dict[str, Any], timeout: float) -> Any:
    """Submit the WHOLE remaining DAG up front (ObjectRefs chain the
    dependencies, so independent branches run concurrently on the
    cluster), then collect + persist step results in id order."""
    import ray_tpu_torch
    refs: dict[str, Any] = {}

    def build(n: Any) -> Any:
        if not isinstance(n, StepNode):
            return n
        step_id = ids[id(n)]
        if step_id in done:
            return done[step_id]        # loaded from storage: by value
        if step_id in refs:
            return refs[step_id]        # shared node submits once
        args = [build(a) for a in n.args]
        kwargs = {k: build(v) for k, v in n.kwargs.items()}
        ref = ray_tpu_torch.remote(n.fn).remote(*args, **kwargs)
        refs[step_id] = ref
        return ref

    build(node)
    # collect in post-order id order: when a mid-DAG step fails, every
    # earlier completed step has already been persisted for resume
    for step_id in sorted(refs):
        result = ray_tpu_torch.get(refs[step_id], timeout=timeout)
        tmp = _step_path(wf_dir, step_id) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, _step_path(wf_dir, step_id))    # atomic
        done[step_id] = result
    root_id = ids[id(node)]
    return done[root_id] if isinstance(node, StepNode) else node


def run(node: StepNode, *, workflow_id: str,
        storage: str | None = None, timeout: float = 300.0) -> Any:
    """Execute (or re-execute the missing part of) a workflow."""
    wf_dir = _wf_dir(workflow_id, storage)
    os.makedirs(wf_dir, exist_ok=True)
    ids = _assign_ids(node)
    done: dict[str, Any] = {}
    for step_id in ids.values():        # load completed steps
        try:
            with open(_step_path(wf_dir, step_id), "rb") as f:
                done[step_id] = pickle.load(f)
        except FileNotFoundError:
            pass
    _write_meta(wf_dir, {"workflow_id": workflow_id,
                         "status": "RUNNING",
                         "num_steps": len(ids),
                         "start_time": time.time()})
    try:
        result = _execute(node, wf_dir, ids, done, timeout)
    except BaseException:
        _write_meta(wf_dir, {"workflow_id": workflow_id,
                             "status": "FAILED",
                             "num_steps": len(ids),
                             "completed": sorted(done)})
        raise
    _write_meta(wf_dir, {"workflow_id": workflow_id,
                         "status": "SUCCEEDED",
                         "num_steps": len(ids),
                         "completed": sorted(done),
                         "end_time": time.time()})
    return result


def resume(node: StepNode, *, workflow_id: str,
           storage: str | None = None, timeout: float = 300.0) -> Any:
    """Re-drive a workflow: completed steps load from storage, only the
    missing suffix executes (same entry as ``run`` — named for API
    parity and intent)."""
    return run(node, workflow_id=workflow_id, storage=storage,
               timeout=timeout)


def get_status(workflow_id: str, *, storage: str | None = None) -> str:
    meta = _read_meta(_wf_dir(workflow_id, storage))
    return meta["status"] if meta else "NOT_FOUND"


def get_output(workflow_id: str, *, storage: str | None = None) -> Any:
    """The final step's persisted result (the highest-numbered id)."""
    wf_dir = _wf_dir(workflow_id, storage)
    meta = _read_meta(wf_dir)
    if meta is None or meta.get("status") != "SUCCEEDED":
        raise ValueError(f"workflow {workflow_id!r} has no output "
                         f"(status: {get_status(workflow_id, storage=storage)})")
    last = sorted(meta["completed"])[-1]
    with open(_step_path(wf_dir, last), "rb") as f:
        return pickle.load(f)


def list_all(*, storage: str | None = None) -> list[dict]:
    root = storage or _DEFAULT_STORAGE
    out = []
    try:
        entries = sorted(os.listdir(root))
    except FileNotFoundError:
        return []
    for name in entries:
        meta = _read_meta(os.path.join(root, name))
        if meta:
            out.append(meta)
    return out

"""JaxTrainer (alias TorchTrainer): gang-scheduled worker actors +
collective gradient sync.

Reference parity: ``ray.train``'s ``DataParallelTrainer`` — worker
actors are gang-placed (PACK placement group), each runs the user's
``train_loop_per_worker`` with a ``TrainContext`` (rank, world size,
dataset shard, ``report``), gradients sync through the collective
backend, and rank 0's reports drive the returned ``Result``
(SURVEY.md §1 layer 14, §2.4; mount empty).
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from .checkpoint import Checkpoint

_ctx = threading.local()        # the worker-side TrainContext


@dataclass
class ScalingConfig:
    """``min_workers`` makes the gang ELASTIC: a restart after failure
    may shrink the world to whatever capacity remains (never below
    ``min_workers``) instead of deadlocking on a full-size placement
    that lost nodes can no longer satisfy, and later restarts grow
    back toward ``num_workers`` as capacity returns (reference:
    Train's elastic integration — SURVEY.md §2.4 elastic row; mount
    empty)."""

    num_workers: int = 2
    resources_per_worker: dict[str, float] = field(
        default_factory=lambda: {"CPU": 1})
    min_workers: int | None = None      # None = fixed-size gang


@dataclass
class FailureConfig:
    """Gang fault tolerance (reference ``train.FailureConfig``): on a
    worker failure the whole gang restarts — up to ``max_failures``
    times — from the latest checkpoint rank 0 persisted through
    ``train.report(..., checkpoint=...)`` (the loop resumes it via
    ``train.get_checkpoint()``)."""

    max_failures: int = 0


@dataclass
class Result:
    metrics: dict[str, Any]
    checkpoint: Checkpoint | None
    history: list[dict[str, Any]]


class TrainContext:
    def __init__(self, rank: int, world_size: int, group: str,
                 shard, config: dict,
                 checkpoint_in: Checkpoint | None = None,
                 persist_key: str | None = None,
                 collective_timeout_s: float | None = None):
        self._rank = rank
        self._world = world_size
        self._group = group
        self._shard = shard
        self._config = config
        self._persist_key = persist_key
        # None = the global collective_timeout_s knob; the elastic
        # trainer passes the tighter train_collective_timeout_s so a
        # SIGKILLed peer surfaces as GangMemberLost within the gang's
        # own budget instead of the cluster-wide default
        self._coll_timeout = collective_timeout_s
        self.checkpoint_in = checkpoint_in
        self.reports: list[dict] = []
        self.checkpoint: Checkpoint | None = None

    def get_checkpoint(self) -> Checkpoint | None:
        """The checkpoint to resume from (a prior attempt's persisted
        state, or None on a fresh start)."""
        return self.checkpoint_in

    def get_world_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._world

    def get_dataset_shard(self):
        return self._shard

    def get_config(self) -> dict:
        return self._config

    # -- collective helpers --------------------------------------------------
    def allreduce(self, tree, op: str = "mean"):
        """Allreduce a pytree of arrays across the worker gang in ONE
        collective round (leaves flattened into a single vector — one
        KV rendezvous instead of one per leaf).  A leaf may be a CPU
        ``torch.Tensor``; it comes back as a tensor of its own dtype."""
        from ..util import collective as col
        leaves, treedef = _flatten(tree)
        arrays = [_host_array(x) for x in leaves]
        flat = np.concatenate([a.astype(np.float64).ravel()
                               for a in arrays]) if leaves else \
            np.zeros(0)
        red = col.allreduce(flat, op="sum", group_name=self._group,
                            timeout=self._coll_timeout)
        if op == "mean":
            red = red / self._world
        out, pos = [], 0
        for leaf, a in zip(leaves, arrays):
            val = red[pos:pos + a.size].reshape(a.shape).astype(a.dtype)
            out.append(_tensor_like(leaf, val))
            pos += a.size
        return _unflatten(treedef, out)

    def barrier(self) -> None:
        from ..util import collective as col
        col.barrier(group_name=self._group, timeout=self._coll_timeout)

    def report(self, metrics: dict,
               checkpoint: Checkpoint | None = None) -> None:
        self.reports.append(dict(metrics))
        if checkpoint is not None:
            self.checkpoint = checkpoint
            if self._rank == 0 and self._persist_key is not None:
                # durable checkpoint (reference: report() uploads to
                # storage) — a gang restart resumes from HERE, not from
                # scratch; rank 0 only, like the reference's convention
                from ..experimental.internal_kv import _internal_kv_put
                from ..runtime.serialization import serialize
                _internal_kv_put(self._persist_key,
                                 serialize(checkpoint.to_dict()),
                                 namespace="train")


def get_context() -> TrainContext:
    ctx = getattr(_ctx, "value", None)
    if ctx is None:
        raise RuntimeError("not inside a train loop")
    return ctx


def report(metrics: dict, checkpoint: Checkpoint | None = None) -> None:
    """``ray_tpu_torch.train.report`` — callable from inside the loop."""
    get_context().report(metrics, checkpoint)


def get_checkpoint() -> Checkpoint | None:
    """``ray_tpu_torch.train.get_checkpoint`` — the resume point after a gang
    restart (reference: ``train.get_checkpoint()``)."""
    return get_context().get_checkpoint()


# -- tiny pytree (dict/list/tuple/leaf) --------------------------------------

def _torch_tensor_type():
    """``torch.Tensor`` if torch is loaded, else None: a gang worker
    imports torch only when its loop does, so no leaf can be a tensor
    before that."""
    torch = sys.modules.get("torch")
    return torch.Tensor if torch is not None else None


def _host_array(leaf) -> np.ndarray:
    tensor = _torch_tensor_type()
    if tensor is not None and isinstance(leaf, tensor):
        # a CPU tensor: gang workers see no GPU
        return leaf.detach().numpy()
    return np.asarray(leaf)


def _tensor_like(leaf, value: np.ndarray):
    tensor = _torch_tensor_type()
    if tensor is not None and isinstance(leaf, tensor):
        return sys.modules["torch"].from_numpy(value)
    return value


def _flatten(tree):
    leaves: list = []

    def rec(node):
        if isinstance(node, dict):
            return ("d", [(k, rec(node[k])) for k in sorted(node)])
        if isinstance(node, (list, tuple)):
            return ("l" if isinstance(node, list) else "t",
                    [rec(x) for x in node])
        leaves.append(node)
        return ("x", len(leaves) - 1)

    return leaves, rec(tree)


def _unflatten(treedef, leaves):
    kind, payload = treedef
    if kind == "d":
        return {k: _unflatten(v, leaves) for k, v in payload}
    if kind in ("l", "t"):
        seq = [_unflatten(v, leaves) for v in payload]
        return seq if kind == "l" else tuple(seq)
    return leaves[payload]


# -- the worker actor --------------------------------------------------------

class _TrainWorker:
    """One gang member: joins the collective group, runs the loop."""

    def run(self, fn_bytes: bytes, config: dict, rank: int,
            world: int, group: str, shard_rows,
            ckpt_state: dict | None = None,
            persist_key: str | None = None) -> tuple:
        from ..runtime.serialization import deserialize
        from ..util import collective as col
        col.init_collective_group(world, rank, group)
        try:
            ctx = TrainContext(
                rank, world, group, shard_rows, config,
                checkpoint_in=(Checkpoint(ckpt_state)
                               if ckpt_state is not None else None),
                persist_key=persist_key)
            _ctx.value = ctx
            try:
                deserialize(fn_bytes)(config)
            finally:
                _ctx.value = None
            ckpt_state = ctx.checkpoint.to_dict() \
                if ctx.checkpoint is not None else None
            return ctx.reports, ckpt_state
        finally:
            col.destroy_collective_group(group)


class JaxTrainer:
    def __init__(self, train_loop_per_worker: Callable[[dict], None],
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 failure_config: FailureConfig | None = None,
                 datasets: dict | None = None):
        self._fn = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self._scaling = scaling_config or ScalingConfig()
        self._failure = failure_config or FailureConfig()
        self._datasets = dict(datasets or {})

    def fit(self, timeout: float = 300.0) -> Result:
        """Run the gang to completion.  ``timeout`` is PER ATTEMPT: with
        ``FailureConfig(max_failures=k)`` the worst-case wall time is
        ``(k+1) * timeout`` plus placement; ``max_failures=-1`` retries
        forever (the reference's infinite-retry value)."""
        import logging
        import os

        import ray_tpu_torch
        from ..experimental.internal_kv import (_internal_kv_del,
                                                _internal_kv_get)
        from ..runtime.serialization import deserialize, serialize
        from ..util.placement_group import (placement_group,
                                            remove_placement_group)
        n_target = self._scaling.num_workers
        n_min = self._scaling.min_workers
        res = self._scaling.resources_per_worker
        # serialize BEFORE reserving anything: an unpicklable train
        # loop must fail without leaking a placement group
        fn_bytes = serialize(self._fn)
        train_ds = self._datasets.get("train")
        run_id = os.urandom(4).hex()
        persist_key = f"ckpt-{run_id}"
        max_failures = self._failure.max_failures
        attempt = 0         # total restarts (drives elastic resize)
        failures = 0        # REAL failures only (drives max_failures)
        pg = None
        pg_size = 0         # bundle count of the LIVE pg (pg is None ok)
        shards: list = []
        shard_world = -1    # world size the shards were cut for
        log = logging.getLogger("ray_tpu_torch.train")
        # proactive drain handling (driver mode): a drain notice for a
        # node hosting our bundles kills the gang NOW, so the blocked
        # gang get raises and the next attempt checkpoints-and-resizes
        # away from the draining node — a planned handoff, so it does
        # NOT burn the failure budget.  The resume point is the latest
        # checkpoint rank 0 persisted through report().
        from ray_tpu_torch.api import _get_runtime
        cluster = getattr(_get_runtime(), "cluster", None)
        drain_hit = threading.Event()
        self._live_actors: list = []
        live_pg: dict = {"pg": None}
        sub = None
        if cluster is not None:
            def _on_node_event(msg, _c=cluster):
                if not isinstance(msg, dict) or \
                        msg.get("event") != "draining":
                    return
                pg_now = live_pg["pg"]
                if pg_now is None:
                    return
                rec = _c.pg_manager.get(pg_now.id)
                if rec is None or msg.get("row") not in rec.rows:
                    return
                drain_hit.set()
                for a in list(self._live_actors):
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:   # noqa: BLE001 — already dead
                        pass
            sub = cluster.pubsub.subscribe("node", _on_node_event)
        try:
            while True:
                world = n_target
                if attempt > 0 and n_min is not None \
                        and n_min < n_target:
                    # ELASTIC restart: drop OUR OWN reservation first
                    # (it shadows exactly the capacity being measured),
                    # then size to what single nodes can actually host
                    # — never below min_workers; capacity that came
                    # back grows the gang toward the target again
                    if pg is not None:
                        remove_placement_group(pg)
                        pg = None
                    # resource release from the dead attempt's actors
                    # and bundles is ASYNC: the first sample comes
                    # AFTER a sleep (a t=0 reading predates the
                    # release), then poll until the fit covers the
                    # target or two consecutive post-sleep readings
                    # agree
                    import time as _time
                    deadline = _time.monotonic() + 5.0
                    fits = -1
                    while _time.monotonic() < deadline:
                        _time.sleep(0.2)
                        again = self._placeable_workers(res)
                        if again >= n_target or \
                                (again == fits and again > 0):
                            # a transient 0 is never "stable": the
                            # release may still be landing — keep
                            # polling to the deadline
                            fits = again
                            break
                        fits = again
                    world = max(min(n_target, max(fits, 0)), n_min)
                    if world != pg_size:
                        log.warning(
                            "elastic gang resize: %d -> %d workers",
                            pg_size, world)
                raw = _internal_kv_get(persist_key, namespace="train")
                ckpt_state = deserialize(raw) if raw is not None \
                    else None
                try:
                    if pg is None or world != pg_size:
                        if pg is not None:
                            remove_placement_group(pg)
                            pg = None
                        # gang placement: all-or-none (reference:
                        # Train reserves a PACK group before starting).
                        # pg_size updates BEFORE ready(): a timed-out
                        # group still matches its recorded size, so a
                        # later attempt never runs N workers against a
                        # smaller group
                        pg = placement_group([dict(res)] * world,
                                             strategy="PACK")
                        pg_size = world
                        live_pg["pg"] = pg
                        ray_tpu_torch.get(pg.ready(), timeout=timeout)
                    live_pg["pg"] = pg
                    if shard_world != world:
                        shards = [None] * world
                        if train_ds is not None:
                            shards = [s.take_all()
                                      for s in train_ds.split(world)]
                        shard_world = world
                    outs = self._run_gang(
                        pg, fn_bytes, shards, world,
                        f"train-{run_id}-a{attempt}", ckpt_state,
                        persist_key, timeout)
                    break
                except Exception as e:  # noqa: BLE001 — worker/gang death
                    if drain_hit.is_set():
                        # planned node handoff, not a failure: resume
                        # from the checkpoint and resize off the
                        # draining node (its row is already masked).
                        # Drop the pg — the drain notice arrives BEFORE
                        # the group is displaced, so reusing it could
                        # land the new gang back on the doomed node; a
                        # fresh group places against the masked row
                        drain_hit.clear()
                        live_pg["pg"] = None
                        if pg is not None:
                            remove_placement_group(pg)
                            pg = None
                            pg_size = 0
                        attempt += 1
                        log.warning(
                            "train gang interrupted by node drain "
                            "(restart %d); checkpointing and resizing "
                            "away from the draining node", attempt)
                        continue
                    if 0 <= max_failures <= failures:
                        raise
                    attempt += 1
                    failures += 1
                    # gang restart (reference FailureConfig): the next
                    # attempt resumes from the persisted checkpoint
                    log.warning(
                        "train gang attempt %d failed (%s: %s); "
                        "restarting from the persisted checkpoint",
                        attempt, type(e).__name__, e)
        finally:
            if sub is not None:
                sub.unsubscribe()
            self._live_actors = []
            try:
                _internal_kv_del(persist_key, namespace="train")
            except Exception:   # noqa: BLE001 — a degraded KV must not
                pass            # leak the PG or mask the gang error
            if pg is not None:
                remove_placement_group(pg)
        rank0_reports, ckpt_state = outs[0]
        return Result(
            metrics=rank0_reports[-1] if rank0_reports else {},
            checkpoint=Checkpoint(ckpt_state)
            if ckpt_state is not None else None,
            history=rank0_reports)

    @staticmethod
    def _placeable_workers(res: dict) -> int:
        """How many worker BUNDLES current availability fits.  Each
        bundle must land whole on ONE node, so count per-node fits and
        sum (an aggregate view would report fragmented capacity no
        single node can host); client mode falls back to the aggregate
        (its only view), which over-estimates at worst into a ready()
        timeout that the retry loop absorbs."""
        import ray_tpu_torch
        from ray_tpu_torch.api import _get_runtime
        rt = _get_runtime()
        crm = getattr(rt, "crm", None)
        if crm is not None:
            from ray_tpu_torch.common.resources import ResourceRequest
            snap = crm.snapshot()
            vec = ResourceRequest(res).dense(crm.resource_index,
                                             snap.avail.shape[1])
            total = 0
            for row in range(snap.avail.shape[0]):
                if not snap.node_mask[row]:
                    continue
                fits = [int(snap.avail[row, i]) // int(v)
                        for i, v in enumerate(vec) if v > 0]
                total += max(min(fits) if fits else 0, 0)
            return total
        avail = ray_tpu_torch.available_resources()
        counts = [int(avail.get(k, 0.0) // v)
                  for k, v in res.items() if v > 0]
        return max(min(counts) if counts else 0, 0)

    def _run_gang(self, pg, fn_bytes, shards, n, group,
                  ckpt_state, persist_key, timeout) -> list:
        import ray_tpu_torch
        res = self._scaling.resources_per_worker
        worker_cls = ray_tpu_torch.remote(_TrainWorker)
        actors: list = []
        try:
            actors = [worker_cls.options(
                num_cpus=res.get("CPU", 1),
                placement_group=pg,
                placement_group_bundle_index=i).remote()
                for i in range(n)]
            # visible to the drain-notice subscriber: a draining node
            # hosting this gang kills the actors so the get below
            # raises instead of blocking out the whole drain deadline
            self._live_actors = actors
            return ray_tpu_torch.get(
                [a.run.remote(fn_bytes, self._config, i, n, group,
                              shards[i], ckpt_state, persist_key)
                 for i, a in enumerate(actors)],
                timeout=timeout)
        finally:
            self._live_actors = []
            # kill in the FINALLY: a failed/timed-out gang must not
            # leak N actors (and their half-joined collective group)
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:   # noqa: BLE001 — already dead
                    pass


# the gang trainer's name in the port; ElasticTrainer extends JaxTrainer
TorchTrainer = JaxTrainer

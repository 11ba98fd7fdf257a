"""ElasticTrainer: a training run that survives the cluster around it.

``JaxTrainer`` restarts a gang; ``ElasticTrainer`` keeps a *run* alive
across everything the pool throws at it, by moving the run's identity
out of the driver and into cluster-durable planes:

- **Journaled progress** — epoch/step/attempt land in the
  GCS-snapshotted KV (namespace ``train``) via read-modify-write, with
  epoch/step clamped monotonic so acked progress never regresses.  A
  promoted standby (or a re-run with the same ``run_name``) inherits
  the run mid-flight instead of starting over.
- **Broadcast-fed weight sync** — the resume checkpoint is put ONCE
  and fanned out over the object plane's relay tree
  (``BroadcastManager.broadcast``) to every gang row before workers
  start, so N (re)joining workers cost one tree, not N point-to-point
  pulls of the same bytes.
- **Checkpoint replication** — the staged checkpoint object is pulled
  to ``train_ckpt_replicas`` rows off the writing node
  (``PullManager.request_pull``), so the resume point survives that
  node's death — the same primitive the drain monitor uses for sole
  copies.
- **Planned vs real failures** — node drain notices AND capacity-loan
  reclaims (both published on the ``node`` pubsub channel before work
  is displaced) kill the gang proactively and restart it as a planned
  resize: no ``max_failures`` burn.  A peer SIGKILLed mid-allreduce
  surfaces as typed :class:`~ray_tpu_torch.util.collective.GangMemberLost`
  (bounded by ``train_collective_timeout_s``) and triggers a gang
  re-form from the last journaled step — budgeted separately
  (``max_gang_reforms``) from unexplained failures.

The simulator mirror is ``ray_tpu_torch.sim.train.SimTrainPlane`` (the
``train_diurnal`` campaign); invariants ``goodput-accounting``,
``ckpt-durable`` and ``gang-terminal`` pin the semantics.
"""

from __future__ import annotations

import json
import threading
import weakref
from typing import Callable

from ..common import clock as _clk
from ..common.config import get_config
from .checkpoint import Checkpoint
from .trainer import (FailureConfig, JaxTrainer, Result, ScalingConfig,
                      TrainContext, _ctx)

__all__ = ["ElasticTrainer", "active_train_stats"]

# live trainers, for /metrics and `ray_tpu_torch status` train gauges
_ACTIVE: "weakref.WeakSet[ElasticTrainer]" = weakref.WeakSet()


def active_train_stats() -> list[dict]:
    """Stats dicts of every ElasticTrainer this driver has run."""
    return [t.stats() for t in list(_ACTIVE)]


# -- the epoch journal (KV, namespace "train") --------------------------------

def _journal_read(key: str) -> dict:
    from ..experimental.internal_kv import _internal_kv_get
    try:
        raw = _internal_kv_get(key, namespace="train")
    except Exception:   # noqa: BLE001 — KV down mid-failover
        return {}
    if raw is None:
        return {}
    try:
        return json.loads(raw.decode())
    except Exception:   # noqa: BLE001 — torn write never poisons a run
        return {}


def _journal_update(key: str, **fields) -> dict:
    """Read-modify-write the run journal.  ``epoch``/``step`` only move
    FORWARD: a gang restart, a stale worker, or a promoted standby can
    never regress acked progress (the ``goodput-accounting`` invariant
    live-side)."""
    from ..experimental.internal_kv import _internal_kv_put
    cur = _journal_read(key)
    for name, value in fields.items():
        if value is None:
            continue
        if name in ("epoch", "step") and \
                isinstance(cur.get(name), (int, float)):
            value = max(cur[name], value)
        cur[name] = value
    try:
        _internal_kv_put(key, json.dumps(cur, sort_keys=True).encode(),
                         namespace="train")
    except Exception:   # noqa: BLE001 — KV down: next report retries
        pass
    return cur


def _gang_member_lost(err: BaseException) -> bool:
    """Is this gang failure a MEMBERSHIP event (recoverable re-form)
    rather than a user-code bug?  Two signatures, depending on which
    rank's error wins the race to the driver: the SIGKILLed member's
    process death (``ActorDiedError``) or a surviving rank's bounded
    collective timeout (``GangMemberLost``) — both ride through the
    RayTaskError wrapping as ``.cause`` when they pickle, and always as
    text in the re-raised traceback."""
    from ..runtime.serialization import ActorDiedError
    from ..util.collective import GangMemberLost
    seen: set[int] = set()
    e: BaseException | None = err
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, (GangMemberLost, ActorDiedError)):
            return True
        e = getattr(e, "cause", None) or e.__cause__
    return "GangMemberLost" in str(err) or "ActorDiedError" in str(err)


# -- worker side --------------------------------------------------------------

class _ElasticContext(TrainContext):
    """Rank 0's reports also journal epoch/step, so the driver (or its
    promoted successor) can resume from the last *acked* step even when
    the gang dies before ``fit`` sees any output."""

    def __init__(self, *args, journal_key: str | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._journal_key = journal_key

    def report(self, metrics: dict,
               checkpoint: Checkpoint | None = None) -> None:
        super().report(metrics, checkpoint)
        if self._rank == 0 and self._journal_key is not None \
                and checkpoint is not None:
            _journal_update(self._journal_key,
                            epoch=metrics.get("epoch"),
                            step=metrics.get("step", len(self.reports)))


class _ElasticWorker:
    """One gang member, fed by the broadcast plane: the resume
    checkpoint arrives as an ObjectRef whose bytes the controller
    already broadcast to this node, so joining is a local get."""

    def run(self, fn_bytes: bytes, config: dict, rank: int,
            world: int, group: str, shard_rows,
            ckpt_ref=None, ckpt_state: dict | None = None,
            persist_key: str | None = None,
            journal_key: str | None = None) -> tuple:
        import ray_tpu_torch
        from ..runtime.serialization import deserialize
        from ..util import collective as col
        if ckpt_ref is not None:
            # arg resolution may already have materialised the value
            ckpt_state = ray_tpu_torch.get(ckpt_ref) \
                if hasattr(ckpt_ref, "id") else ckpt_ref
        col.init_collective_group(world, rank, group)
        try:
            ctx = _ElasticContext(
                rank, world, group, shard_rows, config,
                checkpoint_in=(Checkpoint(ckpt_state)
                               if ckpt_state is not None else None),
                persist_key=persist_key,
                collective_timeout_s=float(
                    get_config().train_collective_timeout_s),
                journal_key=journal_key)
            _ctx.value = ctx
            try:
                deserialize(fn_bytes)(config)
            finally:
                _ctx.value = None
            state = ctx.checkpoint.to_dict() \
                if ctx.checkpoint is not None else None
            return ctx.reports, state
        finally:
            col.destroy_collective_group(group)


# -- the controller -----------------------------------------------------------

class ElasticTrainer(JaxTrainer):
    """``JaxTrainer`` with a cluster-durable run identity (see module
    docstring).  ``run_name`` pins that identity: a second driver —
    typically a promoted standby's — calling ``fit`` with the same name
    resumes the journaled run instead of starting a new one."""

    def __init__(self, train_loop_per_worker: Callable[[dict], None],
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 failure_config: FailureConfig | None = None,
                 datasets: dict | None = None,
                 run_name: str | None = None,
                 max_gang_reforms: int = 16):
        super().__init__(train_loop_per_worker,
                         train_loop_config=train_loop_config,
                         scaling_config=scaling_config,
                         failure_config=failure_config,
                         datasets=datasets)
        self._run_name = run_name
        self._max_reforms = max(int(max_gang_reforms), 1)
        self._ckpt_refs: list = []      # newest staged ckpt ref (pinned)
        self._stats: dict = {
            "run": run_name or "", "state": "idle", "journal_key": "",
            "attempts": 0, "failures": 0, "gang_losses": 0,
            "planned_resizes": 0, "sync_broadcasts": 0,
            "ckpt_replications": 0, "world": 0,
        }

    def stats(self) -> dict:
        out = dict(self._stats)
        if out.get("journal_key"):
            journal = _journal_read(out["journal_key"])
            out["epoch"] = journal.get("epoch")
            out["step"] = journal.get("step")
            # live goodput: acked epochs per wall second of fit() —
            # recovery time (gang re-forms, head failover stalls)
            # drags it down, which is the point of the metric
            t0 = getattr(self, "_t_fit", None)
            if t0 is not None and out["epoch"] is not None:
                dt = max(_clk.monotonic() - t0, 1e-9)
                out["goodput_eps"] = round(
                    (out["epoch"] + 1) / dt, 4)
        return out

    # -- checkpoint staging (broadcast + replication) ------------------------
    def _stage_checkpoint(self, cluster, ckpt_state, pg):
        """Put the resume state ONCE, fan it out over the broadcast
        relay tree to every gang row, and replicate the sole copy off
        the writing node.  Returns the ObjectRef to hand the workers
        (None = small/in-band state, shipped with the task specs)."""
        if cluster is None or ckpt_state is None:
            return None
        import ray_tpu_torch
        ref = ray_tpu_torch.put(ckpt_state)
        oid = ref.id
        if not cluster.directory.is_tracked(oid):
            return None
        rec = cluster.pg_manager.get(pg.id)
        rows = sorted(set(rec.rows)) if rec is not None else []
        try:
            summary = cluster.broadcasts.broadcast(oid, node_rows=rows)
            if summary.get("ok"):
                self._stats["sync_broadcasts"] += 1
        except Exception:   # noqa: BLE001 — workers fall back to pulls
            pass
        self._replicate_off_writer(cluster, oid)
        # pin the newest staged checkpoint only: older refs decref on
        # replacement, so superseded resume points can be reclaimed
        self._ckpt_refs = [ref]
        return ref

    def _replicate_off_writer(self, cluster, oid) -> None:
        """``ckpt-durable`` live-side: ask the pull manager for copies
        on other rows until ``train_ckpt_replicas`` nodes hold the
        resume point (same primitive the drain monitor uses for sole
        copies)."""
        from ..runtime.pull_manager import PullPriority
        want = max(int(get_config().train_ckpt_replicas), 1)
        have = set(cluster.directory.locations(oid))
        if len(have) >= want:
            return
        _kind, size = cluster.store.plasma_info(oid)
        snap = cluster.crm.snapshot()
        for row in range(snap.node_mask.shape[0]):
            if len(have) >= want:
                break
            if not snap.node_mask[row] or row in have:
                continue
            cluster.pull_manager.request_pull(oid, size, row,
                                              PullPriority.TASK_ARG)
            have.add(row)
        self._stats["ckpt_replications"] += 1

    # -- the run loop --------------------------------------------------------
    def fit(self, timeout: float = 300.0) -> Result:
        import logging
        import os

        import ray_tpu_torch
        from ray_tpu_torch.api import _get_runtime

        from ..experimental.internal_kv import (_internal_kv_del,
                                                _internal_kv_get)
        from ..runtime.serialization import deserialize, serialize
        from ..util.placement_group import (placement_group,
                                            remove_placement_group)
        n_target = self._scaling.num_workers
        n_min = self._scaling.min_workers
        res = self._scaling.resources_per_worker
        fn_bytes = serialize(self._fn)
        train_ds = self._datasets.get("train")
        run = self._run_name or os.urandom(4).hex()
        persist_key = f"ckpt-{run}"
        journal_key = f"journal-{run}"
        max_failures = self._failure.max_failures
        log = logging.getLogger("ray_tpu_torch.train")
        cluster = getattr(_get_runtime(), "cluster", None)
        st = self._stats
        st.update(run=run, state="running", journal_key=journal_key)
        self._t_fit = _clk.monotonic()
        _ACTIVE.add(self)
        inherited = _journal_read(journal_key)
        if inherited.get("epoch") is not None:
            # the run outlived its previous driver (head failover /
            # standby promotion, or a deliberate re-run): pick it up
            # at the journaled step instead of epoch 0
            log.warning(
                "elastic run %s: inheriting journal at epoch %s "
                "step %s", run, inherited.get("epoch"),
                inherited.get("step"))
        attempt = int(inherited.get("attempt", 0))
        failures = 0
        reforms = 0
        pg = None
        pg_size = 0
        shards: list = []
        shard_world = -1
        planned_hit = threading.Event()
        self._live_actors: list = []
        live_pg: dict = {"pg": None}
        sub = None
        if cluster is not None:
            # drain notices AND loan reclaims arrive on the same
            # channel, both published BEFORE the node's work is
            # displaced — either one hitting a gang row is a PLANNED
            # resize, not a failure
            def _on_node_event(msg, _c=cluster):
                if not isinstance(msg, dict) or msg.get("event") not in \
                        ("draining", "loan_reclaim"):
                    return
                pg_now = live_pg["pg"]
                if pg_now is None:
                    return
                rec = _c.pg_manager.get(pg_now.id)
                if rec is None or msg.get("row") not in rec.rows:
                    return
                planned_hit.set()
                for a in list(self._live_actors):
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:   # noqa: BLE001 — already dead
                        pass
            sub = cluster.pubsub.subscribe("node", _on_node_event)
        outs = None
        try:
            while True:
                world = n_target
                if attempt > 0 and n_min is not None \
                        and n_min < n_target:
                    if pg is not None:
                        remove_placement_group(pg)
                        pg = None
                    # capacity release from the dead attempt is async:
                    # poll to a stable reading (JaxTrainer's rule)
                    deadline = _clk.monotonic() + 5.0
                    fits = -1
                    while _clk.monotonic() < deadline:
                        _clk.sleep(0.2)
                        again = self._placeable_workers(res)
                        if again >= n_target or \
                                (again == fits and again > 0):
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
                    ckpt_ref = self._stage_checkpoint(cluster,
                                                      ckpt_state, pg)
                    st["attempts"] = attempt + 1
                    st["world"] = world
                    _journal_update(journal_key, attempt=attempt,
                                    world=world)
                    outs = self._run_elastic_gang(
                        pg, fn_bytes, shards, world,
                        f"etrain-{run}-a{attempt}", ckpt_ref,
                        ckpt_state, persist_key, journal_key, timeout)
                    break
                except Exception as e:  # noqa: BLE001 — gang death
                    if planned_hit.is_set():
                        planned_hit.clear()
                        live_pg["pg"] = None
                        if pg is not None:
                            remove_placement_group(pg)
                            pg = None
                            pg_size = 0
                        attempt += 1
                        st["planned_resizes"] += 1
                        log.warning(
                            "elastic gang displaced by a planned event "
                            "(drain/loan reclaim); resuming from "
                            "journaled epoch %s",
                            _journal_read(journal_key).get("epoch"))
                        continue
                    if _gang_member_lost(e) and \
                            reforms < self._max_reforms:
                        attempt += 1
                        reforms += 1
                        st["gang_losses"] += 1
                        log.warning(
                            "gang member lost mid-collective "
                            "(re-form %d/%d); resuming from journaled "
                            "epoch %s", reforms, self._max_reforms,
                            _journal_read(journal_key).get("epoch"))
                        continue
                    if 0 <= max_failures <= failures:
                        st["state"] = "failed"
                        raise
                    attempt += 1
                    failures += 1
                    st["failures"] = failures
                    log.warning(
                        "elastic gang attempt %d failed (%s: %s); "
                        "restarting from the persisted checkpoint",
                        attempt, type(e).__name__, e)
        finally:
            if sub is not None:
                sub.unsubscribe()
            self._live_actors = []
            if pg is not None:
                remove_placement_group(pg)
        # freeze the run's goodput before the journal goes: acked
        # epochs over total fit wall time, recovery stalls included
        final_epoch = _journal_read(journal_key).get("epoch")
        if final_epoch is not None:
            dt = max(_clk.monotonic() - self._t_fit, 1e-9)
            st["goodput_eps"] = round((final_epoch + 1) / dt, 4)
        # the run COMPLETED: only now retire its durable identity — a
        # failed/interrupted run keeps journal + checkpoint in the KV
        # so a successor driver can inherit it
        try:
            _internal_kv_del(persist_key, namespace="train")
            _internal_kv_del(journal_key, namespace="train")
        except Exception:   # noqa: BLE001 — degraded KV must not mask
            pass            # the result
        self._ckpt_refs = []
        st["state"] = "complete"
        rank0_reports, ckpt_state = outs[0]
        return Result(
            metrics=rank0_reports[-1] if rank0_reports else {},
            checkpoint=Checkpoint(ckpt_state)
            if ckpt_state is not None else None,
            history=rank0_reports)

    def _run_elastic_gang(self, pg, fn_bytes, shards, n, group,
                          ckpt_ref, ckpt_state, persist_key,
                          journal_key, timeout) -> list:
        import ray_tpu_torch
        res = self._scaling.resources_per_worker
        worker_cls = ray_tpu_torch.remote(_ElasticWorker)
        actors: list = []
        try:
            actors = [worker_cls.options(
                num_cpus=res.get("CPU", 1),
                placement_group=pg,
                placement_group_bundle_index=i).remote()
                for i in range(n)]
            self._live_actors = actors
            inband = None if ckpt_ref is not None else ckpt_state
            return ray_tpu_torch.get(
                [a.run.remote(fn_bytes, self._config, i, n, group,
                              shards[i], ckpt_ref, inband,
                              persist_key, journal_key)
                 for i, a in enumerate(actors)],
                timeout=timeout)
        finally:
            self._live_actors = []
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:   # noqa: BLE001 — already dead
                    pass

"""Live rollout controller: roll a new weight version across a running
deployment with zero accepted-request loss.

Driver-hosted, like the rest of the serve control plane (the
``_Controller`` actors and router registry live in the driver
process); every phase transition is journaled through
:class:`~ray_tpu_torch.versioning.registry.VersionRegistry` into the
GCS-snapshotted KV, so the head, the CLI and the dashboard observe the
rollout — and a standby promotion inherits the journal.

Flip discipline per replica (the retire-loaner two-step, generalized):

1. ``begin_flip`` — the controller pulls the replica out of the
   routing set (version bump: shards stop dispatching to it) but keeps
   it alive to finish in-flight work.
2. drain — poll the replica shell's live call count to zero, bounded
   by ``rollout_flip_drain_timeout_s`` (the cap is at most
   ``max_ongoing_requests`` calls deep).
3. ``_reload`` — swap weights (broadcast-staged ObjectRef resolves to
   a replica-local copy) and run the verification probe.
4. ``commit_flip`` — re-enter routing under the new version tag; or
   ``cancel_flip`` back to the old tag on probe failure, which trips a
   rollback of every replica already flipped.

Failure trips: verification-probe failure, replica death mid-flip
(tolerated — the dead replica simply leaves the set; the rollout
continues) and an SLO regression (the deployment's p99/latency EWMA
exceeding ``rollout_slo_factor`` x the pre-rollout baseline).
"""

from __future__ import annotations

import threading

from ..common import clock as _clk
from ..common.config import get_config
from . import phases
from .registry import VersionRegistry

__all__ = ["RolloutController", "rollout", "rollout_status",
           "pause_rollout", "resume_rollout", "abort_rollout"]

# retained artifact refs (weights kept for rollback until seal trims
# them): (deployment, version) -> ObjectRef.  Driver-process registry,
# like serve's _apps table.
_ARTIFACTS: dict = {}
_ARTIFACTS_LOCK = threading.Lock()


def _retain(deployment: str, version: str, ref) -> None:
    with _ARTIFACTS_LOCK:
        _ARTIFACTS[(deployment, version)] = ref


def _retained(deployment: str, version: str):
    with _ARTIFACTS_LOCK:
        return _ARTIFACTS.get((deployment, version))


def _trim_retained(deployment: str, keep: list[str]) -> None:
    with _ARTIFACTS_LOCK:
        for key in [k for k in _ARTIFACTS
                    if k[0] == deployment and k[1] not in keep]:
            _ARTIFACTS.pop(key, None)


class RolloutController:
    """One rollout of ``artifact`` over the app named ``app_name``."""

    def __init__(self, artifact: bytes, app_name: str = "default",
                 artifact_label: str = "", probe=None):
        self._artifact = artifact
        self._app_name = app_name
        self._label = artifact_label or f"artifact-{len(artifact)}B"
        self._probe = probe
        self._registry = VersionRegistry()
        self._flipped: list[str] = []   # key_hex, flip order
        self.max_flip_downtime_s = 0.0

    # -- plumbing ------------------------------------------------------------
    def _running(self):
        from ..serve.deployment import _apps, _apps_lock
        with _apps_lock:
            running = _apps.get(self._app_name)
        if running is None:
            raise KeyError(f"no running serve app {self._app_name!r}")
        return running

    @staticmethod
    def _key(handle) -> str:
        return handle._actor_id.binary().hex()

    def _lat_ewma(self, kv_base: str) -> float:
        from ..experimental.internal_kv import _internal_kv_get
        raw = _internal_kv_get(f"lat-{kv_base}".encode(),
                               namespace="serve")
        try:
            return float(raw) if raw else 0.0
        except ValueError:
            return 0.0

    def _control(self, dep: str) -> str:
        return self._registry.control(dep)

    # -- the state machine ---------------------------------------------------
    def run(self) -> dict:
        import ray_tpu_torch
        from ..api import _get_runtime

        cfg = get_config()
        running = self._running()
        ctl = running.controller
        dep = running.deployment.name
        reg = self._registry
        t0 = _clk.monotonic()

        rec = reg.stage(dep, self._label)
        ro = rec["rollout"]
        old, new = ro["from"], ro["to"]

        # STAGING: pin the new weights in the object store
        ref = ray_tpu_torch.put(self._artifact)
        _retain(dep, new, ref)

        # BROADCASTING: stream 1->N down the bandwidth-derated tree
        # while the old version keeps serving.  Degradation (a member
        # falling back to a striped pull) is not failure — _reload's
        # get() resolves from the nearest replica either way.
        reg.set_phase(dep, phases.BROADCASTING)
        try:
            summary = _get_runtime().cluster.broadcasts.broadcast(ref)
            reg.set_phase(dep, phases.BROADCASTING,
                          broadcast=summary.get("reached", 0))
        except Exception:   # noqa: BLE001 — single-node/test topology
            pass

        _ver, reps, _kv_key, info = ray_tpu_torch.get(
            ctl.get_replicas.remote(), timeout=60)
        n_loaners = int(info.get("loaners", 0))
        targets = reps[:len(reps) - n_loaners] if n_loaners else reps
        baseline_lat = self._lat_ewma(info["base"])
        reg.set_phase(dep, phases.FLIPPING, replicas=len(targets))
        ray_tpu_torch.get(ctl.set_rollout_active.remote(True), timeout=30)

        error = ""
        try:
            for i, handle in enumerate(targets):
                hold = self._hold_for_operator(dep)
                if hold == "abort":
                    error = "aborted by operator"
                    break
                if not self._flip_one(ctl, handle, ref, new, cfg):
                    error = f"verification probe failed on replica {i}"
                    break
                self._flipped.append(self._key(handle))
                reg.set_phase(dep, phases.FLIPPING, flipped=i + 1)
                lat = self._lat_ewma(info["base"])
                if baseline_lat > 0.0 and \
                        lat > cfg.rollout_slo_factor * baseline_lat:
                    error = (f"SLO trip: latency EWMA {lat:.1f}ms > "
                             f"{cfg.rollout_slo_factor}x baseline "
                             f"{baseline_lat:.1f}ms")
                    break
        except Exception as e:  # noqa: BLE001 — journal, then roll back
            error = f"{type(e).__name__}: {e}"

        if error:
            self._roll_back(ctl, dep, old, cfg)
            rec = reg.rollback(dep, error)
        else:
            rec = reg.seal(dep)
            ray_tpu_torch.get(ctl.set_model_version.remote(new), timeout=30)
            _trim_retained(dep, rec["retained"])
        ray_tpu_torch.get(ctl.set_rollout_active.remote(False), timeout=30)
        ro = rec["rollout"]
        return {
            "deployment": dep, "from": old, "to": new,
            "phase": ro["phase"], "flipped": ro["flipped"],
            "replicas": ro["replicas"], "error": ro["error"],
            "max_flip_downtime_s": round(self.max_flip_downtime_s, 4),
            "seconds": round(_clk.monotonic() - t0, 4),
        }

    def _hold_for_operator(self, dep: str) -> str:
        """Between flips: honor the pause/abort control flag the CLI
        writes through the head."""
        flag = self._control(dep)
        if flag == "pause":
            self._registry.set_phase(dep, phases.PAUSED)
            while flag == "pause":
                _clk.sleep(0.2)
                flag = self._control(dep)
            if flag != "abort":
                self._registry.set_phase(dep, phases.FLIPPING)
        return flag

    def _flip_one(self, ctl, handle, ref, version: str, cfg) -> bool:
        """One replica through the drain->reload->probe->commit cycle.
        Returns False only on probe failure; a replica that died is
        dropped and does not fail the rollout (the set just shrinks,
        exactly as under any other death)."""
        import ray_tpu_torch
        from ..actor_api import ActorMethod
        key = self._key(handle)
        t_out = _clk.monotonic()
        if not ray_tpu_torch.get(ctl.begin_flip.remote(key), timeout=30):
            return True         # already gone (death, downscale)
        deadline = _clk.monotonic() + cfg.rollout_flip_drain_timeout_s
        try:
            while _clk.monotonic() < deadline:
                active = ray_tpu_torch.get(
                    ActorMethod(handle, "_active_count").remote(),
                    timeout=10)
                if active == 0:
                    break
                _clk.sleep(0.02)
            res = ray_tpu_torch.get(
                ActorMethod(handle, "_reload").remote(ref, version),
                timeout=cfg.rollout_probe_timeout_s +
                cfg.rollout_flip_drain_timeout_s)
        except Exception:   # noqa: BLE001 — replica died mid-flip
            ray_tpu_torch.get(ctl.cancel_flip.remote(key, True), timeout=30)
            return True
        ok = bool(res.get("ok"))
        if ok and self._probe is not None:
            try:
                ok = bool(self._probe(handle))
            except Exception:   # noqa: BLE001 — probe raised: failed
                ok = False
        if ok:
            ray_tpu_torch.get(ctl.commit_flip.remote(key, version),
                        timeout=30)
            self.max_flip_downtime_s = max(
                self.max_flip_downtime_s, _clk.monotonic() - t_out)
        else:
            ray_tpu_torch.get(ctl.cancel_flip.remote(key, False), timeout=30)
        return ok

    def _roll_back(self, ctl, dep: str, old: str, cfg) -> None:
        """Re-flip every already-flipped replica to the retained old
        version.  With no retained old artifact (the initial deploy
        never staged one) the re-flip only re-tags — user state is the
        deploy-time weights already."""
        import ray_tpu_torch
        from ..actor_api import ActorMethod
        old_ref = _retained(dep, old)
        for key in reversed(self._flipped):
            try:
                if not ray_tpu_torch.get(ctl.begin_flip.remote(key),
                                   timeout=30):
                    continue
                handles = ray_tpu_torch.get(ctl.flipping_handles.remote(),
                                      timeout=30)
                handle = next((h for h in handles
                               if self._key(h) == key), None)
                if handle is None:
                    continue
                deadline = _clk.monotonic() + \
                    cfg.rollout_flip_drain_timeout_s
                while _clk.monotonic() < deadline:
                    if ray_tpu_torch.get(
                            ActorMethod(handle,
                                        "_active_count").remote(),
                            timeout=10) == 0:
                        break
                    _clk.sleep(0.02)
                ray_tpu_torch.get(ActorMethod(handle, "_reload").remote(
                    old_ref, old),
                    timeout=cfg.rollout_probe_timeout_s +
                    cfg.rollout_flip_drain_timeout_s)
                ray_tpu_torch.get(ctl.commit_flip.remote(key, old),
                            timeout=30)
            except Exception:   # noqa: BLE001 — replica died: drop it
                try:
                    ray_tpu_torch.get(ctl.cancel_flip.remote(key, True),
                                timeout=30)
                except Exception:   # noqa: BLE001
                    pass


# -- module-level convenience (the public serve-adjacent API) ----------------

def rollout(artifact: bytes, app_name: str = "default",
            artifact_label: str = "", probe=None) -> dict:
    """Roll ``artifact`` across the running app; blocks until SEALED
    or ROLLED_BACK and returns the summary."""
    return RolloutController(artifact, app_name=app_name,
                             artifact_label=artifact_label,
                             probe=probe).run()


def rollout_status(deployment: str | None = None) -> dict:
    reg = VersionRegistry()
    if deployment is not None:
        rec = reg.record(deployment)
        return rec if rec is not None else {}
    return reg.all()


def pause_rollout(deployment: str) -> None:
    VersionRegistry().set_control(deployment, "pause")


def resume_rollout(deployment: str) -> None:
    VersionRegistry().set_control(deployment, "")


def abort_rollout(deployment: str) -> None:
    VersionRegistry().set_control(deployment, "abort")

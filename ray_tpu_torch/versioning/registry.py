"""Head-owned version registry, journaled into the GCS-snapshotted KV.

One JSON record per deployment under the ``version`` KV namespace
(``ver-<deployment>``).  Every mutation is a read-modify-write through
the internal KV — which lives head-side and rides the head's periodic
GCS snapshot — so the version table survives head restarts and standby
promotion without any machinery of its own: promotion restores the
same KV.  The registry is deliberately stateless (no in-memory cache):
a promoted head, a CLI process and the driver all read the same
journal.

A second key per deployment (``ctl-<deployment>``) carries the
operator control flag (``pause``/``abort``) the live
:class:`~ray_tpu_torch.versioning.rollout.RolloutController` polls between
flips — the channel ``ray_tpu_torch rollout --pause/--resume/--abort``
writes through the head RPC.
"""

from __future__ import annotations

import json

from ..common import clock as _clk
from ..common.config import get_config
from . import phases

_NS = "version"
_VER_PREFIX = "ver-"
_CTL_PREFIX = "ctl-"


def _kv():
    from ..experimental import internal_kv
    return internal_kv


class VersionRegistry:
    """CRUD + state-machine guard over the per-deployment journal."""

    # -- raw journal access --------------------------------------------------
    def record(self, deployment: str) -> dict | None:
        raw = _kv()._internal_kv_get(_VER_PREFIX + deployment,
                                     namespace=_NS)
        if not raw:
            return None
        return json.loads(raw.decode())

    def _save(self, deployment: str, rec: dict) -> None:
        _kv()._internal_kv_put(
            _VER_PREFIX + deployment,
            json.dumps(rec, sort_keys=True).encode(), namespace=_NS)

    def all(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for key in _kv()._internal_kv_list(_VER_PREFIX.encode(),
                                           namespace=_NS):
            name = key.decode()[len(_VER_PREFIX):]
            rec = self.record(name)
            if rec is not None:
                out[name] = rec
        return out

    # -- lifecycle -----------------------------------------------------------
    def ensure(self, deployment: str,
               artifact: str = "initial") -> dict:
        """Idempotently registers a deployment at ``v1``."""
        rec = self.record(deployment)
        if rec is not None:
            return rec
        rec = {
            "deployment": deployment,
            "current": "v1",
            "previous": None,
            "seq": 1,
            "artifacts": {"v1": artifact},
            "retained": ["v1"],
            "history": [{"version": "v1", "artifact": artifact,
                         "t": _clk.now()}],
            "rollout": None,
        }
        self._save(deployment, rec)
        return rec

    def stage(self, deployment: str, artifact: str) -> dict:
        """Allocate the next version and journal a STAGING rollout.
        Refuses while another rollout is active: version waves may run
        concurrently across deployments, never within one."""
        rec = self.ensure(deployment)
        ro = rec.get("rollout")
        if ro is not None and ro["phase"] not in phases.TERMINAL:
            raise RuntimeError(
                f"rollout {ro['id']} for {deployment!r} still "
                f"{ro['phase']}; one rollout per deployment at a time")
        rec["seq"] += 1
        new = f"v{rec['seq']}"
        now = _clk.now()
        rec["artifacts"][new] = artifact
        rec["rollout"] = {
            "id": f"{deployment}:{new}",
            "from": rec["current"],
            "to": new,
            "artifact": artifact,
            "phase": phases.STAGING,
            "flipped": 0,
            "replicas": 0,
            "t_start": now,
            "t_phase": now,
            "error": "",
            "transitions": [[phases.STAGING, now]],
        }
        # the old version's artifact stays retained until seal — the
        # rollback path re-flips onto it
        if rec["current"] not in rec["retained"]:
            rec["retained"].append(rec["current"])
        self._save(deployment, rec)
        self.set_control(deployment, "")    # clear stale pause/abort
        return rec

    def set_phase(self, deployment: str, phase: str, **fields) -> dict:
        rec = self.record(deployment)
        if rec is None or rec.get("rollout") is None:
            raise RuntimeError(f"no rollout journaled for {deployment!r}")
        ro = rec["rollout"]
        if phase != ro["phase"]:
            if phase not in phases.NEXT.get(ro["phase"], ()):
                raise RuntimeError(
                    f"illegal rollout transition {ro['phase']} -> "
                    f"{phase} for {deployment!r}")
            ro["phase"] = phase
            ro["t_phase"] = _clk.now()
            ro["transitions"].append([phase, ro["t_phase"]])
        ro.update(fields)
        self._save(deployment, rec)
        return rec

    def seal(self, deployment: str) -> dict:
        """Flip the table: the rollout's target becomes current, and
        retained artifacts trim to ``version_retain_count`` (the sealed
        old version drops out once past the retention window)."""
        rec = self.set_phase(deployment, phases.SEALED)
        ro = rec["rollout"]
        rec["previous"] = rec["current"]
        rec["current"] = ro["to"]
        rec["history"].append({"version": ro["to"],
                               "artifact": ro["artifact"],
                               "t": _clk.now()})
        keep = max(int(get_config().version_retain_count), 1)
        retained = [v for v in rec["retained"] if v != ro["to"]]
        retained.append(ro["to"])
        rec["retained"] = retained[-keep:]
        self._save(deployment, rec)
        return rec

    def rollback(self, deployment: str, error: str) -> dict:
        """Journal the failure; ``current`` never moved, so the old
        version simply stays authoritative."""
        return self.set_phase(deployment, phases.ROLLED_BACK,
                              error=error)

    def current(self, deployment: str) -> str:
        rec = self.record(deployment)
        return rec["current"] if rec else "v1"

    # -- operator control channel -------------------------------------------
    def control(self, deployment: str) -> str:
        raw = _kv()._internal_kv_get(_CTL_PREFIX + deployment,
                                     namespace=_NS)
        return raw.decode() if raw else ""

    def set_control(self, deployment: str, flag: str) -> None:
        if flag not in ("", "pause", "abort"):
            raise ValueError(f"unknown rollout control flag {flag!r}")
        _kv()._internal_kv_put(_CTL_PREFIX + deployment, flag.encode(),
                               namespace=_NS)

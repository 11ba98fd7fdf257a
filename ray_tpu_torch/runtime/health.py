"""Automatic failure detection: the GCS health-check manager.

Reference parity: ``GcsHealthCheckManager`` (``src/ray/gcs/gcs_server/
gcs_health_check_manager.cc``) pings every registered raylet on
``health_check_period_ms``; after ``health_check_failure_threshold``
consecutive missed checks the node is declared dead and drained
(SURVEY.md §5.3; mount empty).

In-process adaptation: a node is declared DEAD on structural failure —
its scheduling thread died or its worker pool is wiped out (all
processes dead and respawn broken) — for ``threshold`` consecutive
probes, then drained via ``cluster.remove_node``.  Event-loop
responsiveness (pong answered since our previous ping) and data-plane
reachability (an OPEN circuit breaker on the node's object-plane
address — see ``rpc/breaker.py``) are tracked and surfaced as
``suspect``, mirrored into the CRM so placement rounds soft-avoid the
node, but are deliberately NOT fatal: a loop
blocked 40 s in a first jit compile is indistinguishable in-process from
a wedged one, and upstream only gets hang-detection for free because a
hung raylet process also stops answering its RPC thread.  The head node
is monitored but never removed (its death is fatal upstream too — the
GCS lives there).
"""

from __future__ import annotations

import threading

from ..common.config import get_config
from ..common import clock as _clk


class HealthCheckManager:
    def __init__(self, cluster):
        cfg = get_config()
        self._cluster = cluster
        self._period = cfg.health_check_period_ms / 1000.0
        self._threshold = cfg.health_check_failure_threshold
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        # NodeID -> {"misses": int, "pinged_at": float | None,
        #            "suspect": bool}
        self._state: dict = {}
        self.num_detected = 0
        self.num_quarantined = 0    # rows currently breaker-quarantined

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="health-check")
            self._thread.start()

    def shutdown(self) -> None:
        """Stop AND join: an in-flight round emitting events or removing
        nodes must not race cluster teardown (it could recreate the
        just-deleted session dir through the event log's lazy open)."""
        self._stop = True
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=self._period)
            if self._stop:
                return
            try:
                self.check_once()
            except Exception:   # noqa: BLE001 — monitor must survive
                import traceback
                traceback.print_exc()

    def quarantined_rows(self) -> set[int]:
        """Rows whose object-plane address currently has an OPEN circuit
        breaker (computed live from the rpc breaker registry: repeated
        transfer failures to a node quarantine it here even while its
        control-plane vitals look fine — the classic gray failure)."""
        from ..rpc import breaker as _breaker
        open_addrs = _breaker.open_peers()
        if not open_addrs:
            return set()
        return {row for row, addr in self._cluster.planes.items()
                if addr is not None and addr in open_addrs}

    def suspect_nodes(self) -> list:
        """NodeIDs currently flagged suspect (loop-lag or quarantine)."""
        return [nid for nid, st in self._state.items() if st["suspect"]]

    def check_once(self) -> list:
        """One probe round.  Returns nodes declared dead this round
        (tests call this directly for determinism)."""
        cluster = self._cluster
        declared = []
        quarantined = self.quarantined_rows()
        self.num_quarantined = len(quarantined)
        for row, raylet in list(cluster.raylets.items()):
            nid = raylet.node_id
            st = self._state.setdefault(
                nid, {"misses": 0, "pinged_at": None, "suspect": False})
            vitals = raylet.health_vitals()
            st["suspect"] = (st["pinged_at"] is not None and
                            vitals["last_pong"] < st["pinged_at"]) or \
                row in quarantined
            # mirror into the CRM so scheduling rounds soft-avoid the
            # row (advisory: snapshot() never masks suspect nodes)
            cluster.crm.set_suspect(row, bool(st["suspect"]))
            if vitals["thread_alive"] and vitals["workers_alive"]:
                st["misses"] = 0
            else:
                st["misses"] += 1
                if st["misses"] >= self._threshold:
                    if row == cluster._head_row:
                        # head death is fatal upstream; keep flagging only
                        continue
                    self.num_detected += 1
                    declared.append(nid)
                    self._state.pop(nid, None)
                    cluster.events.emit(
                        "health", "node_declared_dead", node_row=row,
                        node_id=nid.hex(), misses=st["misses"])
                    try:
                        cluster.remove_node(nid)
                    except ValueError:
                        pass        # raced with a manual/autoscaler removal
                    continue
            st["pinged_at"] = _clk.monotonic()
            raylet.ping()
        # forget departed nodes
        live = {r.node_id for r in cluster.raylets.values()}
        for nid in [n for n in self._state if n not in live]:
            del self._state[nid]
        # serve-plane piggyback: router load digests fold onto the
        # gossip board on the same beat that carries node liveness (no
        # extra RPC), and the capacity-loan state machine advances —
        # including the node-death loss booking for LOANED rows
        try:
            from ..serve.gossip import fold_all
            fold_all()
        except Exception:   # noqa: BLE001 — gossip is best-effort
            pass
        loans = getattr(cluster, "loans", None)
        if loans is not None:
            try:
                loans.tick()
            except Exception:   # noqa: BLE001 — monitor must survive
                import traceback
                traceback.print_exc()
        return declared

    def stats(self) -> dict:
        return {"num_detected": self.num_detected,
                "num_monitored": len(self._state),
                "num_suspect": sum(s["suspect"]
                                   for s in self._state.values()),
                "num_quarantined": self.num_quarantined}

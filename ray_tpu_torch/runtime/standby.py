"""Hot-standby head: sub-heartbeat control-plane failover.

A follower process armed next to the primary head.  It tails nothing
in-band — the primary already persists the whole GCS metadata plane
(job table, KV incl. the lease-epoch journal, fn registry) to
``persist_path`` every 2 s — so the standby's job is *detection* and
*promotion*:

- **detection** — probe the primary's ``ping`` every
  ``standby_probe_interval_s``.  Agents that lose their head link cast
  head-down votes here (``NodeAgent._vote_standby``), so the quorum
  signal arrives within one RPC-close, not one probe period.
- **promotion** — after ``standby_probe_misses`` consecutive failed
  probes, or ONE failed probe plus at least one agent vote, re-probe
  once (split-brain guard: a vote from a partitioned agent must not
  promote over a live primary) and then boot a full :class:`HeadNode`
  on the primary's host:port from the persisted snapshot.

Outstanding leases survive the promotion: grant authority already
lives at the raylets (``ray_tpu_torch/leasing/``), and the promoted head
restores the revocation-epoch journal from the snapshot's KV plane
(``AgentHub._restore_epochs``), so it never re-issues an epoch the
dead head revoked.  Agents running with ``--reconnect-timeout``
re-register through their retry loop and re-lease their classes on
the first sync.

State machine::

    STANDBY --probe ok--------------------------> STANDBY (reset)
    STANDBY --miss (n >= misses OR n>=1 + vote)--> CONFIRMING
    CONFIRMING --re-probe ok--------------------> STANDBY (reset)
    CONFIRMING --re-probe fails-----------------> PROMOTING
    PROMOTING --HeadNode up---------------------> PRIMARY (terminal)
    PROMOTING --bind/boot fails-----------------> STANDBY (retry)
"""

from __future__ import annotations

import logging
import threading

from ..common import clock as _clk

_LOG = logging.getLogger("ray_tpu_torch.standby")

__all__ = ["StandbyHead"]


class StandbyHead:
    """Armed follower; becomes a :class:`HeadNode` on primary death."""

    def __init__(self, head_address: str, host: str = "127.0.0.1",
                 port: int = 0, persist_path: str | None = None,
                 resources: dict | None = None,
                 num_workers: int | None = None):
        from ..common.config import get_config
        from ..rpc import transport as _transport
        cfg = get_config()
        self._head_address = head_address
        self._persist_path = persist_path
        self._resources = resources
        self._num_workers = num_workers
        self._probe_interval = max(
            float(cfg.standby_probe_interval_s), 0.05)
        self._probe_misses = max(int(cfg.standby_probe_misses), 1)
        self._misses = 0
        self._votes: set[str] = set()
        self._first_miss_t: float | None = None
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self.role = "standby"
        self.promotions = 0
        self.failover_ms: list[float] = []
        self.head = None            # the promoted HeadNode, if any
        self.server = _transport.serve({
            "ping": lambda: "standby",
            "standby_vote": self._vote,
            "standby_status": self.status,
            "stop_daemon": self._stop_async,
        }, host=host, port=port).start()
        from ..leasing import register_stats
        register_stats("standby", self.status)
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="standby-probe")
        self._probe_thread.start()

    @property
    def address(self) -> str:
        return self.server.address

    # -- quorum input --------------------------------------------------------
    def _vote(self, voter: str = "") -> bool:
        """An agent lost its head link.  Votes count only against the
        CURRENT outage window — every successful probe clears them, so
        a stale vote from a flapping agent cannot promote later."""
        with self._lock:
            self._votes.add(str(voter) or f"anon{len(self._votes)}")
            if self._first_miss_t is None:
                self._first_miss_t = _clk.monotonic()
        return True

    def status(self) -> dict:
        with self._lock:
            return {"role": self.role, "promotions": self.promotions,
                    "failover_ms": list(self.failover_ms),
                    "probe_misses": self._misses,
                    "votes": len(self._votes),
                    "head_address": self._head_address}

    # -- detection -----------------------------------------------------------
    def _probe_once(self) -> bool:
        from ..rpc import transport as _transport
        client = None
        try:
            client = _transport.connect(self._head_address)
            return client.call(
                "ping", timeout=min(self._probe_interval * 2, 5.0)) \
                is not None
        except Exception:   # noqa: BLE001 — unreachable == miss
            return False
        finally:
            if client is not None:
                try:
                    client.close()
                except Exception:   # noqa: BLE001
                    pass

    def _probe_loop(self) -> None:
        while not self._stop_event.wait(self._probe_interval):
            if self.role != "standby":
                return
            ok = self._probe_once()
            with self._lock:
                if ok:
                    self._misses = 0
                    self._votes.clear()
                    self._first_miss_t = None
                    continue
                self._misses += 1
                if self._first_miss_t is None:
                    self._first_miss_t = _clk.monotonic()
                promote = self._misses >= self._probe_misses or \
                    (self._misses >= 1 and self._votes)
            if promote:
                # split-brain guard: one more probe — an agent vote
                # during an asymmetric partition that only isolates
                # some agents must not promote over a live primary
                if self._probe_once():
                    with self._lock:
                        self._misses = 0
                        self._votes.clear()
                        self._first_miss_t = None
                    continue
                if self._promote():
                    return

    # -- promotion -----------------------------------------------------------
    def _promote(self) -> bool:
        """Boot a full head on the primary's host:port from the
        persisted snapshot.  ``HeadNode.__init__`` restores the GCS
        plane and re-runs interrupted jobs once the control surface is
        up; agents find the SAME address through their reconnect
        loops, so no client reconfiguration is needed."""
        from .head import HeadNode
        host, _, port_s = self._head_address.rpartition(":")
        with self._lock:
            t0 = self._first_miss_t or _clk.monotonic()
        try:
            head = HeadNode(resources=self._resources,
                            num_workers=self._num_workers,
                            host=host or "127.0.0.1",
                            port=int(port_s),
                            persist_path=self._persist_path)
        except Exception:   # noqa: BLE001 — bind/boot failed (port
            # still draining, snapshot unreadable): stay standby, the
            # next probe window retries the whole decision
            _LOG.exception("standby promotion failed; re-arming")
            with self._lock:
                self._misses = 0
                self._votes.clear()
                self._first_miss_t = None
            return False
        ms = round((_clk.monotonic() - t0) * 1000.0, 1)
        with self._lock:
            self.head = head
            self.role = "primary"
            self.promotions += 1
            self.failover_ms.append(ms)
        _LOG.warning("standby promoted to primary at %s "
                     "(failover %.0f ms)", head.address, ms)
        return True

    # -- lifecycle -----------------------------------------------------------
    def wait_for_shutdown(self, timeout: float | None = None) -> bool:
        return self._stop_event.wait(timeout)

    def _stop_async(self) -> str:
        # delay past the reply flush, as head.py's stop_daemon does
        timer = threading.Timer(0.2, self.stop)
        timer.daemon = True
        timer.start()
        return "stopping"

    def stop(self) -> None:
        self._stop_event.set()
        from ..leasing import unregister_stats
        unregister_stats("standby")
        head = self.head
        if head is not None:
            try:
                head.stop()
            except Exception:   # noqa: BLE001 — best-effort teardown
                pass
        self.server.stop()

"""Per-peer circuit breakers for the RPC client (gray-failure defense).

Reference parity: upstream's retryable gRPC clients back off a channel
that keeps failing, and the GCS health-check manager marks nodes it
cannot reach; the circuit-breaker form (closed → open → half-open) is
the standard shape for not hammering a peer that is timing out while
still probing for recovery.

Every ``RpcClient`` *records* call outcomes here (cheap dict updates
keyed by peer address), so the registry is a process-wide map of link
health regardless of which subsystem owns the connection.  *Enforcement*
(failing fast while a breaker is open) is opt-in per client
(``RpcClient(breaker=True)``): the data plane's peer connections use
it, while control transports with their own reconnect loops (the node
agent's head link) keep their existing semantics and only feed the
registry.

State machine per peer:

- CLOSED: normal; ``failure_threshold`` CONSECUTIVE failures open it.
- OPEN: calls fail fast with ``CircuitOpenError``; after ``reset_s``
  the next ``allow()`` admits exactly one probe (half-open).
- HALF_OPEN: the probe's success closes the breaker; its failure
  reopens it (and restarts the cooldown clock).

The registry feeds ``HealthCheckManager``: a node whose data-plane
address has an open breaker is *quarantined* — surfaced as ``suspect``,
soft-avoided by the scheduler, and demoted by the serve router.
"""

from __future__ import annotations

import threading

from ..common import clock as _clk
from .client import RpcConnectionError

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitOpenError(RpcConnectionError):
    """Fail-fast refusal: the peer's breaker is open (recent consecutive
    failures; a half-open probe will test recovery after the cooldown)."""


class PeerBreaker:
    __slots__ = ("addr", "threshold", "reset_s", "state", "failures",
                 "opened_at", "probing", "opens", "lock")

    def __init__(self, addr: str, threshold: int, reset_s: float):
        self.addr = addr
        self.threshold = max(1, int(threshold))
        self.reset_s = float(reset_s)
        self.state = CLOSED
        self.failures = 0           # consecutive
        self.opened_at = 0.0
        self.probing = False
        self.opens = 0              # cumulative open transitions
        self.lock = threading.Lock()

    def allow(self) -> bool:
        """True if a call may proceed.  While OPEN, admits exactly one
        half-open probe per cooldown expiry."""
        with self.lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if _clk.monotonic() - self.opened_at >= self.reset_s:
                    self.state = HALF_OPEN
                    self.probing = True
                    return True
                return False
            # HALF_OPEN: one probe at a time
            if self.probing:
                return False
            self.probing = True
            return True

    def record_success(self) -> None:
        with self.lock:
            self.state = CLOSED
            self.failures = 0
            self.probing = False

    def record_failure(self) -> None:
        with self.lock:
            if self.state == HALF_OPEN:
                # failed probe: straight back to OPEN, clock restarted
                self.state = OPEN
                self.opened_at = _clk.monotonic()
                self.probing = False
                self.opens += 1
                return
            self.failures += 1
            if self.state == CLOSED and self.failures >= self.threshold:
                self.state = OPEN
                self.opened_at = _clk.monotonic()
                self.opens += 1

    def snapshot(self) -> dict:
        with self.lock:
            return {"state": self.state, "failures": self.failures,
                    "opens": self.opens,
                    "open_for_s": (round(_clk.monotonic() - self.opened_at, 3)
                                   if self.state == OPEN else 0.0)}


# -- process-global registry -------------------------------------------------
_lock = threading.Lock()
_breakers: dict[str, PeerBreaker] = {}


def breaker_for(addr: str) -> PeerBreaker:
    b = _breakers.get(addr)
    if b is None:
        from ..common.config import get_config
        cfg = get_config()
        with _lock:
            b = _breakers.get(addr)
            if b is None:
                if len(_breakers) > 2048:   # ephemeral-port hygiene
                    for k in [k for k, v in _breakers.items()
                              if v.state == CLOSED and v.failures == 0]:
                        del _breakers[k]
                b = _breakers[addr] = PeerBreaker(
                    addr, cfg.rpc_breaker_failure_threshold,
                    cfg.rpc_breaker_reset_s)
    return b


def record_success(addr: str) -> None:
    b = _breakers.get(addr)
    if b is not None:
        b.record_success()


def record_failure(addr: str) -> None:
    breaker_for(addr).record_failure()


def is_open(addr: str) -> bool:
    b = _breakers.get(addr)
    return b is not None and b.state == OPEN


def open_peers() -> set:
    """Addresses whose breaker is currently OPEN (the quarantine feed
    for ``HealthCheckManager``)."""
    return {a for a, b in list(_breakers.items()) if b.state == OPEN}


def stats() -> dict:
    """Non-trivial breakers only (ever-opened or currently failing)."""
    return {a: b.snapshot() for a, b in list(_breakers.items())
            if b.opens or b.failures or b.state != CLOSED}


def reset_registry() -> None:
    """Forget every breaker (tests; a fresh cluster in-process)."""
    with _lock:
        _breakers.clear()

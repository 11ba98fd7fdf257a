"""Clock seam: real vs. virtual (event-driven) time for the control plane.

Reference parity: upstream hardwires ``absl::Now()``/``std::chrono``
throughout the GCS and raylet, which is exactly why its fault-tolerance
logic can only be exercised against wall-clock test clusters.  Routing
every control-plane timestamp, timeout and sleep through one seam is
what lets the in-process simulator (``ray_tpu_torch/sim/``) run the same
state machines under a virtual clock: 10k nodes' worth of heartbeats,
lease deadlines and breaker cooldowns advance event-by-event with no
sockets and no wall-clock sleeps, deterministically.

Two implementations:

- ``RealClock`` — delegates to ``time.time/monotonic/sleep``; installed
  by default, so production behavior is byte-identical to calling the
  ``time`` module directly.
- ``VirtualClock`` — a discrete-event scheduler.  ``monotonic()`` is a
  number the owner advances; ``sleep(s)`` moves virtual time forward and
  fires due timers in deterministic ``(time, seq)`` order.  Strictly
  single-threaded by design: determinism is the point, and the simulator
  is the only intended owner.

Call sites in ``ray_tpu_torch/runtime/`` and ``ray_tpu_torch/rpc/`` use the
module-level helpers (``now()``, ``monotonic()``, ``sleep()``) so the
seam is one import and zero indirection to read.  rtlint rule W5 flags
control-plane code that bypasses it.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time

__all__ = ["Clock", "RealClock", "VirtualClock", "get_clock", "install",
           "uninstall", "installed_virtual", "now", "monotonic", "sleep"]


class Clock:
    """The seam.  ``time()`` is wall-ish epoch time (timestamps in logs
    and persisted records), ``monotonic()`` is for deadlines/intervals,
    ``sleep()`` blocks (really or virtually)."""

    def time(self) -> float:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    """Production clock: the ``time`` module, untouched."""

    time = staticmethod(_time.time)
    monotonic = staticmethod(_time.monotonic)
    sleep = staticmethod(_time.sleep)


class VirtualClock(Clock):
    """Deterministic discrete-event clock for the simulator.

    Events are ``(fire_time, seq, callback)`` on a heap; ``seq`` breaks
    time ties in schedule order, so replays are bit-for-bit.  Callbacks
    may schedule further events and may call ``sleep()`` (which recurses
    into ``advance``); time only moves forward.
    """

    def __init__(self, start: float = 0.0, epoch: float = 1.7e9):
        self._now = float(start)
        self._epoch = float(epoch)          # time() = epoch + monotonic
        self._heap: list = []               # (t, seq, callback or None)
        self._seq = itertools.count()
        self.fired = 0                      # events dispatched (stats)

    # -- Clock interface -----------------------------------------------------
    def time(self) -> float:
        return self._epoch + self._now

    def monotonic(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        """Virtual sleep: advance time, firing timers that come due."""
        self.advance(max(0.0, float(seconds)))

    # -- event scheduling ----------------------------------------------------
    def call_later(self, delay: float, fn) -> list:
        """Schedule ``fn()`` at ``now + delay``.  Returns a cancellable
        handle (mutate ``handle[2] = None`` via :meth:`cancel`)."""
        entry = [self._now + max(0.0, float(delay)), next(self._seq), fn]
        heapq.heappush(self._heap, entry)
        return entry

    def cancel(self, handle: list) -> None:
        handle[2] = None        # tombstone; popped lazily

    def pending(self) -> int:
        return sum(1 for e in self._heap if e[2] is not None)

    def next_event_time(self) -> float | None:
        while self._heap and self._heap[0][2] is None:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def advance(self, dt: float) -> int:
        """Move time forward by ``dt``, dispatching due events in
        deterministic order.  Returns the number fired."""
        return self.run_until(self._now + max(0.0, float(dt)))

    def run_until(self, t: float) -> int:
        """Dispatch every event scheduled at or before ``t``; leaves
        ``monotonic() == max(t, now)``."""
        fired = 0
        while self._heap and self._heap[0][0] <= t:
            when, _, fn = heapq.heappop(self._heap)
            if fn is None:
                continue
            if when > self._now:
                self._now = when
            fired += 1
            self.fired += 1
            fn()
        if t > self._now:
            self._now = t
        return fired

    def run_until_idle(self, max_time: float | None = None) -> int:
        """Drain the heap (up to ``max_time``), the quiesce primitive
        invariant checks rely on."""
        fired = 0
        while True:
            nxt = self.next_event_time()
            if nxt is None or (max_time is not None and nxt > max_time):
                return fired
            fired += self.run_until(nxt)


# -- process-global install (same shape as chaos._active) --------------------
_default = RealClock()
_active: Clock = _default


def get_clock() -> Clock:
    return _active


def install(clock: Clock) -> Clock:
    """Swap the process clock (the simulator installs a VirtualClock
    for the duration of a campaign).  Returns the installed clock."""
    global _active
    _active = clock
    return clock


def uninstall() -> None:
    global _active
    _active = _default


def installed_virtual() -> bool:
    return isinstance(_active, VirtualClock)


# -- the helpers control-plane code imports ----------------------------------
def now() -> float:
    """Epoch-ish timestamp (``time.time`` under the real clock)."""
    return _active.time()


def monotonic() -> float:
    return _active.monotonic()


def sleep(seconds: float) -> None:
    _active.sleep(seconds)

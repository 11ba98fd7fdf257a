"""Deterministic network-chaos plane: seeded fault injection in the RPC layer.

Real cluster fabrics fail *gray* — dropped frames, tail latency,
asymmetric partitions — and gray failures are only debuggable when the
injected fault sequence is reproducible.  This module is the injection
point: a process-global chaos configuration consulted by the RPC client
(both directions), the RPC server (reply path), and the wire layer
(bandwidth pacing).  All hooks are a single module-attribute None-check
when chaos is off, so the data path pays ~nothing in production.

Determinism convention (same as ``scheduling/policy.py``): every link
gets its own pinned Philox stream, keyed by ``(seed, sha256(link))``,
and draws a fixed number of uniforms per message.  Message order *per
link* is the socket write order, so a single-threaded caller replays
bit-for-bit: the same seed reproduces the exact injected-fault trace
(``trace()``), which tests assert on.

Fault vocabulary, per message:

- **drop** — the frame is silently not sent (request) or discarded
  after receive (reply): the gray loss a retry/timeout must absorb.
- **dup** — the frame is sent twice with the same req_id (the client
  demux drops the second reply; handlers see the request twice — the
  at-least-once delivery idempotent methods must tolerate).
- **delay** — sleep ``delay_ms * (0.5 + u)`` before the send/dispatch
  (tail-latency jitter).
- **partition** ``A ↛ B`` — directed: messages toward ``dst`` are
  dropped at the sending client when ``dst`` matches the peer address
  (and ``src`` matches this process's ``identity``, default wildcard);
  a partition with ``src`` = a server's own address and ``dst='*'``
  drops that server's replies (requests arrive, answers vanish — the
  classic asymmetric gray failure).
- **bandwidth cap** — per-connection token pacing in the wire layer.

Links are named ``out:<peer>`` (requests we send to ``peer``),
``in:<peer>`` (replies we receive from ``peer``), and ``srv:<self>``
(replies a server at ``self`` sends).  Scoping is by peer address:
``links={addr: {...}}`` overrides the global probabilities for one
peer.

Control surfaces: ``Config``/env (``RT_CHAOS_*``, read once at first
RPC construction), the ``ray_tpu_torch chaos`` CLI subcommand, and the head's
``chaos`` RPC (``control()`` is the single dispatch all three share),
so tests can partition a live cluster and heal it mid-run.
"""

from __future__ import annotations

import hashlib
import threading

from ..common import clock as _clk

__all__ = ["configure", "disable", "add_partition", "heal", "trace",
           "reset_trace", "status", "control", "active", "is_enabled",
           "ensure_env_init"]

# process-global chaos state; None == off (the fast path every hook
# checks before doing anything else)
_active = None
_install_lock = threading.Lock()
_env_inited = False

_TRACE_CAP = 20000          # per-link trace bound (memory safety)
_ACTIONS = ("drop", "dup")


def active():
    """The live ``_Chaos`` instance or None.  Hooks read this once per
    message; the None-check IS the disabled fast path."""
    return _active


def is_enabled() -> bool:
    return _active is not None


class _Link:
    """One directed link's pinned Philox stream + message counter +
    fault trace.  Keyed by (seed, sha256(link name)) so the stream is a
    pure function of the seed and the link — thread interleaving across
    links cannot perturb any single link's draw sequence."""

    __slots__ = ("rng", "n", "trace", "lock")

    def __init__(self, seed: int, name: str):
        import numpy as np
        digest = hashlib.sha256(name.encode()).digest()
        k0 = int.from_bytes(digest[:8], "big")
        k1 = int.from_bytes(digest[8:16], "big") ^ (seed & (2**64 - 1))
        self.rng = np.random.Generator(np.random.Philox(key=[k0, k1]))
        self.n = 0              # messages decided on this link
        self.trace: list = []   # (msg_index, action) injected faults
        self.lock = threading.Lock()


class _Params:
    __slots__ = ("drop_p", "dup_p", "delay_p", "delay_ms")

    def __init__(self, drop_p=0.0, dup_p=0.0, delay_p=0.0, delay_ms=0.0):
        self.drop_p = float(drop_p)
        self.dup_p = float(dup_p)
        self.delay_p = float(delay_p)
        self.delay_ms = float(delay_ms)


class _Chaos:
    def __init__(self, seed: int = 0, drop_p: float = 0.0,
                 dup_p: float = 0.0, delay_p: float = 0.0,
                 delay_ms: float = 0.0, bandwidth_mbps: float = 0.0,
                 links: dict | None = None, identity: str = "*"):
        self.seed = int(seed)
        self.defaults = _Params(drop_p, dup_p, delay_p, delay_ms)
        self.bandwidth_mbps = float(bandwidth_mbps)
        # peer address -> _Params override (scoped per-link knobs)
        self.links = {a: _Params(**d) for a, d in (links or {}).items()}
        self.identity = identity or "*"
        # directed partitions: set of (src, dst); "*" wildcards
        self.partitions: set = set()
        self._streams: dict = {}
        self._streams_lock = threading.Lock()
        # bandwidth pacing: per-socket next-free-time accounting
        self._pace_lock = threading.Lock()
        self._pace_next: dict = {}
        # counters
        self.num_dropped = 0
        self.num_duplicated = 0
        self.num_delayed = 0
        self.num_partitioned = 0

    # -- decisions -----------------------------------------------------------
    def _params_for(self, addr: str) -> _Params:
        return self.links.get(addr, self.defaults)

    def _link(self, name: str) -> _Link:
        # Double-checked lazy init: the unlocked probe is a benign race
        # (dict get is atomic; losers re-check under _streams_lock).
        link = self._streams.get(name)  # rtlint: disable=W7
        if link is None:
            with self._streams_lock:
                link = self._streams.get(name)
                if link is None:
                    link = self._streams[name] = _Link(self.seed, name)
        return link

    def _keys_snapshot(self) -> list:
        with self._streams_lock:
            return list(self._streams)

    def _partitioned(self, src: str, dst: str) -> bool:
        # Existential match over the set: the answer is the same
        # whatever order the pairs come out in, and nothing else in the
        # loop draws or traces.
        for a, b in self.partitions:  # rtlint: disable=W8
            if (a == "*" or a == src) and (b == "*" or b == dst):
                return True
        return False

    def _decide(self, link_name: str, addr: str) -> str | None:
        """One seeded decision: returns "drop"/"dup"/None and sleeps the
        delay (if drawn) before returning.  A FIXED number of draws per
        message keeps the stream aligned across replays regardless of
        which faults fire."""
        p = self._params_for(addr)
        link = self._link(link_name)
        with link.lock:
            n = link.n
            link.n += 1
            u = link.rng.random(4)
            action = None
            if u[0] < p.drop_p:
                action = "drop"
            elif u[1] < p.dup_p:
                action = "dup"
            delay = 0.0
            if p.delay_ms > 0 and u[2] < p.delay_p:
                delay = p.delay_ms * (0.5 + float(u[3])) / 1000.0
            if (action or delay) and len(link.trace) < _TRACE_CAP:
                tag = action or ""
                if delay:
                    tag = (tag + "+" if tag else "") + \
                        f"delay:{delay * 1000:.3f}"
                link.trace.append((n, tag))
        # Deliberately-racy monotonic gauges: a lost increment only
        # undercounts diagnostics; the replayed fault schedule itself is
        # carried by the per-link Philox stream, not these counters.
        if action == "drop":
            self.num_dropped += 1  # rtlint: disable=W7
        elif action == "dup":
            self.num_duplicated += 1  # rtlint: disable=W7
        if delay:
            self.num_delayed += 1  # rtlint: disable=W7
            _clk.sleep(delay)
        return action

    def send_action(self, peer: str) -> str | None:
        """Client -> server request leg (link ``out:<peer>``)."""
        if self._partitioned(self.identity, peer):
            self.num_partitioned += 1  # rtlint: disable=W7 — monotonic gauge
            link = self._link(f"out:{peer}")
            with link.lock:
                n = link.n
                link.n += 1
                if len(link.trace) < _TRACE_CAP:
                    link.trace.append((n, "part"))
            return "drop"
        return self._decide(f"out:{peer}", peer)

    def recv_action(self, peer: str) -> str | None:
        """Server -> client reply leg, decided at the receiving client
        (link ``in:<peer>``).  "dup" is meaningless here (the demux
        drops unsolicited replies) — treat it as None."""
        act = self._decide(f"in:{peer}", peer)
        return act if act == "drop" else None

    def reply_action(self, self_addr: str) -> str | None:
        """Server reply leg, decided at the sending server (link
        ``srv:<self>``): how an asymmetric partition (requests arrive,
        replies vanish) is injected."""
        if self._partitioned(self_addr, "*"):
            self.num_partitioned += 1  # rtlint: disable=W7 — monotonic gauge
            link = self._link(f"srv:{self_addr}")
            with link.lock:
                n = link.n
                link.n += 1
                if len(link.trace) < _TRACE_CAP:
                    link.trace.append((n, "part"))
            return "drop"
        return self._decide(f"srv:{self_addr}", self_addr)

    def link_action(self, src: str, dst: str) -> str | None:
        """Virtual-link leg for the in-process simulator: one seeded
        decision on directed link ``src->dst``.  Same Philox keying and
        fixed draw count as the socket legs, so a simulated campaign's
        drop/dup/delay schedule replays bit-for-bit from the seed.
        Per-peer ``links`` overrides and directed partitions key by
        ``dst`` / ``(src, dst)`` exactly like the socket path."""
        if self._partitioned(src, dst):
            self.num_partitioned += 1  # rtlint: disable=W7 — monotonic gauge
            link = self._link(f"{src}->{dst}")
            with link.lock:
                n = link.n
                link.n += 1
                if len(link.trace) < _TRACE_CAP:
                    link.trace.append((n, "part"))
            return "drop"
        return self._decide(f"{src}->{dst}", dst)

    # -- bandwidth pacing (wire seam) ----------------------------------------
    def pace(self, sock, nbytes: int) -> None:
        """Token pacing per connection: sending ``nbytes`` reserves
        ``nbytes / rate`` seconds of the link; a send finding the link
        busy sleeps until its reservation starts."""
        rate = self.bandwidth_mbps * 1e6 / 8.0      # bytes/sec
        if rate <= 0 or nbytes <= 0:
            return
        # Process-local pacing key only: never traced, never hashed
        # into the schedule; id() is just a cheap per-connection handle.
        key = id(sock)  # rtlint: disable=W8
        now = _clk.monotonic()
        with self._pace_lock:
            if len(self._pace_next) > 512:          # bound stale entries
                self._pace_next = {k: v for k, v in
                                   self._pace_next.items() if v > now}
            start = max(now, self._pace_next.get(key, 0.0))
            self._pace_next[key] = start + nbytes / rate
        if start > now:
            _clk.sleep(start - now)

    # -- introspection -------------------------------------------------------
    def trace(self) -> dict:
        with self._streams_lock:
            return {name: list(link.trace)
                    for name, link in self._streams.items() if link.trace}

    def reset_trace(self) -> None:
        """Drop streams AND traces: the next message on every link
        replays from draw 0 (how tests assert seed-reproducibility)."""
        with self._streams_lock:
            self._streams.clear()

    def status(self) -> dict:
        d = self.defaults
        return {
            "enabled": True,
            "seed": self.seed,
            "drop_p": d.drop_p,
            "dup_p": d.dup_p,
            "delay_p": d.delay_p,
            "delay_ms": d.delay_ms,
            "bandwidth_mbps": self.bandwidth_mbps,
            "identity": self.identity,
            "partitions": sorted(self.partitions),
            "links": sorted(self._keys_snapshot()),
            "num_dropped": self.num_dropped,
            "num_duplicated": self.num_duplicated,
            "num_delayed": self.num_delayed,
            "num_partitioned": self.num_partitioned,
        }


# -- module-level control ----------------------------------------------------
def _install(chaos) -> None:
    global _active
    from . import wire
    with _install_lock:
        _active = chaos
        wire._chaos_pacer = chaos.pace if chaos is not None else None


def configure(seed: int = 0, drop_p: float = 0.0, dup_p: float = 0.0,
              delay_p: float = 0.0, delay_ms: float = 0.0,
              bandwidth_mbps: float = 0.0, links: dict | None = None,
              identity: str = "*") -> dict:
    """Install a fresh chaos configuration (replacing any previous one;
    streams restart from draw 0).  Returns ``status()``."""
    chaos = _Chaos(seed=seed, drop_p=drop_p, dup_p=dup_p,
                   delay_p=delay_p, delay_ms=delay_ms,
                   bandwidth_mbps=bandwidth_mbps, links=links,
                   identity=identity)
    _install(chaos)
    return chaos.status()


def disable() -> dict:
    _install(None)
    return {"enabled": False}


def add_partition(src: str = "*", dst: str = "*") -> dict:
    """Directed partition ``src ↛ dst`` (addresses or "*").  Installs a
    default (fault-free) config first if chaos is off, so a partition
    alone needs no probabilities."""
    ch = _active
    if ch is None:
        configure()
        ch = _active
    ch.partitions.add((src, dst))
    return ch.status()


def heal(src: str | None = None, dst: str | None = None) -> dict:
    """Remove matching partitions (all of them when src and dst are
    both None)."""
    ch = _active
    if ch is None:
        return {"enabled": False}
    if src is None and dst is None:
        ch.partitions.clear()
    else:
        ch.partitions = {(a, b) for a, b in ch.partitions
                         if not ((src is None or a == src) and
                                 (dst is None or b == dst))}
    return ch.status()


def trace() -> dict:
    ch = _active
    return ch.trace() if ch is not None else {}


def reset_trace() -> None:
    ch = _active
    if ch is not None:
        ch.reset_trace()


def status() -> dict:
    ch = _active
    return ch.status() if ch is not None else {"enabled": False}


def control(op: str, **kwargs) -> dict:
    """Single dispatch shared by the head RPC and the CLI:
    ``set`` (configure), ``partition``, ``heal``, ``status``,
    ``trace``, ``reset_trace``, ``off``."""
    if op == "set":
        return configure(**kwargs)
    if op == "partition":
        return add_partition(kwargs.get("src", "*"),
                             kwargs.get("dst", "*"))
    if op == "heal":
        return heal(kwargs.get("src"), kwargs.get("dst"))
    if op == "status":
        return status()
    if op == "trace":
        return {"trace": trace()}
    if op == "reset_trace":
        reset_trace()
        return {"ok": True}
    if op == "off":
        return disable()
    raise ValueError(f"unknown chaos op {op!r}")


def ensure_env_init() -> None:
    """One-time config/env activation (``RT_CHAOS_ENABLED=1`` + the
    ``chaos_*`` knobs), checked lazily at first RPC endpoint creation
    so the common no-chaos path costs one global bool test."""
    global _env_inited
    if _env_inited:
        return
    _env_inited = True
    try:
        from ..common.config import get_config
        cfg = get_config()
    except Exception:   # noqa: BLE001 — config unavailable: stay off
        return
    if getattr(cfg, "chaos_enabled", False):
        configure(seed=cfg.chaos_seed, drop_p=cfg.chaos_drop_p,
                  dup_p=cfg.chaos_dup_p, delay_p=cfg.chaos_delay_p,
                  delay_ms=cfg.chaos_delay_ms,
                  bandwidth_mbps=cfg.chaos_bandwidth_mbps)

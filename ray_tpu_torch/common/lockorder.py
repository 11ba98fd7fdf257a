"""Runtime lock-order recorder — the dynamic half of rtlint's W2.

Static analysis (``tools/rtlint`` rule W2) infers the acquires-while-
holding digraph lexically; it cannot see cross-object nesting (object A
holding its lock while calling into object B which takes its own).
This module records the REAL acquisition order: ``install()`` replaces
``threading.Lock``/``threading.RLock`` with factories returning
instrumented wrappers that maintain a per-thread held-stack and add an
edge ``H -> L`` for every lock H held at the moment L is acquired.

Lock identity is the ALLOCATION SITE (``file:line`` of the constructor
call), so all instances created by one class's ``__init__`` collapse
into one graph node — the same granularity rtlint's static ids have.
Same-site self-edges (two instances of the same class nested) are
recorded under ``self_edges()`` but excluded from the cycle check:
statically indistinguishable, and commonly an ordered-by-address or
ordered-by-role pattern.

Gated by the ``rtlint_runtime_lock_order`` config knob (or the
``RT_RTLINT_RUNTIME_LOCK_ORDER`` env var before ``Config`` init, like
any knob): the chaos/drain suites run with it enabled and assert
``find_cycle() is None`` after every test — static analysis proposes,
the chaos plane disposes.

Overhead when installed is one thread-local list append per acquire and
a set-add per NEW edge; when not installed, zero (the stdlib factories
are untouched).
"""

from __future__ import annotations

import threading
import traceback

_real_lock = threading.Lock
_real_rlock = threading.RLock

_installed = False
_state_lock = _real_lock()
# edge -> (src_site, dst_site) observed count; witness kept for the first
_edges: dict[tuple[str, str], int] = {}
_witness: dict[tuple[str, str], str] = {}
_self_edges: dict[str, int] = {}
_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _alloc_site() -> str:
    """file:line of the code that called threading.Lock()/RLock():
    the innermost stack frame outside this module."""
    stack = traceback.extract_stack()
    for fr in reversed(stack):
        if fr.filename != __file__:
            fn = fr.filename
            # keep paths readable: trim to the package-relative tail
            for marker in ("ray_tpu_torch/", "site-packages/", "lib/python"):
                i = fn.rfind(marker)
                if i >= 0:
                    fn = fn[i:]
                    break
            return f"{fn}:{fr.lineno}"
    return "<unknown>"


def _record_acquire(site: str) -> None:
    held = _held()
    if held:
        new_edges = []
        for h in held:
            if h == site:
                with _state_lock:
                    _self_edges[site] = _self_edges.get(site, 0) + 1
                continue
            new_edges.append((h, site))
        if new_edges:
            with _state_lock:
                for e in new_edges:
                    if e not in _edges:
                        _edges[e] = 0
                        _witness[e] = _thread_tag()
                    _edges[e] += 1
    held.append(site)


def _record_release(site: str) -> None:
    held = _held()
    # locks can release out of LIFO order; remove the most recent match
    for i in range(len(held) - 1, -1, -1):
        if held[i] == site:
            del held[i]
            return


def _thread_tag() -> str:
    t = threading.current_thread()
    return t.name


class _TrackedLock:
    """Wraps a real (R)Lock; records acquisition-order edges.

    Implements the full lock protocol plus the private hooks
    ``threading.Condition`` uses (``_release_save`` etc.) so a tracked
    lock can back a Condition without the bookkeeping going stale.
    """

    __slots__ = ("_inner", "_site")

    def __init__(self, inner, site):
        self._inner = inner
        self._site = site

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _record_acquire(self._site)
        return got

    def release(self):
        self._inner.release()
        _record_release(self._site)

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # -- Condition integration (cpython threading.Condition duck-typing) --
    def _release_save(self):
        # Condition.wait: fully release (even reentrant holds)
        state = getattr(self._inner, "_release_save", None)
        _record_release(self._site)
        if state is not None:
            return state()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        restore = getattr(self._inner, "_acquire_restore", None)
        if restore is not None:
            restore(state)
        else:
            self._inner.acquire()
        _record_acquire(self._site)

    def _is_owned(self):
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        # plain Lock heuristic (what Condition itself does)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _at_fork_reinit(self):
        # the stdlib registers this for its module-level locks (e.g.
        # concurrent.futures.thread at import), so a lock built while
        # recording must answer it like the lock it wraps
        self._inner._at_fork_reinit()

    def __repr__(self):
        return f"<TrackedLock {self._site} of {self._inner!r}>"


class _TrackedRLock(_TrackedLock):
    """Reentrant variant: re-acquisition by the owner records no edge
    (it cannot deadlock against anything new)."""

    __slots__ = ("_count",)

    def __init__(self, inner, site):
        super().__init__(inner, site)
        self._count = threading.local()

    def _depth(self):
        return getattr(self._count, "n", 0)

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            if self._depth() == 0:
                _record_acquire(self._site)
            self._count.n = self._depth() + 1
        return got

    def release(self):
        self._inner.release()
        self._count.n = max(0, self._depth() - 1)
        if self._depth() == 0:
            _record_release(self._site)

    def _release_save(self):
        state = self._inner._release_save()
        _record_release(self._site)
        n, self._count.n = self._depth(), 0
        return (state, n)

    def _acquire_restore(self, state):
        inner_state, n = state
        self._inner._acquire_restore(inner_state)
        self._count.n = n
        _record_acquire(self._site)

    def _is_owned(self):
        return self._inner._is_owned()

    def _recursion_count(self):
        # multiprocessing's resource tracker asks its RLock this on every
        # spawn (Python 3.12); a tracker built while recording holds ours
        return self._inner._recursion_count()


def _lock_factory():
    return _TrackedLock(_real_lock(), _alloc_site())


def _rlock_factory():
    return _TrackedRLock(_real_rlock(), _alloc_site())


# -- public API --------------------------------------------------------------

def install() -> None:
    """Start tracking: locks constructed AFTER this call are recorded.
    Idempotent."""
    global _installed
    if _installed:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True


def uninstall() -> None:
    """Restore the stdlib factories (existing tracked locks keep
    working — they only stop being created)."""
    global _installed
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    """Drop the recorded graph (not the installation)."""
    with _state_lock:
        _edges.clear()
        _witness.clear()
        _self_edges.clear()


def edges() -> dict[tuple[str, str], int]:
    with _state_lock:
        return dict(_edges)


def self_edges() -> dict[str, int]:
    with _state_lock:
        return dict(_self_edges)


def graph() -> dict[str, set[str]]:
    adj: dict[str, set[str]] = {}
    for (a, b) in edges():
        adj.setdefault(a, set()).add(b)
    return adj


def find_cycle() -> list[str] | None:
    """First lock-order cycle in the observed graph, or None."""
    adj = graph()
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    stack: list[str] = []
    out: list[list[str]] = []

    def dfs(n):
        color[n] = GRAY
        stack.append(n)
        for m in sorted(adj.get(n, ())):
            if out:
                break
            c = color.get(m, WHITE)
            if c == WHITE:
                dfs(m)
            elif c == GRAY:
                out.append(stack[stack.index(m):] + [m])
        stack.pop()
        color[n] = BLACK

    for n in sorted(adj):
        if not out and color[n] == WHITE:
            dfs(n)
    return out[0] if out else None


def assert_acyclic() -> None:
    cyc = find_cycle()
    if cyc is not None:
        w = [f"{a} -> {b} (first seen on thread {_witness.get((a, b), '?')})"
             for a, b in zip(cyc, cyc[1:])]
        raise AssertionError(
            "runtime lock-order cycle observed:\n  " + "\n  ".join(w))


def maybe_install_from_config() -> bool:
    """Install iff the ``rtlint_runtime_lock_order`` knob is on.
    Returns whether tracking is installed after the call."""
    from .config import get_config
    if getattr(get_config(), "rtlint_runtime_lock_order", False):
        install()
    return _installed

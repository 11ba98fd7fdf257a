"""Runtime lockset recorder — the dynamic half of rtlint's W7.

Static lockset analysis (``tools/rtlint`` rule W7) infers which locks
guard which ``self._attr`` writes lexically; it cannot see attributes
reached through duck-typed callbacks, monkeypatched methods, or test
fixtures wiring objects together at runtime.  This module records the
REAL locksets, Eraser-style: classes opt in with the
:func:`track` decorator, and under :func:`install` every tracked
instance gets its lock attributes wrapped in recording proxies that
maintain a per-thread held-set.  Each write to a tracked attribute then
samples ``(thread, held locks)``; per ``(instance, attr)`` the recorder
intersects the locksets across writers, and an attribute written by ≥2
threads whose running intersection is empty is a violation.

``__init__`` writes are excluded by construction (instances are only
marked "born" — eligible for sampling — after their constructor
returns), so the assign-once immutable-publish pattern stays quiet,
exactly like W7's static escape.

Gated by the ``rtlint_runtime_locksets`` config knob (or the
``RT_RTLINT_RUNTIME_LOCKSETS`` env var before ``Config`` init): the
chaos/drain suites run with it enabled and a conftest fixture asserts
:func:`assert_no_races` after every test — static analysis proposes,
the chaos plane disposes (same contract as ``lockorder.py`` for W2).

Overhead when installed is one thread-local dict op per lock
acquire/release and one sample per tracked-attribute write; when not
installed, zero (``track`` only records the class in a registry).
"""

from __future__ import annotations

import itertools
import threading

_registry: list[tuple[type, tuple[str, ...]]] = []
_originals: dict[type, tuple] = {}
_installed = False
_state_lock = threading.Lock()
_tls = threading.local()
_thread_ids = itertools.count(1)

# born instances: sampled only after __init__ returned.  Keyed by id()
# (some tracked classes may not be weakref-able); entries are dropped
# on reset(), which every per-test fixture calls.
_born: set[int] = set()

# (id(obj), attr) -> {"cls", "threads": set, "lockset": set|None,
#                     "writes": int}
_access: dict[tuple[int, str], dict] = {}
_violations: list[str] = []
_violated: set[tuple[str, str]] = set()     # (cls_name, attr) dedup


def _thread_id() -> int:
    """The current thread's id for the recorder.  Unlike
    ``threading.get_ident()`` it is never handed to a later thread: an
    ident is recycled once its thread exits, so two threads that ran one
    after the other would count as one writer."""
    tid = getattr(_tls, "tid", None)
    if tid is None:
        tid = _tls.tid = next(_thread_ids)
    return tid


def _held() -> dict:
    """token -> acquire depth for the current thread."""
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = {}
    return h


def _token(inner) -> int:
    """Lock identity: a Condition and the Lock backing it must count as
    ONE lock (threading.Condition keeps it in ``_lock``)."""
    backing = getattr(inner, "_lock", None)
    return id(backing if backing is not None else inner)


class _RecLock:
    """Wraps a Lock/RLock/Condition; maintains the per-thread held-set.

    Reentrant acquires nest via a depth count, so the token stays held
    until the outermost release.  Everything beyond the acquire/release
    protocol (``wait``, ``notify``, ...) delegates to the inner object —
    a thread blocked in ``Condition.wait`` takes no samples, so the
    transient release inside it needs no bookkeeping.
    """

    __slots__ = ("_inner", "_tok")

    def __init__(self, inner):
        self._inner = inner
        self._tok = _token(inner)

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            held = _held()
            held[self._tok] = held.get(self._tok, 0) + 1
        return got

    def release(self):
        self._inner.release()
        held = _held()
        n = held.get(self._tok, 0) - 1
        if n > 0:
            held[self._tok] = n
        else:
            held.pop(self._tok, None)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<RecLock {self._inner!r}>"


def _is_lockish(v) -> bool:
    return hasattr(v, "acquire") and hasattr(v, "release") and \
        not isinstance(v, _RecLock)


def _sample_write(obj, attr) -> None:
    key = (id(obj), attr)
    held = frozenset(_held())
    tid = _thread_id()
    cls_name = type(obj).__name__
    with _state_lock:
        st = _access.get(key)
        if st is None:
            st = _access[key] = {"cls": cls_name, "threads": set(),
                                 "lockset": None, "writes": 0}
        st["threads"].add(tid)
        st["writes"] += 1
        st["lockset"] = set(held) if st["lockset"] is None else \
            (st["lockset"] & held)
        if len(st["threads"]) >= 2 and not st["lockset"]:
            vkey = (cls_name, attr)
            if vkey not in _violated:
                _violated.add(vkey)
                _violations.append(
                    f"{cls_name}.{attr}: written from "
                    f"{len(st['threads'])} threads with empty lockset "
                    f"intersection ({st['writes']} writes sampled; "
                    f"thread {threading.current_thread().name} wrote "
                    f"holding "
                    f"{'no lock' if not held else f'{len(held)} lock(s)'})")


def track(*attrs: str):
    """Class decorator: opt the class's listed attributes into runtime
    lockset sampling.  Free when the recorder is not installed."""

    def deco(cls):
        _registry.append((cls, tuple(attrs)))
        if _installed:
            _instrument(cls, tuple(attrs))
        return cls

    return deco


def _instrument(cls, attrs: tuple[str, ...]) -> None:
    if cls in _originals:
        return
    orig_init = cls.__dict__.get("__init__")
    orig_setattr = cls.__dict__.get("__setattr__")
    _originals[cls] = (orig_init, orig_setattr)
    real_init = cls.__init__          # resolved through the MRO,
    real_setattr = cls.__setattr__    # captured before patching
    tracked = frozenset(attrs)

    def __init__(self, *a, **kw):
        real_init(self, *a, **kw)
        # wrap the instance's locks so its methods record held-sets
        for name, v in list(vars(self).items()):
            if _is_lockish(v):
                object.__setattr__(self, name, _RecLock(v))
        with _state_lock:
            _born.add(id(self))

    def __setattr__(self, name, value):
        if name in tracked and id(self) in _born:
            _sample_write(self, name)
        real_setattr(self, name, value)

    cls.__init__ = __init__
    cls.__setattr__ = __setattr__


def _deinstrument(cls) -> None:
    orig_init, orig_setattr = _originals.pop(cls)
    if orig_init is None:
        del cls.__init__
    else:
        cls.__init__ = orig_init
    if orig_setattr is None:
        del cls.__setattr__
    else:
        cls.__setattr__ = orig_setattr


# -- public API --------------------------------------------------------------

def install() -> None:
    """Start recording: tracked classes are instrumented, and instances
    constructed AFTER this call are sampled.  Idempotent."""
    global _installed
    if _installed:
        return
    _installed = True
    for cls, attrs in _registry:
        _instrument(cls, attrs)


def uninstall() -> None:
    """Restore the original class methods and stop sampling."""
    global _installed
    if not _installed:
        return
    for cls in list(_originals):
        _deinstrument(cls)
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    """Drop recorded samples and violations (not the installation)."""
    with _state_lock:
        _access.clear()
        _violations.clear()
        _violated.clear()
        _born.clear()


def violations() -> list[str]:
    with _state_lock:
        return list(_violations)


def assert_no_races() -> None:
    v = violations()
    if v:
        raise AssertionError(
            "runtime lockset violation (empty-lockset shared write):\n  "
            + "\n  ".join(v))


def maybe_install_from_config() -> bool:
    """Install iff the ``rtlint_runtime_locksets`` knob is on.  Returns
    whether recording is installed after the call."""
    from .config import get_config
    if getattr(get_config(), "rtlint_runtime_locksets", False):
        install()
    return _installed

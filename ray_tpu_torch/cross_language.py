"""Cross-language export registry.

Reference parity: the reference's multi-language frontends call Python
code by *descriptor* (module/function name), not by pickled closure —
``ray.cross_language`` + the function descriptors in
``src/ray/common/function_descriptor.h`` (SURVEY.md §1 layer 8; mount
empty).  Here Python code opts functions and actor classes into the
cross-language surface by exporting them under a stable name; the
C++ frontend (``cpp/``) invokes them through the head daemon's xlang
gateway (``ray_tpu_torch/rpc/xlang_gateway.py``).

    @ray_tpu_torch.cross_language.export("add")
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

Exports are process-global (the gateway runs in the head process, where
the driver registers its exports).  Arguments and return values must stay
inside the cross-language value subset enforced by ``rpc/xlang.py``.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_exports: dict[str, object] = {}


def export(name: str | None = None):
    """Decorator: register a remote function or actor class for
    cross-language callers.  Accepts a plain function/class too and wraps
    it with ``@ray_tpu_torch.remote`` implicitly."""
    def register(obj, export_name: str):
        from .actor_api import ActorClass
        from .api import RemoteFunction, remote
        if not isinstance(obj, (RemoteFunction, ActorClass)):
            wrapped = remote(obj)
        else:
            wrapped = obj
        with _lock:
            existing = _exports.get(export_name)
            if existing is not None and existing is not wrapped \
                    and not _same_descriptor(existing, wrapped):
                raise ValueError(
                    f"cross-language export {export_name!r} already "
                    "registered")
            _exports[export_name] = wrapped
        return wrapped

    if callable(name):          # bare @export with no arguments
        obj, name = name, None
        resolved = _default_name(obj)
        return register(obj, resolved)

    def deco(obj):
        return register(obj, name or _default_name(obj))
    return deco


def _default_name(obj) -> str:
    inner = getattr(obj, "_fn", None) or getattr(obj, "_cls", None) or obj
    return getattr(inner, "__name__", None) or \
        getattr(obj, "_name", None) or repr(obj)


def _same_descriptor(a, b) -> bool:
    """Re-registration of the SAME underlying function/class is
    idempotent: each decorator pass builds a fresh wrapper, so module
    re-import / notebook re-run would otherwise always collide."""
    def descriptor(obj):
        inner = getattr(obj, "_fn", None) or getattr(obj, "_cls", None)
        if inner is None:
            return None
        qn = getattr(inner, "__qualname__", None)
        if qn is None or "<locals>" in qn or "<lambda>" in qn:
            # factory closures / lambdas share a qualname while being
            # genuinely different functions — keep the strict collision
            # guard for them; only module/class-level names (what a
            # re-import recreates) are idempotent
            return None
        return (getattr(inner, "__module__", None), qn)
    da, db = descriptor(a), descriptor(b)
    return da is not None and da == db


def lookup(name: str):
    """The exported RemoteFunction/ActorClass, or None."""
    with _lock:
        return _exports.get(name)


def exports() -> list[str]:
    with _lock:
        return sorted(_exports)


def clear() -> None:
    """Test hook: drop all exports."""
    with _lock:
        _exports.clear()

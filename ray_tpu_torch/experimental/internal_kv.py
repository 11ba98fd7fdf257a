"""The GCS key-value API (namespaced bytes KV).

Reference parity: ``ray.experimental.internal_kv`` —
``_internal_kv_get/put/del/exists/list`` backed by the GCS KV manager,
used for function exports, runtime-env URIs, and library state
(``python/ray/experimental/internal_kv.py`` — SURVEY.md §1 layer 3;
mount empty).  Works from the driver and from inside tasks/actors (the
worker routes through its raylet connection).
"""

from __future__ import annotations

from ..api import _get_runtime


def _kv(op: str, key, value=None, namespace: str | None = None,
        overwrite: bool = True):
    key = key.encode() if isinstance(key, str) else bytes(key)
    if isinstance(value, str):
        value = value.encode()
    ns = namespace or ""
    rt = _get_runtime()
    if getattr(rt, "is_driver", False):
        return rt.cluster.kv.dispatch(op, key, value, ns, overwrite)
    return rt.kv_op(op, key, value, ns, overwrite)


def _internal_kv_initialized() -> bool:
    from .. import api
    return api._runtime is not None


def _internal_kv_put(key, value, overwrite: bool = True,
                     namespace: str | None = None) -> bool:
    """Returns True if the key already existed (reference semantics).
    The exists-check and write are one atomic KVStore.put — a separate
    exists probe would let two put-if-absent racers both write."""
    return bool(_kv("put", key, value, namespace=namespace,
                    overwrite=overwrite))


def _internal_kv_get(key, namespace: str | None = None) -> bytes | None:
    return _kv("get", key, namespace=namespace)


def _internal_kv_exists(key, namespace: str | None = None) -> bool:
    return bool(_kv("exists", key, namespace=namespace))


def _internal_kv_del(key, namespace: str | None = None) -> bool:
    return bool(_kv("del", key, namespace=namespace))


def _internal_kv_list(prefix, namespace: str | None = None) -> list[bytes]:
    return _kv("keys", prefix, namespace=namespace)


def _internal_kv_incr(key, delta: int = 1,
                      namespace: str | None = None) -> int:
    """Atomic counter add; returns the new value."""
    return int(_kv("incr", key, delta, namespace=namespace))

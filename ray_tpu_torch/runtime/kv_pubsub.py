"""GCS key-value store + pubsub channels.

Reference parity: the GCS hosts a namespaced KV table
(``ray.experimental.internal_kv`` — ``src/ray/gcs/gcs_server/
gcs_kv_manager.cc``: Get/Put/Del/Exists/Keys with namespace prefixes,
used for function exports, runtime-env URIs, Serve/Tune state) and a
pubsub broker (``src/ray/pubsub/``: channels with publish/subscribe,
node/actor/job change feeds) — SURVEY.md §1 layer 3; mount empty.

In-process form: one lock-guarded dict per namespace and a
callback/queue-based broker.  Subscribers either register a callback
(push) or poll a bounded per-subscriber queue (pull), matching the two
upstream consumption styles.
"""

from __future__ import annotations

import threading
from collections import deque


class KVStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[tuple[str, bytes], bytes] = {}

    def put(self, key: bytes, value: bytes, namespace: str = "",
            overwrite: bool = True) -> bool:
        """Returns whether the key EXISTED before the call (the
        reference's ``_internal_kv_put`` contract); the exists-check and
        conditional write are one atomic step under the store lock —
        put-if-absent callers (leader keys) rely on that."""
        k = (namespace, bytes(key))
        with self._lock:
            existed = k in self._data
            if overwrite or not existed:
                self._data[k] = bytes(value)
            return existed

    def get(self, key: bytes, namespace: str = "") -> bytes | None:
        with self._lock:
            return self._data.get((namespace, bytes(key)))

    def exists(self, key: bytes, namespace: str = "") -> bool:
        with self._lock:
            return (namespace, bytes(key)) in self._data

    def delete(self, key: bytes, namespace: str = "") -> bool:
        with self._lock:
            return self._data.pop((namespace, bytes(key)), None) is not None

    def incr(self, key: bytes, delta: int = 1,
             namespace: str = "") -> int:
        """Atomic counter add; returns the new value (missing key
        counts from 0).  The GCS-side primitive concurrent clients
        (serve load accounting) need — read-modify-write through
        get/put would lose updates."""
        k = (namespace, bytes(key))
        with self._lock:
            cur = int(self._data.get(k, b"0"))
            cur += int(delta)
            self._data[k] = str(cur).encode()
            return cur

    def keys(self, prefix: bytes = b"", namespace: str = "") -> list[bytes]:
        prefix = bytes(prefix)
        with self._lock:
            return sorted(k for (ns, k) in self._data
                          if ns == namespace and k.startswith(prefix))

    def dispatch(self, op: str, key: bytes, value: bytes | None = None,
                 namespace: str = "", overwrite: bool = True):
        """Single op->method table shared by the driver-side internal_kv
        branch and the raylet's worker frame handler — two hand-rolled
        copies would silently drift (an op added to one side would fall
        into the other's catch-all)."""
        if op == "put":
            return self.put(key, value, namespace, overwrite=overwrite)
        if op == "get":
            return self.get(key, namespace)
        if op == "del":
            return self.delete(key, namespace)
        if op == "exists":
            return self.exists(key, namespace)
        if op == "keys":
            return self.keys(key, namespace)
        if op == "incr":
            return self.incr(key, int(value), namespace)
        raise ValueError(f"unknown kv op {op!r}")

    def snapshot(self) -> dict:
        """Serializable copy (checkpoint/resume support)."""
        with self._lock:
            return dict(self._data)

    def restore(self, data: dict) -> None:
        with self._lock:
            self._data = dict(data)


class _Subscription:
    __slots__ = ("callback", "queue", "_broker", "_channel")

    def __init__(self, broker, channel, callback, maxlen):
        self._broker = broker
        self._channel = channel
        self.callback = callback
        self.queue: deque | None = None if callback else deque(maxlen=maxlen)

    def poll(self) -> list:
        """Drain queued messages (pull-style subscribers)."""
        out = []
        if self.queue is not None:
            while True:
                try:
                    out.append(self.queue.popleft())
                except IndexError:
                    return out
        return out

    def unsubscribe(self) -> None:
        self._broker._remove(self._channel, self)


class PubSub:
    """Named channels; push (callback) or pull (queue) subscribers."""

    QUEUE_MAXLEN = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[str, list[_Subscription]] = {}
        self.num_published = 0

    def subscribe(self, channel: str, callback=None) -> _Subscription:
        sub = _Subscription(self, channel, callback, self.QUEUE_MAXLEN)
        with self._lock:
            self._subs.setdefault(channel, []).append(sub)
        return sub

    def publish(self, channel: str, message) -> int:
        """Deliver to every subscriber; returns the receiver count.
        Callbacks run on the publisher's thread without the broker lock
        (they may re-enter publish/subscribe)."""
        with self._lock:
            subs = list(self._subs.get(channel, ()))
            self.num_published += 1
        for sub in subs:
            if sub.callback is not None:
                try:
                    sub.callback(message)
                except Exception:   # noqa: BLE001 — one bad subscriber
                    import traceback
                    traceback.print_exc()
            else:
                sub.queue.append(message)
        return len(subs)

    def _remove(self, channel: str, sub) -> None:
        with self._lock:
            lst = self._subs.get(channel)
            if lst is not None:
                try:
                    lst.remove(sub)
                except ValueError:
                    pass
                if not lst:
                    del self._subs[channel]

    def stats(self) -> dict:
        with self._lock:
            return {"num_channels": len(self._subs),
                    "num_subscribers": sum(len(v)
                                           for v in self._subs.values()),
                    "num_published": self.num_published}

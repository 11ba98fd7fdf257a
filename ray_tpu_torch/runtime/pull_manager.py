"""PullManager: receiver-driven object transfer with a bandwidth cost model.

Reference parity: upstream's ``PullManager`` (``src/ray/object_manager/
pull_manager.cc``) — pull requests prioritized get > wait > task-arg,
activated under an in-flight memory quota, sources chosen against
per-link cost accounting; ``ObjectManager`` push/pull moves the chunks
(SURVEY.md §1 layer 6, §3.3 — the cost model BASELINE.json's north star
names explicitly; mount empty).

Device-first: source selection for an activation batch is one dense
device computation over the node-bandwidth matrix
(``ops/pull_kernel.py``, on the raylet's device); small batches use
the bit-identical numpy oracle (same backend-switch pattern as the
scheduler, invisible to callers).

The simulated-cluster form (one shared arena, like upstream's
``cluster_utils.Cluster`` on one machine) makes a "transfer" a directory
update + byte accounting, optionally paced by a simulated link rate
(``pull_transfer_sim_gbps``) so quota/backpressure behavior is testable.
"""

from __future__ import annotations

import enum
import heapq
import threading
from collections import deque

import numpy as np

from ..common.config import get_config
from ..common.ids import ObjectID
from ..common import clock as _clk


class PullPriority(enum.IntEnum):
    """Activation order (reference: get > wait > task arg)."""
    GET = 0
    WAIT = 1
    TASK_ARG = 2


class PullManager:
    def __init__(self, cluster):
        self._cluster = cluster
        cfg = get_config()
        self._quota = cfg.pull_manager_max_inflight_mb * (1 << 20)
        self._sim_gbps = cfg.pull_transfer_sim_gbps
        self._device_min = cfg.pull_device_batch_min
        self._n_threads = max(1, cfg.object_transfer_threads)
        self._cv = threading.Condition()
        # pending requests: key (oid, dest_row) -> state dict
        self._requests: dict[tuple, dict] = {}
        self._heap: list = []               # (priority, seq, key)
        self._seq = 0
        self._active: deque = deque()       # (key, src_row) awaiting transfer
        self._inflight_bytes = 0
        # per-SOURCE-row bytes in flight (KB), feeding the cost model's
        # derating input: the fix for concurrent pulls all piling onto
        # the same "cheapest" replica.  Guarded by ``self._cv``.
        self._infl_kb_rows: dict[int, int] = {}
        self._stop = False
        self._threads: list[threading.Thread] = []
        # stats
        self.num_pulls = 0
        self.bytes_pulled = 0
        self.num_failed = 0
        self.device_batches = 0
        self.oracle_batches = 0

    # -- request side --------------------------------------------------------
    def request_pull(self, object_id: ObjectID, size: int, dest_row: int,
                     priority: PullPriority,
                     callback=None) -> bool:
        """Ask for a copy of ``object_id`` at ``dest_row``.  Returns True
        if already satisfied (no pull needed); otherwise queues and later
        invokes ``callback(ok: bool)`` (ok=False when the object is lost).
        Requests for the same (object, dest) coalesce."""
        directory = self._cluster.directory
        if directory.has_location(object_id, dest_row) or \
                not directory.is_tracked(object_id):
            # local already, or not a plasma object (in-band values ship
            # with specs; poisoned/lost entries are in-band errors)
            if callback is not None:
                callback(True)
            return True
        key = (object_id, dest_row)
        with self._cv:
            req = self._requests.get(key)
            if req is not None:
                if callback is not None:
                    req["callbacks"].append(callback)
                # escalate priority if a stronger waiter arrives
                if priority < req["priority"] and not req["active"]:
                    req["priority"] = priority
                    self._seq += 1
                    heapq.heappush(self._heap,
                                   (int(priority), self._seq, key))
                return False
            self._seq += 1
            self._requests[key] = {
                "size": max(int(size), 1),
                "priority": priority,
                "callbacks": [callback] if callback is not None else [],
                "active": False,
            }
            heapq.heappush(self._heap, (int(priority), self._seq, key))
            self._ensure_thread_locked()
            self._activate_locked()
        return False

    def pull_blocking(self, object_ids, dest_row: int,
                      priority: PullPriority, timeout: float | None,
                      store) -> bool:
        """Wait until every object exists AND is local to ``dest_row``
        (pulling as needed).  Lost objects count as done — their poisoned
        in-band error surfaces at the subsequent get.  False on timeout."""
        state = {"left": len(object_ids)}
        done = threading.Event()
        lock = threading.Lock()
        if not object_ids:
            return True

        def one_done(_ok: bool) -> None:
            with lock:
                state["left"] -= 1
                if state["left"] == 0:
                    done.set()

        def on_present(oid):
            from .object_store import PLASMA_KINDS
            kind, size = store.plasma_info(oid)
            if kind in PLASMA_KINDS:
                self.request_pull(oid, size, dest_row, priority,
                                  callback=one_done)
            else:
                one_done(True)

        for oid in object_ids:
            store.on_ready(oid, on_present)
        if done.wait(timeout):
            return True
        # timed out: deregister presence listeners so abandoned gets do
        # not leak closures (or fire phantom pulls later)
        for oid in object_ids:
            store.cancel_on_ready(oid, on_present)
        return False

    # -- activation (quota + source selection) -------------------------------
    def _ensure_thread_locked(self) -> None:
        self._threads = [t for t in self._threads if t.is_alive()]
        while len(self._threads) < self._n_threads:
            t = threading.Thread(
                target=self._transfer_loop, daemon=True,
                name=f"pull-manager-{len(self._threads)}")
            t.start()
            self._threads.append(t)

    def _activate_locked(self) -> None:
        """Move queued requests into the active transfer set while the
        in-flight byte quota allows; pick sources for the whole batch in
        one cost-model evaluation (device kernel for large batches)."""
        batch_keys = []
        while self._heap:
            prio, _seq, key = self._heap[0]
            req = self._requests.get(key)
            if req is None or req["active"] or prio > req["priority"]:
                heapq.heappop(self._heap)       # stale heap entry
                continue
            if self._inflight_bytes + req["size"] > self._quota and \
                    self._inflight_bytes > 0:
                break                           # quota: wait for completions
            heapq.heappop(self._heap)
            req["active"] = True
            self._inflight_bytes += req["size"]
            batch_keys.append(key)
        if not batch_keys:
            return
        srcs = self._choose_sources(batch_keys)
        for key, src in zip(batch_keys, srcs):
            if src < 0:
                # no live copy anywhere: the object is lost
                self._fail_locked(key)
                continue
            src = int(src)
            req = self._requests[key]
            req["src_row"] = src
            self._infl_kb_rows[src] = self._infl_kb_rows.get(src, 0) \
                + max(req["size"] >> 10, 1)
            self._active.append((key, src))
        self._cv.notify_all()

    def _choose_sources(self, keys: list[tuple]) -> np.ndarray:
        """Best source per request via the bandwidth cost model, derated
        by the bytes already in flight FROM each candidate (caller holds
        the lock, so the ledger snapshot is consistent with the batch)."""
        directory = self._cluster.directory
        bw = self._cluster.bandwidth_mbps
        n = bw.shape[0]
        oids = [k[0] for k in keys]
        dest = np.array([k[1] for k in keys], dtype=np.int32)
        sizes_kb = np.array(
            [max(self._requests[k]["size"] >> 10, 1) for k in keys],
            dtype=np.int32)
        loc = directory.location_matrix(oids, n)
        infl = self._inflight_kb_locked(n)
        if len(keys) >= self._device_min:
            from ..ops.pull_kernel import choose_sources_np
            self.device_batches += 1
            src, _cost = choose_sources_np(
                loc, bw, dest, sizes_kb, infl,
                device=self._cluster.scheduler_device)
        else:
            from ..ops.pull_kernel import choose_sources_oracle
            self.oracle_batches += 1
            src, _cost = choose_sources_oracle(loc, bw, dest, sizes_kb,
                                               infl)
        return src

    def _inflight_kb_locked(self, n: int) -> np.ndarray:
        infl = np.zeros(n, dtype=np.int32)
        for row, kb in self._infl_kb_rows.items():
            if 0 <= row < n:
                infl[row] = min(kb, 2**31 - 1)
        return infl

    def inflight_kb(self, n: int) -> np.ndarray:
        """Per-source-row KB in flight — the broadcast coordinator feeds
        this into its fan-out kernel so tree shaping sees pull load."""
        with self._cv:
            return self._inflight_kb_locked(n)

    def _release_src_locked(self, req: dict) -> None:
        """Return an activated request's bytes to its source row's
        in-flight ledger (caller holds the lock)."""
        src = req.pop("src_row", None)
        if src is None:
            return
        left = self._infl_kb_rows.get(src, 0) - max(req["size"] >> 10, 1)
        if left > 0:
            self._infl_kb_rows[src] = left
        else:
            self._infl_kb_rows.pop(src, None)

    def _fail_locked(self, key: tuple) -> None:
        req = self._requests.pop(key, None)
        if req is None:
            return
        if req["active"]:
            self._inflight_bytes -= req["size"]
            self._release_src_locked(req)
        self.num_failed += 1
        cbs = req["callbacks"]
        if cbs:
            # callbacks run without the lock held (they may re-enter)
            threading.Thread(target=lambda: [cb(False) for cb in cbs],
                             daemon=True).start()

    # -- transfer loop -------------------------------------------------------
    def _transfer_loop(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not self._active:
                    self._cv.wait()
                if self._stop:
                    return
                key, src = self._active.popleft()
                # CLAIM the request while still holding the lock: a
                # concurrent on_objects_lost can no longer fail it, so
                # completion happens exactly once
                req = self._requests.pop(key, None)
            if req is None:
                continue
            oid, dest = key
            # the object may have been lost mid-transfer (source node
            # died): a lost object is untracked — do not resurrect it
            ok = self._cluster.directory.is_tracked(oid)
            if ok:
                ok = self._move_bytes(oid, dest, src, req["size"])
                if not ok and self._cluster.directory.is_tracked(oid) \
                        and req.get("attempts", 0) < 2:
                    # transient transfer failure (chunk RPC timeout,
                    # spill race) on a LIVE object: re-queue for another
                    # source-selection round instead of surfacing a
                    # bogus permanent loss to the waiters
                    req["attempts"] = req.get("attempts", 0) + 1
                    _clk.sleep(0.2 * req["attempts"])
                    with self._cv:
                        self._inflight_bytes -= req["size"]
                        self._release_src_locked(req)
                        dup = self._requests.get(key)
                        if dup is not None:
                            # a fresh request for the same key arrived
                            # mid-transfer: merge instead of clobbering
                            dup["callbacks"].extend(req["callbacks"])
                            dup["priority"] = min(dup["priority"],
                                                  req["priority"])
                        else:
                            req["active"] = False
                            self._requests[key] = req
                            self._seq += 1
                            heapq.heappush(
                                self._heap,
                                (int(req["priority"]), self._seq, key))
                        self._activate_locked()
                    continue
            if ok:
                # bytes land BEFORE the directory update: a callback
                # (task dispatch, get) must never observe a location
                # whose plane cannot serve the object yet
                self._cluster.directory.add_location(oid, dest)
            with self._cv:
                self._inflight_bytes -= req["size"]
                self._release_src_locked(req)
                if ok:
                    self.num_pulls += 1
                    self.bytes_pulled += req["size"]
                else:
                    self.num_failed += 1
                self._activate_locked()
            for cb in req["callbacks"]:
                cb(ok)

    def _move_bytes(self, oid, dest: int, src: int, size: int) -> bool:
        """Execute one transfer.  Simulated rows share the head arena
        (the transfer is a directory update, optionally paced); rows
        with a plane address move real chunks arena-to-arena — payload
        bytes flow source→destination directly, never through here.

        Beyond the cost-model-chosen primary ``src``, every OTHER
        directory replica's plane address rides along: the destination
        plane stripes chunk ranges across them (and fails over within
        the transfer when the primary dies mid-stripe)."""
        # an ACTIVE broadcast of this object grafts the pull onto the
        # relay tree (one leaf join) instead of opening an independent
        # stream against the cost model's favorite replica
        broadcasts = getattr(self._cluster, "broadcasts", None)
        if broadcasts is not None and broadcasts.join(oid, dest):
            return True
        planes = self._cluster.planes
        src_addr = planes.get(src)
        dest_addr = planes.get(dest)
        if src_addr is None and dest_addr is None:
            if self._sim_gbps > 0:
                _clk.sleep(size / (self._sim_gbps * 1e9))
            return True
        plane = self._cluster.plane
        if src_addr is None:
            # source shares the head store: serve from the head's plane
            src_addr = plane.serve_address
            if src_addr is None and dest_addr is not None:
                return False    # head store is not being served
        extra = self._replica_addrs(oid, dest, exclude=src_addr)
        if dest_addr is None:
            # destination shares the head store: fetch here
            return plane.pull_into_local(oid, size, src_addr, extra)
        return plane.request_remote_pull(dest_addr, oid, size, src_addr,
                                         extra)

    def _replica_addrs(self, oid, dest: int,
                       exclude: str | None) -> tuple:
        """Plane addresses of every directory replica besides the
        primary (striping candidates), destination excluded."""
        planes = self._cluster.planes
        head_addr = self._cluster.plane.serve_address
        out = []
        for row in self._cluster.directory.locations(oid):
            if row == dest:
                continue
            addr = planes.get(row)
            if addr is None:
                addr = head_addr    # head-resident replica
            if addr is not None and addr != exclude and addr not in out:
                out.append(addr)
        return tuple(out)

    # -- loss / teardown -----------------------------------------------------
    def on_objects_lost(self, object_ids) -> None:
        lost = set(object_ids)
        with self._cv:
            for key in [k for k in self._requests if k[0] in lost]:
                self._fail_locked(key)
            self._active = deque((k, s) for k, s in self._active
                                 if k[0] not in lost)
            self._activate_locked()

    def stats(self) -> dict:
        with self._cv:
            out = {
                "num_pulls": self.num_pulls,
                "bytes_pulled": self.bytes_pulled,
                "num_failed": self.num_failed,
                "queued": len(self._requests),
                "inflight_bytes": self._inflight_bytes,
                "inflight_sources": len(self._infl_kb_rows),
                "device_batches": self.device_batches,
                "oracle_batches": self.oracle_batches,
            }
        # data-path counters from the local plane endpoint (per-transfer
        # MB/s, window occupancy, stripe retries, raw vs pickled bytes)
        plane = getattr(self._cluster, "plane", None)
        if plane is not None:
            out.update(plane.stats())
        return out

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

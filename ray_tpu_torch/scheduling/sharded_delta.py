"""Row-sharded delta-scheduling heartbeat engine.

``ShardedDeltaScheduler`` is the ``DeltaScheduler`` with every
node-indexed resident split by rows over a list of ranks laid out as the
reference's two-level ("dcn", "ici") grid (``ops/shard_reduce.py``):
each rank holds only its N/S node rows of the CRM mirror and its N/S key
columns of the carried (C, N) packed-key tensor, and receives only ITS
shard's dirty rows per heartbeat: the host stages per-rank buckets, one
section of the beat's blob a rank (``policy.BeatBlob``), uploaded in one
copy a card.  The beat still performs exactly ONE readback: a packed
buffer with the water-fill counts and the per-(class, node) lease
budgets each rank priced from its own rows' post-beat avail
(``ShardPlane.beat``).  Ranks on one card run the beat as three kernels
whatever S is (``beat_rows``, one ``shard_scan`` launch, ``beat_tail``)
and make no transport call; CPU ranks and distinct cards run the
per-rank programs with two-level collectives (psum/pmin within a slice,
then across slices).  ``scan_stats`` carries the scan's route, the
three kernels' launches and the transport's calls.

Ranks are ``torch.device``s: the local CUDA cards by default, or the
caller's list (``["cpu"] * S`` in the tests, ``["cuda:0"] * S`` for S
ranks on one card).  Counts are bit-identical to the single-device
engine and the CPU oracle at any shard count; ``make_delta_scheduler``
is the dispatch-path factory, which returns the plain single-device
``DeltaScheduler`` whenever the shard count resolves to one.

torch is imported inside methods, as in ``policy.py``: the runtime's
workers import this package.
"""

from __future__ import annotations

import time

import numpy as np

from .policy import DeltaScheduler, _bucket


def __getattr__(name):
    # one copy of resolve_shards lives in ops.shard_reduce, which imports
    # torch; re-exported here on first use
    if name == "resolve_shards":
        from ..ops.shard_reduce import resolve_shards
        return resolve_shards
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class ShardedDeltaScheduler(DeltaScheduler):
    """DeltaScheduler with node rows sharded over ranks.

    Overrides only the device-layout hooks of the base engine: sharded
    placement of the mirror/keys/request plane, the ranks of the staged
    upload's sections, and the beat on the plane (``ShardPlane.beat``).
    The sync protocol (epoch journal, dirty-fraction fallback, class slot
    registry, per-rank buckets, double-buffered staging) is inherited
    unchanged, and so is the public surface.  ``device`` is the first
    rank's: the beat's packed readback comes from there.
    """

    def __init__(self, crm, n_shards: int = 0,
                 reduce_mode: str | None = None, devices=None):
        from ..common.config import get_config
        from ..ops import shard_reduce as sr
        ranks = sr.local_ranks() if devices is None else list(devices)
        super().__init__(crm, device=ranks[0])
        cfg = get_config()
        if reduce_mode is None:
            reduce_mode = cfg.scheduler_shard_reduce
        if n_shards <= 0:
            n_shards = cfg.scheduler_shards
        self._n_shards = sr.resolve_shards(n_shards, len(ranks))
        self._plane = sr.plane_for(self._n_shards, reduce_mode, ranks)
        self.stats["shards"] = self._n_shards
        # the class scan's route (ShardPlane.scan_route), the launches of
        # the beat's kernels and the transport's collectives of this
        # engine's beats; apart from ``stats``, which stays the reference
        # engine's
        self.scan_stats = {"route": self._plane.scan_route,
                           "shard_scan_launches": 0,
                           "beat_rows_launches": 0,
                           "beat_tail_launches": 0, "transport_calls": 0}

    def keys_row_host(self, req_vec) -> np.ndarray:
        key = np.ascontiguousarray(
            np.asarray(req_vec, np.int32)).tobytes()
        slot = self._slot_of[key]
        row = self._d2h(self._plane.gather([k[slot]
                                            for k in self._st.keys]))
        return row[:self._n_real].astype(np.int64)

    # -- device-layout hooks ------------------------------------------------
    def _node_pad(self, n_real: int) -> int:
        # the power-of-2 bucket (floor 64) divides by the power-of-2
        # shard count resolve_shards guarantees
        n = _bucket(n_real, 64)
        s = self._plane.n_shards
        if n % s:                                    # defensive only
            n = ((n + s - 1) // s) * s
        return n

    def _n_ranks(self) -> int:
        return self._plane.n_shards

    def _rank_devices(self) -> list:
        return self._plane.ranks

    def _n_local(self) -> int:
        return self._n // self._plane.n_shards

    def _put_state(self, ht, ha, hm):
        from ..ops import hybrid_kernel as hk
        pl = self._plane
        self._st = hk.BeatState(pl.shard_rows(ht, np.int32),
                                pl.shard_rows(ha, np.int32),
                                pl.shard_rows(hm, bool))

    def _put_reqs(self, hr):
        self._st.reqs = self._plane.replicate(hr, np.int32)

    def _full_rescore_call(self, thr):
        st = self._st
        st.keys = self._plane.full_rescore(st.totals, st.avail, st.mask,
                                           st.reqs, thr)

    def _device_beat(self, blob, thr, require_available):
        from ..ops import hybrid_kernel as hk
        from ..ops.shard_reduce import shard_scan
        pl = self._plane
        t0 = time.perf_counter() if self.profile else 0.0
        v = self._upload(blob)
        t0 = self._phase("h2d", t0)
        before = (shard_scan.launches, hk.beat_rows.launches,
                  hk.beat_tail.launches, pl.transport.calls)
        out = pl.beat(self._st, v, thr, require_available)
        self._phase("argmin", t0)
        st = self.scan_stats
        st["route"] = pl.last_scan_route
        for key, b, a in zip(("shard_scan_launches", "beat_rows_launches",
                              "beat_tail_launches", "transport_calls"),
                             before, (shard_scan.launches,
                                      hk.beat_rows.launches,
                                      hk.beat_tail.launches,
                                      pl.transport.calls)):
            st[key] += a - b
        return out

    def _sync(self) -> None:
        import torch
        for d in dict.fromkeys(self._plane.ranks):
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def make_delta_scheduler(crm, n_shards: int | None = None,
                         reduce_mode: str | None = None, device=None,
                         devices=None):
    """The dispatch-path factory: a ``ShardedDeltaScheduler`` when the
    shard count resolves past one rank, the plain single-device
    ``DeltaScheduler`` otherwise (on one rank there is nothing to shard).

    The ranks are ``devices`` when given, else ``shard_reduce.local_ranks
    (device)``: every local CUDA card with the one ``device`` names
    first, or the one CPU rank for ``device="cpu"``.  The single-device
    engine runs on ``device`` (or the first of ``devices``).
    ``n_shards``/``reduce_mode`` default to the ``scheduler_shards`` /
    ``scheduler_shard_reduce`` knobs.
    """
    from ..common.config import get_config
    from ..ops import shard_reduce as sr
    cfg = get_config()
    requested = cfg.scheduler_shards if n_shards is None else n_shards
    mode = cfg.scheduler_shard_reduce if reduce_mode is None \
        else reduce_mode
    ranks = sr.local_ranks(device) if devices is None else list(devices)
    s = sr.resolve_shards(requested, len(ranks))
    if s <= 1:
        return DeltaScheduler(crm, device=device if devices is None
                              else ranks[0])
    return ShardedDeltaScheduler(crm, s, mode, devices=ranks)

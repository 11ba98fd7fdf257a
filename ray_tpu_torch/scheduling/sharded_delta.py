"""Row-sharded delta-scheduling heartbeat engine.

``ShardedDeltaScheduler`` is the ``DeltaScheduler`` with every
node-indexed resident split by rows over a list of ranks laid out as the
reference's two-level ("dcn", "ici") grid (``ops/shard_reduce.py``):
each rank holds only its N/S node rows of the CRM mirror and its N/S key
columns of the carried (C, N) packed-key tensor, and receives only ITS
shard's dirty rows per heartbeat: the host stages per-shard upload
buckets, and the double-buffered copy to each rank carries nothing
another rank owns.  Global decisions (water-fill levels, the placement
argmin) are two-level collectives: psum/pmin within a slice, then across
slices.  The beat still performs exactly ONE readback: a packed buffer
with the water-fill counts and the per-(class, node) lease budgets each
rank priced from its own rows' post-beat avail (``ShardPlane.fused_beat``).

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
    placement of the mirror/keys/request plane, per-shard dirty-row and
    override staging, and the fused beat with the two-level argmin
    reduce.  The sync protocol (epoch journal, dirty-fraction fallback,
    class slot registry, double-buffered staging) is inherited unchanged,
    and so is the public surface.  ``device`` is the first rank's: the
    beat's packed readback comes from there.
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

    def keys_row_host(self, req_vec) -> np.ndarray:
        key = np.ascontiguousarray(
            np.asarray(req_vec, np.int32)).tobytes()
        slot = self._slot_of[key]
        row = self._d2h(self._plane.gather([k[slot] for k in self._keys]))
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

    def _n_local(self) -> int:
        return self._n // self._plane.n_shards

    def _put_state(self, ht, ha, hm):
        pl = self._plane
        self._totals = pl.shard_rows(ht, np.int32)
        self._avail = pl.shard_rows(ha, np.int32)
        self._mask = pl.shard_rows(hm, bool)
        self._ones = pl.shard_rows(np.ones(hm.shape, bool), bool)

    def _put_reqs(self, hr):
        self._reqs = self._plane.replicate(hr, np.int32)

    def _full_rescore_call(self, thr):
        return self._plane.full_rescore(self._totals, self._avail,
                                        self._mask, self._reqs, thr)

    def _replicated(self, *arrays):
        """Per-beat upload of replicated arrays: one staged copy a
        distinct rank device.  Returns a per-rank list for each array."""
        devs = list(dict.fromkeys(self._plane.ranks))
        up = self._h2d(*[a for a in arrays for _ in devs],
                       devices=devs * len(arrays))
        out = []
        for i in range(len(arrays)):
            per_dev = dict(zip(devs, up[i * len(devs):(i + 1) * len(devs)]))
            out.append([per_dev[d] for d in self._plane.ranks])
        return out

    def _sharded(self, *arrays):
        """Per-beat upload of (S*B, ...) bucket arrays: rank i's copy
        carries rows [i*B, (i+1)*B) only.  A per-rank list each."""
        pl = self._plane
        s = pl.n_shards
        blocks = [b for a in arrays for b in np.split(a, s)]
        up = self._h2d(*blocks, devices=pl.ranks * len(arrays))
        return [list(up[i * s:(i + 1) * s]) for i in range(len(arrays))]

    def _install_classes(self, idx, vecs, thr):
        idx_d, vecs_d = self._replicated(idx, vecs)
        self._reqs, self._keys = self._plane.apply_dirty_classes(
            self._totals, self._avail, self._mask, self._keys,
            self._reqs, idx_d, vecs_d, thr)

    def _put_extra_mask(self, emp):
        return self._sharded(emp)[0]

    def _fused_call(self, slots_p, counts_p, em, ov, thr,
                    require_available):
        slots_d, counts_d = self._replicated(slots_p, counts_p)
        return self._plane.fused_beat(
            self._totals, self._avail, self._mask, self._keys,
            self._reqs, slots_d, counts_d, em, ov[0], ov[1], thr,
            require_available=require_available)

    # -- per-shard staging --------------------------------------------------
    def _shard_buckets(self, rows):
        """Group global dirty rows into per-shard buckets of global row
        indices, padded to a common power-of-2 width so each rank's
        upload is one fixed-shape (B,)/(B, R) block of ITS rows only."""
        s = self._plane.n_shards
        n_l = self._n_local()
        buckets: list[list[int]] = [[] for _ in range(s)]
        for r in rows:
            buckets[r // n_l].append(r)
        b = _bucket(max(max((len(bk) for bk in buckets), default=0), 1))
        return buckets, b, n_l

    def _delta_sync(self, rows, totals, avail, mask, thr):
        pl = self._plane
        t0 = time.perf_counter() if self.profile else 0.0
        buckets, b, n_l = self._shard_buckets(rows)
        s = pl.n_shards
        idx = np.full((s * b,), n_l, np.int32)   # local idx; pad dropped
        rt = np.zeros((s * b, self._r), np.int32)
        ra = np.zeros((s * b, self._r), np.int32)
        rm = np.zeros((s * b,), bool)
        for si, bk in enumerate(buckets):
            if not bk:
                continue
            sl = slice(si * b, si * b + len(bk))
            idx[sl] = bk
            idx[sl] -= si * n_l
            rt[sl, :self._r_real] = totals[bk]
            ra[sl, :self._r_real] = avail[bk]
            rm[sl] = mask[bk]
        # double-buffered staging, split on the bucket axis: the copy to
        # each rank carries only its own shard's rows
        staged = self._sharded(idx, rt, ra, rm)
        if self.profile:
            self._sync()
            self.phase_ms["h2d"] += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
        self._totals, self._avail, self._mask, self._keys = \
            pl.apply_dirty_rows(self._totals, self._avail, self._mask,
                                self._keys, self._reqs, *staged, thr)
        if self.profile:
            self._sync()
            self.phase_ms["score"] += (time.perf_counter() - t0) * 1e3

    def _sync(self) -> None:
        import torch
        for d in dict.fromkeys(self._plane.ranks):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _pack_overrides(self, overrides):
        pl = self._plane
        s = pl.n_shards
        n_l = self._n_local()
        if not overrides:
            if self._empty_ov is None:
                self._empty_ov = (
                    pl.shard_rows(np.full((s * 8,), n_l, np.int32),
                                  np.int32),
                    pl.shard_rows(np.zeros((s * 8, self._r), np.int32),
                                  np.int32))
            return self._empty_ov
        buckets, b, _ = self._shard_buckets(sorted(overrides))
        idx = np.full((s * b,), n_l, np.int32)
        av = np.zeros((s * b, self._r), np.int32)
        for si, bk in enumerate(buckets):
            for j, row in enumerate(bk):
                vec = overrides[row]
                idx[si * b + j] = row - si * n_l
                w = min(self._r, len(vec))
                av[si * b + j, :w] = vec[:w]
        return tuple(self._sharded(idx, av))


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

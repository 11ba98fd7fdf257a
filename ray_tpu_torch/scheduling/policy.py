"""The SchedulingPolicy plugin boundary and its stock policies.

Reference parity: ``ISchedulingPolicy::Schedule(resource_request,
SchedulingOptions)`` with implementations ``HybridSchedulingPolicy``,
``SpreadSchedulingPolicy``, ``RandomSchedulingPolicy``,
``NodeAffinitySchedulingPolicy``, ``NodeLabelSchedulingPolicy``, composed by
``CompositeSchedulingPolicy`` (``src/ray/raylet/scheduling/policy/*``).
[SURVEY.md §1 layer 5; mount empty.]  BASELINE.json gates the device backend
behind exactly this boundary: the hybrid policy here can answer from the CPU
oracle or defer batches to the device kernel — callers cannot tell which.

Policies are pure functions of (ClusterState snapshot, request, options):
no hidden state except the documented RNG/round-robin cursors, so parity is a
property test (SURVEY §4 closing note).

torch is imported inside ``DeltaScheduler``'s methods, not here: the
runtime's workers import this module (placement-group strategies reach
``scheduling``) and must not pay for torch or touch the GPU.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass

import numpy as np

from .contract import (AVAIL_SHIFT, INFEASIBLE_KEY, compute_keys,
                       threshold_fp)
from .oracle import ClusterState


class SchedulingType(enum.Enum):
    HYBRID = 0
    SPREAD = 1
    RANDOM = 2
    NODE_AFFINITY = 3
    NODE_LABEL = 4


@dataclass
class SchedulingOptions:
    """Mirror of the reference's SchedulingOptions variants."""

    scheduling_type: SchedulingType = SchedulingType.HYBRID
    spread_threshold: float | None = None      # None => config default
    avoid_local_node: bool = False
    local_node_row: int = 0                    # row of the scheduling raylet
    require_node_available: bool = False
    # NODE_AFFINITY
    node_row: int = -1
    soft: bool = False
    # label constraints resolved by the caller into a node mask
    node_mask: np.ndarray | None = None


class ISchedulingPolicy:
    def schedule(self, state: ClusterState, req: np.ndarray,
                 options: SchedulingOptions) -> int:
        """Return node row or -1. Must not mutate ``state`` unless the
        placement consumes resources (available-bucket placements do)."""
        raise NotImplementedError


class HybridSchedulingPolicy(ISchedulingPolicy):
    """The default policy — contract.py semantics (SURVEY §2.5).

    Top-k sampling (reference ``scheduler_top_k_fraction`` /
    ``scheduler_top_k_absolute``): with fraction > 0 the policy samples
    uniformly among the k best-keyed feasible nodes instead of always
    taking the minimum, trading determinism for contention spread.  The
    stream is a pinned Philox counter (one draw per decision) so runs
    replay bit-for-bit.  fraction = 0 (the default) is the
    argmin/bit-exact-parity configuration; the device batch path requires
    it (sampling rounds route through this host policy)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.Generator(np.random.Philox(seed))

    def schedule(self, state, req, options):
        from ..common.config import get_config
        thr = threshold_fp(options.spread_threshold)
        mask = state.node_mask
        if options.node_mask is not None:
            mask = mask & options.node_mask
        if options.avoid_local_node and \
                0 <= options.local_node_row < mask.shape[0]:
            mask = mask.copy()
            mask[options.local_node_row] = False
        keys = compute_keys(state.totals, state.avail, req, thr, mask)
        cfg = get_config()
        if cfg.scheduler_top_k_fraction > 0:
            node = self._sample_top_k(keys, cfg)
        else:
            node = int(np.argmin(keys))
        if node < 0 or keys[node] == INFEASIBLE_KEY:
            return -1
        available = (keys[node] >> AVAIL_SHIFT) == 0
        if options.require_node_available and not available:
            return -1
        if available:
            state.avail[node] -= np.asarray(req, dtype=np.int32)
        return node

    def _sample_top_k(self, keys: np.ndarray, cfg) -> int:
        feasible = np.flatnonzero(keys != INFEASIBLE_KEY)
        if feasible.size == 0:
            return -1
        k = max(int(cfg.scheduler_top_k_absolute),
                int(np.ceil(cfg.scheduler_top_k_fraction * feasible.size)))
        k = min(k, feasible.size)
        # the k best by packed key (ties broken by row index, like argmin)
        order = feasible[np.argsort(keys[feasible], kind="stable")[:k]]
        return int(self._rng.choice(order))


class SpreadSchedulingPolicy(ISchedulingPolicy):
    """Round-robin over feasible+available nodes (reference
    ``SpreadSchedulingPolicy``: best-effort even spreading with a rotating
    start cursor)."""

    def __init__(self):
        self._cursor = 0

    def schedule(self, state, req, options):
        thr = threshold_fp(options.spread_threshold)
        mask = state.node_mask if options.node_mask is None \
            else state.node_mask & options.node_mask
        keys = compute_keys(state.totals, state.avail, req, thr, mask)
        n = state.num_nodes
        order = (np.arange(n) + self._cursor) % n
        feasible = keys != INFEASIBLE_KEY
        available = feasible & ((keys >> AVAIL_SHIFT) == 0)
        for pool in (available, feasible):
            cand = order[pool[order]]
            if cand.size:
                node = int(cand[0])
                self._cursor = (node + 1) % n
                if available[node]:
                    state.avail[node] -= np.asarray(req, dtype=np.int32)
                return node
        return -1


class RandomSchedulingPolicy(ISchedulingPolicy):
    """Uniform over feasible+available nodes, pinned threefry stream so runs
    replay deterministically (SURVEY §7 hard part 2)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.Generator(np.random.Philox(seed))

    def schedule(self, state, req, options):
        thr = threshold_fp(options.spread_threshold)
        mask = state.node_mask if options.node_mask is None \
            else state.node_mask & options.node_mask
        keys = compute_keys(state.totals, state.avail, req, thr, mask)
        available = (keys != INFEASIBLE_KEY) & ((keys >> AVAIL_SHIFT) == 0)
        cand = np.flatnonzero(available)
        if cand.size == 0:
            cand = np.flatnonzero(keys != INFEASIBLE_KEY)
            if cand.size == 0:
                return -1
            return int(self._rng.choice(cand))
        node = int(self._rng.choice(cand))
        state.avail[node] -= np.asarray(req, dtype=np.int32)
        return node


class NodeAffinitySchedulingPolicy(ISchedulingPolicy):
    """Pin to a node; hard affinity fails if the node can't take it, soft
    affinity falls back to hybrid (reference
    ``NodeAffinitySchedulingPolicy``)."""

    def __init__(self):
        self._hybrid = HybridSchedulingPolicy()

    def schedule(self, state, req, options):
        row = options.node_row
        ok = (0 <= row < state.num_nodes) and bool(state.node_mask[row])
        if ok:
            thr = threshold_fp(options.spread_threshold)
            keys = compute_keys(state.totals, state.avail, req, thr,
                                state.node_mask)
            if keys[row] != INFEASIBLE_KEY:
                if (keys[row] >> AVAIL_SHIFT) == 0:
                    state.avail[row] -= np.asarray(req, dtype=np.int32)
                return row
        if options.soft:
            fallback = SchedulingOptions(
                scheduling_type=SchedulingType.HYBRID,
                spread_threshold=options.spread_threshold,
                node_mask=options.node_mask)
            return self._hybrid.schedule(state, req, fallback)
        return -1


class NodeLabelSchedulingPolicy(ISchedulingPolicy):
    """Restrict to nodes matching a label selector (resolved by the
    caller into ``options.node_mask``), hybrid within the match set;
    hard selectors with no matching node park (-1), soft ones fall back
    to the unrestricted hybrid (reference
    ``NodeLabelSchedulingPolicy`` hard/soft label constraints)."""

    def __init__(self):
        self._hybrid = HybridSchedulingPolicy()

    def schedule(self, state, req, options):
        node = self._hybrid.schedule(state, req, options)
        if node >= 0 or not options.soft:
            return node
        fallback = SchedulingOptions(
            scheduling_type=SchedulingType.HYBRID,
            spread_threshold=options.spread_threshold)
        return self._hybrid.schedule(state, req, fallback)


def _bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor) — the padded axis lengths
    of the resident tensors (the same layout as the JAX engine's, so
    the two engines' budget and key tensors compare row for row)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


class _StageSlot:
    """One of the two host staging slots of the double buffer: pinned
    buffers (grown on demand) plus the CUDA events recorded, one a
    destination device, after the last host->device copies out of
    them."""

    __slots__ = ("bufs", "events")

    def __init__(self):
        self.bufs: dict[int, torch.Tensor] = {}
        self.events: list = []


# a beat's staged inputs, in section order (name, stored as bytes)
_BLOB_FIELDS = (("slots", False), ("counts", False), ("cls_idx", False),
                ("cls_reqs", False), ("idx", False), ("rows_totals", False),
                ("rows_avail", False), ("ov_idx", False), ("ov_avail", False),
                ("rows_mask", True), ("extra_mask", True))


class BeatBlob:
    """One beat's staged inputs on the host: a section of int32 words a
    rank, each field at the same offset in every section (booleans as
    bytes at a word-aligned offset), sections of a multiple of 16 bytes.
    The upload is one copy a card, and rank k's view of a field is rank
    0's plus k sections, as ``hybrid_kernel.beat_rows`` takes them.

    Fields (each a per-rank list of arrays of one shape; absent where the
    beat has none): ``slots``/``counts`` (G,) the beat's classes (every
    rank's copy), ``cls_idx`` (B,)/``cls_reqs`` (B, R) a class install,
    ``idx`` (B,) local rows (padding == n_local)/``rows_totals``/
    ``rows_avail`` (B, R)/``rows_mask`` (B,) the rank's dirty rows,
    ``ov_idx``/``ov_avail`` its overrides, ``extra_mask`` (n_local,) its
    soft mask."""

    def __init__(self, fields: dict):
        self.layout: dict = {}
        off = 0
        for name, as_bytes in _BLOB_FIELDS:
            parts = fields.get(name)
            if parts is None:
                continue
            shape = tuple(np.shape(parts[0]))
            n = int(np.prod(shape))
            self.layout[name] = (off, shape, as_bytes)
            off += (n + 3) // 4 if as_bytes else n
        self.words = max(4, -(-off // 4) * 4)
        self.host = np.zeros((len(fields["slots"]), self.words), np.int32)
        for name, (o, shape, as_bytes) in self.layout.items():
            n = int(np.prod(shape))
            for k, arr in enumerate(fields[name]):
                if as_bytes:
                    self.host[k].view(np.uint8)[4 * o:4 * o + n] = \
                        np.asarray(arr, bool).reshape(-1)
                else:
                    self.host[k, o:o + n] = \
                        np.asarray(arr, np.int32).reshape(-1)

    def views(self, sections) -> dict:
        """{field: per-rank list of tensors}, views of the uploaded
        sections (one int32 tensor of ``words`` a rank)."""
        import torch
        out = {}
        for name, (o, shape, as_bytes) in self.layout.items():
            n = int(np.prod(shape))
            if as_bytes:
                out[name] = [sec[o:o + (n + 3) // 4].view(torch.uint8)[:n]
                             .view(torch.bool).view(shape)
                             for sec in sections]
            else:
                out[name] = [sec[o:o + n].view(shape) for sec in sections]
        return out


class DeltaScheduler:
    """Device-resident delta-scheduling heartbeat engine (torch).

    Keeps three residents on ``device`` between beats: a mirror of the
    CRM's dense state (totals/avail/placement mask), the interned
    scheduling class request matrix, and a carried (classes x nodes)
    packed-key tensor bit-identical to ``contract.compute_keys`` on the
    mirror (an ``ops.hybrid_kernel.BeatState``).  Each ``beat``:

    1. asks the CRM what changed since the last synced epoch
       (``ClusterResourceManager.delta_view``) and stages ONLY the dirty
       rows, with the beat's classes, overrides, soft mask and any fresh
       class rows, into one host blob (``BeatBlob``), uploaded in ONE
       copy through one of two pinned staging slots (double buffering: a
       slot is rewritten only after the CUDA event of its previous copy
       has fired, so the host never blocks on the copy it just
       enqueued);
    2. falls back to a full re-upload + rescore when the dirty fraction
       crosses ``scheduler_delta_max_dirty_fraction``, the journal was
       truncated, array shapes grew, or the spread threshold changed;
    3. runs the beat on the device: ``hybrid_kernel.beat_rows`` (the
       dirty rows scattered into the mirror and their key columns
       rescored, this beat's ephemeral avail overrides (planned-load
       debits) and soft mask (suspect avoidance), the class gather), one
       ``waterfill_scan`` launch, and ``beat_tail`` (the packed counts,
       the per-(class, node) lease budgets priced off the post-beat avail
       (``contract.compute_budgets`` twin) and the per-class argmin) —
       ONE device->host readback per beat, not one per class.  The lease
       plane reads the budgets via ``last_budgets``/``budget_row_host``
       without another sync.

    On the card that is three kernels a steady beat, and the residents
    are updated in place (the kernels' table of pointers is rebuilt only
    when a resident is reallocated: a full sync, width growth, a larger
    class axis).  Placements are advisory exactly like the snapshot path:
    the CRM stays authoritative, commits happen through ``subtract`` at
    dispatch, which marks the rows dirty for the next beat.  Counts are
    bit-identical to ``schedule_grouped`` on a fresh snapshot.

    ``device`` defaults to the GPU (``device.resolve_device``); the tests
    pass ``"cpu"`` to run the plain PyTorch path.  ``readbacks`` counts
    every device->host copy the engine makes (one per beat, plus the
    deliberate ``keys_row_host``/``peek_argmin`` reads).
    """

    def __init__(self, crm, device=None):
        from ..device import resolve_device
        self._crm = crm
        self._device = resolve_device(device)
        self._version = -2          # pre-first-sync sentinel (< any epoch)
        self._thr: int | None = None
        self._st = None             # the device residents (BeatState)
        self._n = 0                 # padded node axis
        self._r = 0                 # padded resource axis
        self._cap_c = 0             # padded class axis
        self._n_real = 0
        self._r_real = 0
        # class slot registry (+ host copies to rebuild across resyncs)
        self._slot_of: dict[bytes, int] = {}
        self._class_host: dict[int, np.ndarray] = {}
        self._free_slots: list[int] = []
        self._next_slot = 0
        # double-buffered staging (pinned host slots on CUDA)
        self._stage = [_StageSlot(), _StageSlot()]
        self._parity = 0
        self._last_amin = None
        # this beat's staged dirty rows and class install (host arrays)
        self._pending: dict = {}
        # beat-emitted lease budgets: host (C_real, n_real) slice of the
        # packed readback, refreshed every beat; seq lets the publisher
        # tell "new beat" from "same beat re-read"
        self._budgets_host: np.ndarray | None = None
        self._budget_seq = 0
        self.readbacks = 0
        self.stats = {"beats": 0, "delta_beats": 0, "full_rescores": 0,
                      "clean_beats": 0, "rows_uploaded": 0,
                      "classes_installed": 0}
        # opt-in phase profiling: inserts device syncs after every
        # phase, so it DEFEATS the double-buffered overlap — never
        # enable on the live dispatch path
        self.profile = False
        self.phase_ms = {"densify": 0.0, "h2d": 0.0, "score": 0.0,
                         "argmin": 0.0, "readback": 0.0}

    @property
    def device(self) -> torch.device:
        return self._device

    # -- public surface -----------------------------------------------------
    def beat(self, group_reqs, group_counts, overrides=None,
             extra_mask=None, require_available: bool = False,
             spread_threshold: float | None = None) -> np.ndarray:
        """Sync the mirror, schedule G classes, return (G, n+1) int32
        counts (column n = infeasible/queued-nowhere), matching
        ``hybrid_kernel.schedule_grouped`` on a fresh CRM snapshot.

        ``overrides``: {row: int32 avail vector} applied for this beat
        only (the raylet's planned-load debits).  ``extra_mask``: host
        bool (n,) soft mask ANDed into the placement mask for this beat
        (suspect avoidance) — the carried key tensor ignores it.
        """
        from ..common.config import get_config

        thr = int(threshold_fp(spread_threshold))
        v, totals, avail, place_mask, rows = \
            self._crm.delta_view(self._version)
        n_real, r_real = totals.shape
        cfg = get_config()
        resync = (rows is None or self._st is None
                  or thr != self._thr or n_real != self._n_real
                  or r_real != self._r_real)
        if not resync and rows and len(rows) > \
                cfg.scheduler_delta_max_dirty_fraction * n_real:
            # the fallback knob: 0.0 disables the delta path entirely
            resync = True
        self._pending = {}
        t0 = time.perf_counter() if self.profile else 0.0
        if resync:
            self._full_sync(totals, avail, place_mask, thr)
            self.stats["full_rescores"] += 1
            t0 = time.perf_counter() if self.profile else 0.0
        elif rows:
            self._stage_rows(sorted(rows), totals, avail, place_mask)
            self.stats["delta_beats"] += 1
            self.stats["rows_uploaded"] += len(rows)
        else:
            self.stats["clean_beats"] += 1
        self._version = v
        self.stats["beats"] += 1

        group_reqs = np.ascontiguousarray(
            np.asarray(group_reqs, np.int32))
        g = group_reqs.shape[0]
        if group_reqs.shape[1] != self._r_real:
            # caller densified at an older width; columns only ever
            # append, so zero-padding to the mirror's width is exact
            norm = np.zeros((g, self._r_real), np.int32)
            w = min(self._r_real, group_reqs.shape[1])
            norm[:, :w] = group_reqs[:, :w]
            group_reqs = norm
        slots = self._ensure_classes(group_reqs, thr)
        gp = _bucket(g)
        slots_p = np.full((gp,), self._cap_c, np.int32)
        slots_p[:g] = slots
        counts_p = np.zeros((gp,), np.int32)
        counts_p[:g] = np.asarray(group_counts, np.int32)
        fields = dict(self._pending)
        s = self._n_ranks()
        fields["slots"] = [slots_p] * s
        fields["counts"] = [counts_p] * s
        if overrides:
            self._stage_overrides(overrides, fields)
        if extra_mask is not None:
            emp = np.zeros((self._n,), bool)
            emp[:n_real] = np.asarray(extra_mask, bool)[:n_real]
            fields["extra_mask"] = np.split(emp, s)
        blob = BeatBlob(fields)
        if self.profile:
            self.phase_ms["densify"] += (time.perf_counter() - t0) * 1e3

        counts_d, amin_d = self._device_beat(blob, thr, require_available)
        self._last_amin = amin_d
        t0 = time.perf_counter() if self.profile else 0.0
        # the one sanctioned host<-device readback of the beat: rows
        # [:gp] are the water-fill counts, rows [gp:] the lease budgets
        packed = self._d2h(counts_d)
        counts = packed[:gp]
        self._budgets_host = packed[gp:, :n_real]
        self._budget_seq += 1
        if self.profile:
            self.phase_ms["readback"] += (time.perf_counter() - t0) * 1e3
        return np.concatenate(
            [counts[:g, :n_real], counts[:g, -1:]], axis=1)

    def hit_rate(self) -> float:
        """Fraction of beats served without a full re-upload/rescore."""
        b = self.stats["beats"]
        return 0.0 if not b else 1.0 - self.stats["full_rescores"] / b

    def retire_class(self, req_vec) -> bool:
        """Forget an interned scheduling class, freeing its slot (the
        next new class reuses it and rewrites the key row)."""
        key = np.ascontiguousarray(
            np.asarray(req_vec, np.int32)).tobytes()
        slot = self._slot_of.pop(key, None)
        if slot is None:
            return False
        self._class_host.pop(slot, None)
        self._free_slots.append(slot)
        return True

    def keys_row_host(self, req_vec) -> np.ndarray:
        """Carried key row of one interned class vs the real nodes —
        verification surface for the parity tests (deliberate
        readback)."""
        key = np.ascontiguousarray(
            np.asarray(req_vec, np.int32)).tobytes()
        row = self._d2h(self._st.keys[0][self._slot_of[key]])
        return row[:self._n_real].astype(np.int64)

    def peek_argmin(self, req_vec) -> int:
        """Best node row for one class per the carried key tensor (the
        lease-grant preview; deliberate readback)."""
        key = np.ascontiguousarray(
            np.asarray(req_vec, np.int32)).tobytes()
        return int(self._d2h(self._last_amin)[self._slot_of[key]])

    # -- beat-emitted lease budgets (host copies off the fused readback) ----
    @property
    def budget_seq(self) -> int:
        """Monotonic count of beats whose budgets have landed."""
        return self._budget_seq

    def last_budgets(self) -> np.ndarray | None:
        """(C, n_real) int32 budgets from the last beat's readback, row
        index == class slot; None before the first beat.  NOT a device
        sync — this is the host slice the beat already fetched."""
        return self._budgets_host

    def class_vectors(self) -> dict[int, np.ndarray]:
        """{slot: interned dense request vector} for every resident
        class — the publisher's map from budget rows back to lease
        class keys."""
        return dict(self._class_host)

    def budget_row_host(self, req_vec) -> np.ndarray | None:
        """Beat-emitted lease budget of one interned class vs the real
        nodes, or None if the class isn't resident / no beat has run."""
        if self._budgets_host is None:
            return None
        key = np.ascontiguousarray(
            np.asarray(req_vec, np.int32)).tobytes()
        slot = self._slot_of.get(key)
        if slot is None or slot >= self._budgets_host.shape[0]:
            return None
        return self._budgets_host[slot]

    # -- host<->device transfers --------------------------------------------
    def _sync(self) -> None:
        if self._device.type == "cuda":
            import torch
            torch.cuda.synchronize(self._device)

    def _d2h(self, t) -> np.ndarray:
        """Every device->host copy of the engine goes through here."""
        self.readbacks += 1
        return t.cpu().numpy()

    def _put(self, arr) -> torch.Tensor:
        """Direct placement of a host array (full syncs, residents)."""
        import torch
        return torch.as_tensor(np.ascontiguousarray(arr),
                               device=self._device)

    def _h2d(self, *arrays, devices=None):
        """Per-beat uploads through the free staging slot, array ``i``
        to ``devices[i]`` (default: the engine's device).  On CUDA each
        array is written into the slot's pinned buffer and copied with
        ``non_blocking=True``; the slot's events (recorded on each
        destination's stream after those copies) are waited on before
        the slot is rewritten two uploads later.  Returns the device
        tensors."""
        import torch
        if self._device.type != "cuda":
            return tuple(torch.from_numpy(np.array(a)) for a in arrays)
        if devices is None:
            devices = [self._device] * len(arrays)
        slot = self._stage[self._parity]
        for ev in slot.events:
            ev.synchronize()
        out = []
        for i, (a, dev) in enumerate(zip(arrays, devices)):
            a = np.ascontiguousarray(a)
            dtype = torch.from_numpy(a[:0]).dtype
            buf = slot.bufs.get(i)
            if buf is None or buf.dtype != dtype or buf.numel() < a.size:
                buf = torch.empty((max(a.size, 64),), dtype=dtype,
                                  pin_memory=True)
                slot.bufs[i] = buf
            host = buf[:a.size].view(a.shape)
            host.numpy()[...] = a
            out.append(host.to(dev, non_blocking=True))
        slot.events = []
        for dev in dict.fromkeys(devices):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            slot.events.append(ev)
        self._parity ^= 1
        return tuple(out)

    def _upload(self, blob: BeatBlob) -> dict:
        """The beat's one upload a card: the blob's sections to the ranks'
        device(s); returns its per-rank views."""
        ranks = self._rank_devices()
        if len(set(ranks)) == 1:
            (dev_blob,) = self._h2d(blob.host.reshape(-1),
                                    devices=ranks[:1])
            sections = list(dev_blob.view(len(ranks), blob.words))
        else:
            sections = list(self._h2d(*blob.host, devices=ranks))
        return blob.views(sections)

    def _phase(self, name, t0) -> float:
        """Profile mode: sync, book the time since ``t0`` to phase
        ``name``, and return a new start."""
        if not self.profile:
            return 0.0
        self._sync()
        self.phase_ms[name] += (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    # -- device-layout hooks (the sharded engine overrides these) -----------
    def _n_ranks(self) -> int:
        return 1

    def _rank_devices(self) -> list:
        return [self._device]

    def _n_local(self) -> int:
        return self._n

    def _device_beat(self, blob, thr, require_available):
        """The beat on the device: one upload, ``beat_rows`` (after a
        class install where there is one), the water-fill, ``beat_tail``.
        Returns (packed_device (G+C, n+1), amin_device (C,))."""
        from ..ops import hybrid_kernel as hk
        t0 = time.perf_counter() if self.profile else 0.0
        v = self._upload(blob)
        t0 = self._phase("h2d", t0)
        st = self._st
        kw = hk.beat_inputs(v)
        classes = kw.pop("classes")
        if classes is not None:
            hk.beat_rows(st, thr, classes=classes)
        hk.beat_rows(st, thr, **kw)
        t0 = self._phase("score", t0)
        g, n = v["slots"][0].shape[0], self._n
        counts, av_fin = hk.waterfill_scan(
            st.totals[0], st.avail_eff[0], st.mask_eff[0],
            st.group_reqs[0][:g], st.group_counts[0][:g], None, thr,
            require_available)
        out = hk.beat_tail(st, [counts[:, :n]], counts[:, n], [av_fin])
        self._phase("argmin", t0)
        return out

    def _put_state(self, ht, ha, hm):
        """Place the padded mirror arrays; called by _full_sync after
        shape bookkeeping."""
        from ..ops import hybrid_kernel as hk
        self._st = hk.BeatState([self._put(ht)], [self._put(ha)],
                                [self._put(hm)])

    def _put_reqs(self, hr):
        self._st.reqs = [self._put(hr)]

    def _full_rescore_call(self, thr):
        from ..ops import hybrid_kernel as hk
        self._st.alloc_keys()
        hk.beat_rows(self._st, thr, rescore=True)

    def _node_pad(self, n_real: int) -> int:
        """Padded node-axis length (power-of-2 bucket, floor 64)."""
        return _bucket(n_real, 64)

    # -- sync internals -----------------------------------------------------
    def _full_sync(self, totals, avail, mask, thr):
        n_real, r_real = totals.shape
        n = self._node_pad(n_real)
        r = _bucket(r_real)
        if r_real != self._r_real and self._slot_of:
            # width grew: re-key the registry at the new width (dense
            # vectors only ever append columns, so zero-padding is exact)
            rekeyed = {}
            for slot, vec in list(self._class_host.items()):
                nv = np.zeros((r_real,), np.int32)
                nv[:vec.shape[0]] = vec
                self._class_host[slot] = nv
                rekeyed[nv.tobytes()] = slot
            self._slot_of = rekeyed
        ht = np.zeros((n, r), np.int32)
        ht[:n_real, :r_real] = totals
        ha = np.zeros((n, r), np.int32)
        ha[:n_real, :r_real] = avail
        hm = np.zeros((n,), bool)
        hm[:n_real] = mask
        t0 = time.perf_counter() if self.profile else 0.0
        self._n, self._r = n, r
        self._n_real, self._r_real = n_real, r_real
        self._put_state(ht, ha, hm)
        t0 = self._phase("h2d", t0)
        self._rebuild_class_plane(thr, rescore=False)
        self._full_rescore_call(thr)
        self._phase("score", t0)
        self._thr = thr

    def _shard_buckets(self, rows):
        """Group global rows into per-rank buckets, padded to a common
        power-of-2 width so each rank's section holds one fixed-shape
        (B,)/(B, R) block of ITS rows only."""
        s = self._n_ranks()
        n_l = self._n_local()
        buckets: list[list[int]] = [[] for _ in range(s)]
        for r in rows:
            buckets[r // n_l].append(r)
        b = _bucket(max(max((len(bk) for bk in buckets), default=0), 1))
        return buckets, b, n_l

    def _stage_rows(self, rows, totals, avail, mask):
        """This beat's dirty rows into per-rank host buckets (local row
        indices; padding == n_local, dropped on the device)."""
        buckets, b, n_l = self._shard_buckets(rows)
        idx, rt, ra, rm = [], [], [], []
        for si, bk in enumerate(buckets):
            i = np.full((b,), n_l, np.int32)
            t = np.zeros((b, self._r), np.int32)
            a = np.zeros((b, self._r), np.int32)
            m = np.zeros((b,), bool)
            i[:len(bk)] = np.asarray(bk, np.int64) - si * n_l
            t[:len(bk), :self._r_real] = totals[bk]
            a[:len(bk), :self._r_real] = avail[bk]
            m[:len(bk)] = mask[bk]
            for lst, x in zip((idx, rt, ra, rm), (i, t, a, m)):
                lst.append(x)
        self._pending.update(idx=idx, rows_totals=rt, rows_avail=ra,
                             rows_mask=rm)

    def _stage_overrides(self, overrides, fields):
        """This beat's overrides into per-rank host buckets."""
        buckets, b, n_l = self._shard_buckets(sorted(overrides))
        idx, av = [], []
        for si, bk in enumerate(buckets):
            i = np.full((b,), n_l, np.int32)
            a = np.zeros((b, self._r), np.int32)
            for j, row in enumerate(bk):
                vec = np.asarray(overrides[row], np.int32)
                i[j] = row - si * n_l
                w = min(self._r, len(vec))
                a[j, :w] = vec[:w]
            idx.append(i)
            av.append(a)
        fields.update(ov_idx=idx, ov_avail=av)

    def _rebuild_class_plane(self, thr, rescore=True):
        cap = _bucket(max(self._next_slot, 1))
        hr = np.zeros((cap, self._r), np.int32)
        for slot, vec in self._class_host.items():
            hr[slot, :vec.shape[0]] = vec
        self._cap_c = cap
        self._put_reqs(hr)
        if rescore:
            self._full_rescore_call(thr)

    def _ensure_classes(self, group_reqs, thr) -> np.ndarray:
        slots = np.empty((group_reqs.shape[0],), np.int32)
        fresh: list[tuple[int, np.ndarray]] = []
        for i, vec in enumerate(group_reqs):
            key = vec.tobytes()
            slot = self._slot_of.get(key)
            if slot is None:
                slot = self._free_slots.pop() if self._free_slots \
                    else self._next_slot
                if slot == self._next_slot:
                    self._next_slot += 1
                self._slot_of[key] = slot
                self._class_host[slot] = vec.copy()
                fresh.append((slot, vec))
            slots[i] = slot
        if fresh:
            self.stats["classes_installed"] += len(fresh)
            if max(s for s, _ in fresh) >= self._cap_c:
                self._rebuild_class_plane(thr)   # class axis grew
            else:
                # staged with the beat: beat_rows installs the rows and
                # rescores them before the beat's own launch
                b = _bucket(len(fresh))
                idx = np.full((b,), self._cap_c, np.int32)
                vecs = np.zeros((b, self._r), np.int32)
                for j, (slot, vec) in enumerate(fresh):
                    idx[j] = slot
                    vecs[j, :vec.shape[0]] = vec
                s = self._n_ranks()
                self._pending.update(cls_idx=[idx] * s, cls_reqs=[vecs] * s)
        return slots


class CompositeSchedulingPolicy(ISchedulingPolicy):
    """Dispatch on options.scheduling_type (reference
    ``CompositeSchedulingPolicy``)."""

    def __init__(self, seed: int = 0):
        self._policies = {
            SchedulingType.HYBRID: HybridSchedulingPolicy(),
            SchedulingType.SPREAD: SpreadSchedulingPolicy(),
            SchedulingType.RANDOM: RandomSchedulingPolicy(seed),
            SchedulingType.NODE_AFFINITY: NodeAffinitySchedulingPolicy(),
            SchedulingType.NODE_LABEL: NodeLabelSchedulingPolicy(),
        }

    def schedule(self, state, req, options):
        return self._policies[options.scheduling_type].schedule(
            state, req, options)

"""Row-sharded delta-heartbeat programs: the scheduling plane partitioned
by node shard, with an explicit two-level ("dcn", "ici") reduce.

The port of ``ray_tpu/ops/shard_reduce.py``.  The single-device
``DeltaScheduler`` keeps the whole (classes x nodes) key tensor and the
CRM mirror on one device.  Here every node-indexed resident is split by
rows over a list of ranks laid out as the reference's ``("dcn", "ici")``
grid (slices x ranks per slice, dcn-major), so each rank

- holds only its N/S node rows of totals/avail/mask,
- holds only its N/S key COLUMNS of the carried (C, N) key tensor,
- re-scores only its own dirty rows, staged host->device as per-rank
  buckets (each rank's upload carries ONLY its rows),

and the beat's global decisions go through three collectives:

- water-fill sums: ``psum`` over "ici" (within a slice) then "dcn";
- the placement argmin: each rank's local min PACKED key carries the
  global traversal index in its low ``NODE_BITS`` bits, so a plain
  ``pmin`` over "ici" then "dcn" IS the exact (argmin-value,
  global-node-index) pair reduce, bit-identical to ``argmin`` over the
  gathered tensor;
- the exclusive prefix over the preceding shards: an ``all_gather`` of
  each rank's level-set mass.

A rank is a ``torch.device``.  ``devices=None`` means the first S local
CUDA cards (the reference's ``jax.local_devices()``); an explicit list
names the ranks, ``["cpu"] * S`` in the tests and ``["cuda:0"] * S`` for
S ranks on one card, the port's counterpart of the reference's virtual
device mesh.  ``_Transport`` carries the collectives: NCCL
(``torch.cuda.nccl``) between distinct cards, a stack and a reduce on
the device when every rank shares one; any other mix raises.  Nothing
reduces on the host, and the plane makes no host sync: the one
sanctioned counts readback per beat lives with the caller
(``scheduling/sharded_delta.py``).

The reference's shard-local programs are XLA ``shard_map`` bodies, not
Pallas kernels.  Their class scan, the water-fill of every class with its
collectives (``ShardPlane._scan``), is the hand-written CUDA kernel
``shard_scan`` (``csrc/shard_scan.cu``) for ranks that share one card: one
launch a scan, the ranks exchanging through global memory inside it.  Its
plain version ``shard_scan_plain`` runs the scan rank by rank over a
``_Transport``; CPU ranks take it, and so do ranks on distinct cards, whose
collectives are NCCL calls between the steps (``ShardPlane.scan_route``
names the route the mesh chose).  On that route the rest of the beat is
the two kernels of the single-device beat (``hybrid_kernel.beat_rows``
and ``beat_tail``, ``csrc/beat.cu``), each launched once for every rank:
the dirty rows, overrides and class gather before the scan, the packed
counts and budgets and the cross-rank argmin after it, so a beat on one
card makes no transport call.  CPU ranks and distinct cards run the
per-rank plain programs with the transport's collectives.  Everything
stays int32 under the contract, so counts are bit-identical to
``schedule_grouped_oracle`` at any shard count.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..scheduling.contract import AVAIL_SHIFT, MAX_NODES, SCALE
from . import hybrid_kernel as hk

_BIG = hk._BIG
_INF_KEY = hk._INF_KEY
_IDX_MASK = MAX_NODES - 1
_I32 = torch.int32
# ncclRedOp_t
_NCCL_OPS = {"sum": 0, "min": 3}


def resolve_shards(requested: int, n_devices: int) -> int:
    """Effective shard count: 0 => one shard per rank, clamped to the
    rank count and rounded DOWN to a power of two so the bucketed node
    axis (always a power of two >= 64) divides evenly and global
    traversal indices stay inside the packed key's NODE_BITS."""
    s = n_devices if requested <= 0 else min(requested, n_devices)
    s = max(s, 1)
    return 1 << (s.bit_length() - 1)


def local_ranks(device=None) -> list:
    """The ranks a plane spans when the caller names none: every local
    CUDA card (the reference's ``jax.local_devices()``), the card
    ``device`` names first, or the one rank of ``device`` when that is
    not CUDA (``device="cpu"``).  None means the GPU; without CUDA that
    raises (``device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.index is None:
        return cards
    return [dev] + [c for c in cards if c != dev]


def _rank_device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class RankMesh:
    """The port's two-level mesh: ``devices`` is an object array of
    ``torch.device`` of shape (slices, ranks per slice) with the
    reference's axis names; ``ranks()`` flattens it dcn-major, the
    order of ``P(("dcn", "ici"))``."""

    axis_names = ("dcn", "ici")

    def __init__(self, grid: np.ndarray):
        self.devices = grid

    def ranks(self) -> list:
        return list(self.devices.reshape(-1))


def build_mesh(n_shards: int, reduce_mode: str = "auto", devices=None):
    """Two-level ``("dcn", "ici")`` grid over the first ``n_shards``
    ranks of ``devices`` (None: the local CUDA cards).

    ``reduce_mode``:
      - "flat": one slice, shape (1, S); the dcn axis is degenerate and
        the cross-shard reduce is one ici pmin/psum.
      - "two_level": shape (2, S//2) (flat when S is odd or 1).
      - "auto": flat.  The reference derives slices from the devices'
        ``slice_index``; GPUs have none.
    """
    devs = [_rank_device(d) for d in
            (local_ranks() if devices is None else devices)][:n_shards]
    s = len(devs)
    n_slices = 2 if reduce_mode == "two_level" and s >= 2 and s % 2 == 0 \
        else 1
    grid = np.empty((s,), dtype=object)
    grid[:] = devs
    return RankMesh(grid.reshape(n_slices, s // n_slices))


class _Transport:
    """The plane's collectives over per-rank tensors (lists in rank
    order).  Ranks on distinct CUDA cards reduce with NCCL's
    single-process, multi-device calls; ranks that all share one device
    (the CPU, or S ranks on one card) stack their slices there and
    reduce.  ``calls`` counts the collectives issued."""

    def __init__(self, mesh: RankMesh):
        self.ranks = mesh.ranks()
        self.n_dcn, self.n_ici = mesh.devices.shape
        distinct = set(self.ranks)
        if len(distinct) == 1:
            self.nccl = False
        elif all(d.type == "cuda" for d in self.ranks) and \
                len(distinct) == len(self.ranks):
            self.nccl = True
        else:
            raise ValueError(
                f"a shard plane's ranks are distinct CUDA cards or all on "
                f"one device, not {[str(d) for d in self.ranks]}")
        self.calls = 0

    def _groups(self, axis: str):
        ici, dcn = self.n_ici, self.n_dcn
        if axis == "ici":                       # within each slice
            return [[i * ici + j for j in range(ici)] for i in range(dcn)]
        return [[i * ici + j for i in range(dcn)] for j in range(ici)]

    def _reduce(self, xs: list, axis: str, op: str) -> list:
        out = list(xs)
        for grp in self._groups(axis):
            if len(grp) == 1:
                continue
            parts = [xs[r].contiguous() for r in grp]
            if self.nccl:
                from torch.cuda import nccl
                flat = [p.reshape(-1) for p in parts]
                res = [torch.empty_like(p) for p in flat]
                nccl.all_reduce(flat, res, op=_NCCL_OPS[op])
                res = [y.reshape(parts[0].shape) for y in res]
            else:
                st = torch.stack(parts)
                # int32 sums wrap mod 2**32, as XLA's psum does
                red = st.sum(0, dtype=st.dtype) if op == "sum" \
                    else st.amin(0)
                res = [red] * len(parts)
            for r, y in zip(grp, res):
                out[r] = y
        return out

    def psum2(self, xs: list) -> list:
        """Two-level sum: within each slice over ici, then across
        slices over dcn (int32 wraps as XLA's psum does)."""
        self.calls += 1
        return self._reduce(self._reduce(xs, "ici", "sum"), "dcn", "sum")

    def pmin2(self, xs: list) -> list:
        """Two-level min: ici within a slice, dcn across slices."""
        self.calls += 1
        return self._reduce(self._reduce(xs, "ici", "min"), "dcn", "min")

    def psum(self, xs: list, axis: str) -> list:
        """One level of ``psum2`` (the dry run's slice-local sync)."""
        self.calls += 1
        return self._reduce(xs, axis, "sum")

    def all_gather(self, xs: list) -> list:
        """Every rank gets the (S, ...) stack of all ranks' slices in
        rank order.  Ranks are listed dcn-major, so this is the
        reference's gather over ici and then dcn, flattened."""
        self.calls += 1
        parts = [x.contiguous() for x in xs]
        if self.nccl:
            from torch.cuda import nccl
            outs = [torch.empty((len(parts), *p.shape), dtype=p.dtype,
                                device=p.device) for p in parts]
            nccl.all_gather([p.reshape(-1) for p in parts],
                            [o.reshape(-1) for o in outs])
            return outs
        st = torch.stack(parts)
        return [st] * len(parts)

    def gather(self, xs: list, dim: int) -> torch.Tensor:
        """The blocks concatenated along ``dim`` on the first rank (a
        replicated output's gather; peer copies between cards)."""
        self.calls += 1
        home = self.ranks[0]
        return torch.cat([x.to(home) for x in xs], dim=dim)


def _keys_block(totals_l, avail_l, mask_l, reqs, thr_fp, offset):
    """Packed keys of the C requests ``reqs`` vs THIS rank's node rows,
    with the GLOBAL traversal index in the low bits: (C, n_local).  The
    reference's ``_keys_block`` is one request, vmapped by its callers."""
    rows = offset + torch.arange(totals_l.shape[0], dtype=_I32,
                                 device=totals_l.device)
    return hk._keys(totals_l, avail_l, mask_l, reqs, thr_fp, rows)


def _i32sum(x):
    """int32 sum that wraps like XLA's, in one reduction."""
    return x.sum(dtype=_I32)


def _slots_at_or_below_l(L, totals_l, num0_l, denom, req_pos, m_max_l,
                         thr_fp):
    """Shard-local m_n(L): ``hybrid_kernel._slots_at_or_below``'s closed
    form on this rank's rows, with its level-free terms computed once a
    class: ``num0_l = -used * SCALE - 1`` and ``denom = max(req * SCALE,
    1)`` (int32 sums wrap, so the regrouping is bit-exact).  Levels below
    thr_fp collapse onto thr_fp - 1, so ``Lp + 1`` is ``max(L + 1,
    thr_fp)``."""
    lp1 = (L + 1).clamp_min(thr_fp)
    jc = hk._floordiv(lp1 * totals_l + num0_l, denom).clamp(0, _BIG)
    jcount = torch.where(req_pos[None, :], jc, _BIG).amin(dim=1)
    return torch.minimum(m_max_l, jcount)


def _schedule_group_sharded(tp, avail, totals, mask, req, count, thr_fp,
                            offsets, require_available):
    """Shard-local water-fill for one class, every argument a list of
    per-rank tensors (req and count replicated).  Every global reduction
    of ``hybrid_kernel._schedule_group`` goes through ``tp``.  Returns
    (alloc rows (n_local,) per rank, inf_count 0-d per rank, new avail
    per rank)."""
    ranks = range(len(avail))
    num0, denom, req_pos, m_max = [], [], [], []
    for r in ranks:
        rp = req[r] > 0
        feas = torch.where(rp[None, :], totals[r] >= req[r][None, :],
                           True).all(dim=1) & mask[r]
        caps = torch.where(rp[None, :], hk._floordiv(
            avail[r], req[r].clamp_min(1)[None, :]), _BIG)
        m_max.append(torch.where(feas & rp.any(),
                                 caps.amin(dim=1).clamp(0, _BIG),
                                 0).to(_I32))
        num0.append((avail[r] - totals[r]) * SCALE - 1)
        denom.append((req[r] * SCALE).clamp_min(1)[None, :])
        req_pos.append(rp)

    def m_of(r, L):
        return _slots_at_or_below_l(L, totals[r], num0[r], denom[r],
                                    req_pos[r], m_max[r], thr_fp)

    total_cap = tp.psum2([_i32sum(m) for m in m_max])
    n_avail = [torch.minimum(count[r], total_cap[r]) for r in ranks]
    overflow = [count[r] - n_avail[r] for r in ranks]

    lo = [torch.zeros((), dtype=_I32, device=a.device) for a in avail]
    hi = [torch.full((), 2 * SCALE, dtype=_I32, device=a.device)
          for a in avail]
    for _ in range(hk._BISECT_STEPS):
        mid = [hk._floordiv(lo[r] + hi[r], 2) for r in ranks]
        tot = tp.psum2([_i32sum(m_of(r, mid[r])) for r in ranks])
        ok = [tot[r] >= n_avail[r] for r in ranks]
        lo = [torch.where(ok[r], lo[r], mid[r] + 1) for r in ranks]
        hi = [torch.where(ok[r], mid[r], hi[r]) for r in ranks]

    base = [torch.where(lo[r] > 0, m_of(r, (lo[r] - 1).clamp_min(0)), 0)
            for r in ranks]
    extra = [(m_of(r, lo[r]) - base[r]).to(_I32) for r in ranks]
    base_sum = tp.psum2([_i32sum(b) for b in base])
    # global exclusive prefix in traversal order: the local cumsum plus
    # the level-set mass of every PRECEDING rank (row blocks are
    # contiguous in rank order, so "preceding rank" == "lower rows")
    g_all = tp.all_gather([_i32sum(e) for e in extra])
    alloc, inf_count, new_avail, okeys = [], [], [], []
    for r in ranks:
        rem = n_avail[r] - base_sum[r]
        before = _i32sum(g_all[r][:r])
        prefix = (torch.cumsum(extra[r], 0) - extra[r] + before).to(_I32)
        give = torch.minimum((rem - prefix).clamp_min(0), extra[r])
        alloc.append((base[r] + give).to(_I32))
        new_avail.append((avail[r] - alloc[r][:, None] * req[r][None, :]
                          ).to(_I32))
        okeys.append(_keys_block(totals[r], new_avail[r], mask[r],
                                 req[r][None], thr_fp, offsets[r])[0])
    # overflow: the two-level argmin reduce.  The local packed min
    # carries the global node index; pmin over ici then dcn is exact.
    gmin = tp.pmin2([k.amin() for k in okeys])
    for r in ranks:
        n_l = totals[r].shape[0]
        queue_ok = gmin[r] != _INF_KEY
        if require_available:
            queue_ok = queue_ok & (((gmin[r] >> AVAIL_SHIFT) & 1) == 0)
        # the overflow lands in the owning rank's column; every other
        # rank drops it (a negative local position must not wrap around:
        # it goes to the scratch slot n_l, which is cut off)
        local_pos = (gmin[r] & _IDX_MASK) - offsets[r]
        mine = queue_ok & (local_pos >= 0) & (local_pos < n_l)
        row = torch.cat([alloc[r], alloc[r].new_zeros(1)])
        row.index_add_(0, torch.where(mine, local_pos, n_l).long()
                       .reshape(1),
                       torch.where(mine, overflow[r], 0).reshape(1)
                       .to(_I32))
        alloc[r] = row[:n_l]
        inf_count.append(torch.where(queue_ok, 0, overflow[r]).to(_I32))
    return alloc, inf_count, new_avail


def shard_scan_plain(tp, totals, avail, mask, group_reqs, group_counts,
                     group_masks, thr_fp, require_available):
    """Plain version of ``shard_scan``: the class scan rank by rank, G
    water-fills in order carrying avail, every global reduction a
    collective of the transport ``tp``.  Returns (alloc (G, n_local) per
    rank, inf (G,) on the first rank, final avail per rank)."""
    off = [i * totals[0].shape[0] for i in range(len(totals))]
    av = list(avail)
    rows: list[list] = [[] for _ in totals]
    inf = []
    for gi in range(group_reqs[0].shape[0]):
        m = mask if group_masks is None else \
            [mk & gm[gi] for mk, gm in zip(mask, group_masks)]
        alloc, inf_c, av = _schedule_group_sharded(
            tp, av, totals, m, [gr[gi] for gr in group_reqs],
            [gc[gi] for gc in group_counts], thr_fp, off, require_available)
        for r, a in enumerate(alloc):
            rows[r].append(a)
        inf.append(inf_c[0])
    return [torch.stack(r) for r in rows], torch.stack(inf), av


# cudaErrorCooperativeLaunchTooLarge: the card cannot hold every rank at once
_TOO_LARGE = 720
_PLANS: dict = {}
_LAYOUT_KEYS = ("cluster", "threads", "on_chip", "smem_bytes",
                "resident_ranks", "exchange_ints", "route", "rank_ctas")
_ROUTES = ("global", "cluster")


def _layout(raw) -> dict:
    out = dict(zip(_LAYOUT_KEYS, raw))
    out["route"] = _ROUTES[out["route"]]
    return out


def shard_scan_plan(s: int, n_local: int, r: int,
                    require_available: bool = False, device=None) -> dict:
    """The launch ``shard_scan`` makes on the card for ``s`` ranks of
    ``n_local`` rows x ``r`` columns (``csrc/shard_scan.cu`` plan()): the
    ``route`` ("cluster": every rank's CTAs in one thread-block cluster of
    ``cluster`` CTAs; "global": a cooperative grid, ``cluster`` 1, the
    ranks exchanging through their exchange areas), CTAs a rank
    (``rank_ctas``), threads a CTA, rows in shared memory or not, its
    bytes, how many ranks the card holds at once (``resident_ranks``; a
    larger mesh raises) and the ints of a rank's exchange area (0 on the
    cluster route).  Asks the library once a shape and card."""
    from . import _build

    dev = _rank_device("cuda" if device is None else device)
    key = (dev.index, s, n_local, r, bool(require_available))
    plan = _PLANS.get(key)
    if plan is None:
        layout = (ctypes.c_int * len(_LAYOUT_KEYS))()
        fn = _build.load("shard_scan", "rt_shard_scan_plan")
        with torch.cuda.device(dev):
            err = fn(s, n_local, r, int(bool(require_available)),
                     ctypes.addressof(layout))
        if err != 0:
            raise ValueError(
                f"shard_scan: no launch for {s} ranks of {n_local} x {r} "
                f"(CUDA error {err}): S * n_local must be <= {MAX_NODES} "
                f"and a class's arrays must fit a CTA's shared memory")
        plan = _PLANS[key] = _layout(layout)
    return plan


def shard_scan(totals, avail, mask, group_reqs, group_counts, group_masks,
               thr_fp, require_available=False, transport=None, out=None):
    """The class scan of a row-sharded plane: G water-fills in order over
    the S ranks' rows, carrying avail, each class's sums, prefix and
    overflow argmin taken over every rank (the reference's
    ``_schedule_group_sharded``, G times).  Every argument but ``thr_fp``
    is a list of per-rank tensors in rank order: totals/avail (n_local, R)
    int32, mask (n_local,) bool, group_reqs (G, R) and group_counts (G,)
    int32 (each rank's copy), group_masks (G, n_local) bool or None.
    Returns (alloc (G, n_local) int32 per rank, inf (G,) int32 on the
    first rank's device, final avail (n_local, R) int32 per rank).

    CPU tensors take ``shard_scan_plain`` over ``transport`` (a flat one
    over the tensors' ranks when None).  CUDA tensors, all on one card,
    launch the hand-written kernel (``csrc/shard_scan.cu``), one launch
    for every rank (one thread-block cluster where every rank's CTAs fit
    one, else a cooperative grid; ``shard_scan_plan``), or raise:
    ``ValueError`` for what the kernel does not take, a mesh the card
    cannot hold at once included; a launch that fails raises, on either
    route.  ``out`` (CUDA only): the outputs and exchange areas to use,
    kept by the caller from call to call (``BeatState.ensure_scan_buffers``:
    alloc (S, >= G, n_local), new_avail (S, n_local, R), inf (>= G,) and
    xchg (S, >= exchange_ints, each rank's row 16-byte aligned), the
    exchange areas zeroed by the caller on the stream, as ``beat_rows``
    does); else they are allocated and zeroed here.  The table of per-rank pointers is built once per set of
    pointers (``hybrid_kernel.rank_table``).  ``shard_scan.launches``
    counts the launches and ``shard_scan.last_layout`` holds the last one
    (``shard_scan_plan``)."""
    s = len(totals)
    dev = totals[0].device
    if dev.type == "cpu":
        if transport is None:
            transport = _Transport(build_mesh(s, "flat", [dev] * s))
        return shard_scan_plain(transport, totals, avail, mask, group_reqs,
                                group_counts, group_masks, thr_fp,
                                require_available)
    if dev.type != "cuda":
        raise ValueError(f"shard_scan: unsupported device {dev}")
    from . import _build

    n_l, r = totals[0].shape
    g = group_reqs[0].shape[0]
    lists = {"totals": (totals, _I32, (n_l, r)),
             "avail": (avail, _I32, (n_l, r)),
             "mask": (mask, torch.bool, (n_l,)),
             "group_reqs": (group_reqs, _I32, (g, r)),
             "group_counts": (group_counts, _I32, (g,))}
    if group_masks is not None:
        lists["group_masks"] = (group_masks, torch.bool, (g, n_l))
    for name, (ts, dtype, shape) in lists.items():
        if len(ts) != s:
            raise ValueError(f"shard_scan: {len(ts)} {name} for {s} ranks")
        for t in ts:
            if t.device != dev or t.dtype != dtype or \
                    tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"shard_scan: {name} must be contiguous {dtype} "
                    f"tensors of shape {shape} on {dev} (ranks on one "
                    f"card); got {t.dtype} {tuple(t.shape)} on {t.device}")
    plan = shard_scan_plan(s, n_l, r, require_available, dev)
    if plan["resident_ranks"] < s:
        raise ValueError(
            f"shard_scan: {s} ranks of {plan['rank_ctas']} CTA(s) cannot all "
            f"be resident on {dev} (at most {plan['resident_ranks']}); "
            f"the ranks wait on each other inside the launch")
    if out is None:
        alloc = torch.empty((s, g, n_l), dtype=_I32, device=dev)
        new_avail = torch.empty((s, n_l, r), dtype=_I32, device=dev)
        inf = torch.empty((g,), dtype=_I32, device=dev)
        xchg = torch.zeros((s, plan["exchange_ints"]), dtype=_I32,
                           device=dev)
    else:
        alloc, new_avail = out["alloc"], out["new_avail"]
        inf, xchg = out["inf"], out["xchg"]
        if alloc.device != dev or tuple(alloc.shape[::2]) != (s, n_l) or \
                alloc.shape[1] < g or tuple(new_avail.shape) != (s, n_l, r) \
                or inf.shape[0] < g or xchg.shape[0] != s or \
                xchg.shape[1] < plan["exchange_ints"] or \
                (plan["exchange_ints"] and
                 any(x.data_ptr() % 16 for x in xchg)):
            raise ValueError(f"shard_scan: out does not hold {s} ranks of "
                             f"{g} classes x {n_l} x {r}")
        alloc, inf = alloc[:, :g], inf[:g]
    # the kernel's table: one row of pointers a rank (RankPtrs)
    table = hk.rank_table(
        [[totals[i].data_ptr(), avail[i].data_ptr(), mask[i].data_ptr(),
          group_reqs[i].data_ptr(), group_counts[i].data_ptr(),
          0 if group_masks is None else group_masks[i].data_ptr(),
          alloc[i].data_ptr(), new_avail[i].data_ptr(),
          inf.data_ptr() if i == 0 else 0, xchg[i].data_ptr()]
         for i in range(s)], dev)
    layout = (ctypes.c_int * len(_LAYOUT_KEYS))()
    fn = _build.load("shard_scan")
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), s, n_l, r, g, int(thr_fp),
                 int(bool(require_available)), ctypes.addressof(layout),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err == _TOO_LARGE:
        raise ValueError(f"shard_scan: {s} ranks cannot all be resident "
                         f"on {dev}")
    _build.check(err, "shard_scan")
    shard_scan.launches += 1
    shard_scan.last_layout = _layout(layout)
    return list(alloc), inf, list(new_avail)


shard_scan.launches = 0
shard_scan.last_layout = None


class ShardPlane:
    """The row-sharded programs for one rank mesh.

    Residents are lists of per-rank tensors in rank order:

      totals/avail  (n_local, R)   rows by rank
      mask          (n_local,)
      keys          (C, n_local)   key COLUMNS by rank
      reqs          (C, R)         replicated (one copy a rank)

    Per-rank host->device buckets (dirty rows, overrides) are indexed by
    LOCAL row; padding == n_local, dropped by the scatter.
    """

    def __init__(self, mesh: RankMesh):
        self.mesh = mesh
        self.ranks = mesh.ranks()
        self.n_shards = len(self.ranks)
        self.transport = _Transport(mesh)
        # the class scan's route, chosen by the mesh: "shard_scan" (the
        # kernel) for ranks on one card, "nccl" (shard_scan_plain over
        # NCCL) for distinct cards, "plain" for CPU ranks
        if self.transport.nccl:
            self.scan_route = "nccl"
        elif self.ranks[0].type == "cuda":
            self.scan_route = "shard_scan"
        else:
            self.scan_route = "plain"
        self.last_scan_route = None

    # -- placement (copies: the CRM's host arrays are read-only views) ------
    def shard_rows(self, host, dtype) -> list:
        """Rank i gets row block i of ``host`` (rows divide the ranks)."""
        return [torch.tensor(np.ascontiguousarray(b, dtype), device=d)
                for b, d in zip(np.split(np.asarray(host), self.n_shards),
                                self.ranks)]

    def shard_cols(self, host, dtype) -> list:
        """Rank i gets column block i of a (G, N) array."""
        return [torch.tensor(np.ascontiguousarray(b, dtype), device=d)
                for b, d in zip(np.split(np.asarray(host), self.n_shards,
                                         axis=1), self.ranks)]

    def replicate(self, host, dtype) -> list:
        """Every rank gets ``host``: one upload a distinct device."""
        host = np.ascontiguousarray(host, dtype)
        per_dev = {d: torch.tensor(host, device=d)
                   for d in dict.fromkeys(self.ranks)}
        return [per_dev[d] for d in self.ranks]

    def gather(self, xs: list, dim: int = 0) -> torch.Tensor:
        return self.transport.gather(xs, dim)

    def _offsets(self, n_local: int) -> list:
        return [i * n_local for i in range(self.n_shards)]

    # -- the heartbeat's programs ---------------------------------------------
    #
    # On ranks of one card (scan_route "shard_scan") each program is the
    # beat's kernels (hybrid_kernel.beat_rows / beat_tail), one launch for
    # every rank, and the residents are updated in place and returned; CPU
    # ranks and distinct cards run the per-rank plain programs, which return
    # new tensors.

    @property
    def on_card(self) -> bool:
        """Every rank on one card: the kernel route."""
        return self.scan_route == "shard_scan"

    def full_rescore(self, totals, avail, mask, reqs, thr_fp) -> list:
        """(C, n_local) key columns of every rank."""
        if self.on_card:
            st = hk.BeatState(totals, avail, mask, reqs)
            st.alloc_keys()
            hk.beat_rows(st, thr_fp, rescore=True)
            return st.keys
        off = self._offsets(totals[0].shape[0])
        return [hk.full_rescore(t, a, m, rq, thr_fp, o)
                for t, a, m, rq, o in zip(totals, avail, mask, reqs, off)]

    def apply_dirty_rows(self, totals, avail, mask, keys, reqs, idx,
                         row_totals, row_avail, row_mask, thr_fp):
        """Scatter each rank's dirty-row bucket into ITS rows and
        re-score only its touched key columns."""
        if self.on_card:
            st = hk.BeatState(totals, avail, mask, reqs, keys)
            hk.beat_rows(st, thr_fp, rows=tuple(hk.spaced(x) for x in (
                idx, row_totals, row_avail, row_mask)))
            return st.totals, st.avail, st.mask, st.keys
        off = self._offsets(totals[0].shape[0])
        out = ([], [], [], [])
        for r, o in enumerate(off):
            for lst, x in zip(out, hk.apply_dirty_rows(
                    totals[r], avail[r], mask[r], keys[r], reqs[r], idx[r],
                    row_totals[r], row_avail[r], row_mask[r], thr_fp, o)):
                lst.append(x)
        return out

    def apply_dirty_classes(self, totals, avail, mask, keys, reqs, idx,
                            class_reqs, thr_fp):
        """Install B new classes (replicated reqs scatter) and re-score
        their key rows rank by rank.  Padding idx == C."""
        if self.on_card:
            st = hk.BeatState(totals, avail, mask, reqs, keys)
            hk.beat_rows(st, thr_fp, classes=(hk.spaced(idx),
                                              hk.spaced(class_reqs)))
            return st.reqs, st.keys
        off = self._offsets(totals[0].shape[0])
        new_reqs, new_keys = [], []
        for r, o in enumerate(off):
            rq, k = hk.apply_dirty_classes(
                totals[r], avail[r], mask[r], keys[r], reqs[r], idx[r],
                class_reqs[r], thr_fp, o)
            new_reqs.append(rq)
            new_keys.append(k)
        return new_reqs, new_keys

    def _scan(self, totals, avail, mask, group_reqs, group_counts,
              group_masks, thr_fp, require_available, out=None):
        """The class scan on the mesh's route (``scan_route``): returns
        (alloc (G, n_local) per rank, inf (G,) on the first rank, final
        avail per rank).  ``out``: the kernel's kept outputs
        (``shard_scan``)."""
        self.last_scan_route = self.scan_route
        if self.scan_route == "nccl":
            return shard_scan_plain(self.transport, totals, avail, mask,
                                    group_reqs, group_counts, group_masks,
                                    thr_fp, require_available)
        return shard_scan(totals, avail, mask, group_reqs, group_counts,
                          group_masks, thr_fp, require_available,
                          transport=self.transport, out=out)

    def _card_beat(self, st, thr_fp, require_available, rows=None,
                   overrides=None, extra_mask=None, groups=None,
                   classes=None):
        """A beat on ranks of one card: ``beat_rows`` (the class install
        first, where there is one), the ``shard_scan`` launch on the kept
        buffers whose exchange areas ``beat_rows`` zeroed, ``beat_tail``."""
        g = groups[0][0].shape[0]
        n_l, r = st.totals[0].shape
        st.ensure_scan_buffers(g, shard_scan_plan(
            self.n_shards, n_l, r, require_available,
            st.totals[0].device)["exchange_ints"])
        if classes is not None:
            hk.beat_rows(st, thr_fp, classes=classes)
        hk.beat_rows(st, thr_fp, rows=rows, overrides=overrides,
                     extra_mask=extra_mask, groups=groups)
        alloc, inf, av_fin = self._scan(
            st.totals, st.avail_eff, st.mask_eff,
            [x[:g] for x in st.group_reqs], [x[:g] for x in st.group_counts],
            None, thr_fp, require_available, st.scan_out)
        return hk.beat_tail(st, alloc, inf, av_fin)

    def beat(self, st, inputs, thr_fp, require_available=False):
        """One heartbeat of ``ShardedDeltaScheduler`` on the residents
        ``st`` (a ``hybrid_kernel.BeatState``): ``inputs`` holds the
        per-rank views of the beat's staged upload (``slots``, ``counts``;
        where the beat has them ``idx``/``rows_totals``/``rows_avail``/
        ``rows_mask``, ``ov_idx``/``ov_avail``, ``extra_mask`` and the
        class install's ``cls_idx``/``cls_reqs``).  The residents take the
        dirty rows and classes.  Returns (packed, amin) on the first rank,
        as ``fused_beat``."""
        kw = hk.beat_inputs(inputs)
        rows, classes, overrides, groups, em = (kw[k] for k in (
            "rows", "classes", "overrides", "groups", "extra_mask"))
        if self.on_card:
            return self._card_beat(st, thr_fp, require_available, rows,
                                   overrides, em, groups, classes)
        if classes is not None:
            st.reqs, st.keys = self.apply_dirty_classes(
                st.totals, st.avail, st.mask, st.keys, st.reqs, *classes,
                thr_fp)
        if rows is not None:
            st.totals, st.avail, st.mask, st.keys = self.apply_dirty_rows(
                st.totals, st.avail, st.mask, st.keys, st.reqs, *rows,
                thr_fp)
        if overrides is None:
            overrides = ([x[:0] for x in inputs["counts"]],
                         [a[:0] for a in st.avail])
        return self.fused_beat(st.totals, st.avail, st.mask, st.keys,
                               st.reqs, *groups,
                               st.mask if em is None else em, *overrides,
                               thr_fp, require_available)

    def schedule_grouped(self, totals, avail, node_mask, group_reqs,
                         group_counts, group_masks, thr_fp,
                         require_available=False):
        """``hybrid_kernel.schedule_grouped`` with node rows on the
        ranks: (counts (G, N+1) on the first rank, new_avail per rank)."""
        alloc, inf, av = self._scan(totals, avail, node_mask, group_reqs,
                                    group_counts, group_masks, thr_fp,
                                    require_available)
        counts = torch.cat([self.gather(alloc, 1), inf[:, None]], dim=1)
        return counts, av

    def schedule_grouped_np(self, totals, avail, node_mask, group_reqs,
                            group_counts, group_masks, thr_fp):
        """Host arrays in and out: node rows padded to a rank multiple
        with mask-False rows (no-ops), placed on the ranks block by
        block, scheduled, and the padding cut from the result (before
        the infeasible column).  On one rank this is the single-device
        call (on a card: ``waterfill_scan``), as the reference's jit over
        a one-device mesh is.  Returns (counts (G, N+1), new_avail
        (N, R))."""
        if self.n_shards == 1:
            return hk.schedule_grouped_np(
                totals, avail, node_mask, group_reqs, group_counts,
                group_masks, int(thr_fp), device=self.ranks[0])
        n = totals.shape[0]
        pad = pad_node_rows(n, self.n_shards)
        if pad:
            totals = np.pad(totals, ((0, pad), (0, 0)))
            avail = np.pad(avail, ((0, pad), (0, 0)))
            node_mask = np.pad(node_mask, (0, pad))
            group_masks = np.pad(group_masks, ((0, 0), (0, pad)))
        counts, av = self.schedule_grouped(
            self.shard_rows(totals, np.int32),
            self.shard_rows(avail, np.int32),
            self.shard_rows(node_mask, bool),
            self.replicate(group_reqs, np.int32),
            self.replicate(group_counts, np.int32),
            self.shard_cols(group_masks, bool), int(thr_fp))
        # the host wrapper's results: its deliberate readbacks
        counts = counts.cpu().numpy()  # rtlint: disable=W6
        new_avail = np.concatenate(
            [a.cpu().numpy() for a in av])  # rtlint: disable=W6
        if pad:
            counts = np.concatenate([counts[:, :n], counts[:, -1:]], axis=1)
            new_avail = new_avail[:n]
        return counts, new_avail

    def fused_beat(self, totals, avail, mask, keys, reqs, class_slots,
                   group_counts, extra_mask, ov_idx, ov_avail, thr_fp,
                   require_available=False):
        """One sharded heartbeat: per-rank ephemeral overrides and soft
        mask, the G-class water-fill scan with two-level collectives,
        each rank's lease budgets priced off its own rows' final avail
        (``contract.compute_budgets``; node-local, so sharding it is
        exact), and the carried-key argmin via the ici->dcn pmin.  On
        ranks of one card: ``beat_rows``, ``shard_scan`` and
        ``beat_tail``, no transport call (the residents are not
        changed).

        Returns (packed (G + C, N+1) int32 on the first rank: rows [:G]
        the counts with the overflow column, rows [G:] the budgets;
        amin (C,) int32 on the first rank)."""
        if self.on_card:
            st = hk.BeatState(totals, avail, mask, reqs, keys)
            return self._card_beat(
                st, thr_fp, require_available,
                overrides=(hk.spaced(ov_idx), hk.spaced(ov_avail)),
                extra_mask=hk.spaced(extra_mask),
                groups=(hk.spaced(class_slots), hk.spaced(group_counts)))
        a_eff = [hk._drop_set(a, i, v)
                 for a, i, v in zip(avail, ov_idx, ov_avail)]
        m_eff = [m & e for m, e in zip(mask, extra_mask)]
        group_reqs = [rq[s.long().clamp(0, rq.shape[0] - 1)]
                      for rq, s in zip(reqs, class_slots)]
        alloc, inf, av_fin = self._scan(totals, a_eff, m_eff, group_reqs,
                                        group_counts, None, thr_fp,
                                        require_available)
        budgets = [hk._budgets(t, a, m, rq)
                   for t, a, m, rq in zip(totals, av_fin, m_eff, reqs)]
        gmin = self.transport.pmin2([k.amin(dim=1) for k in keys])[0]
        amin = torch.where(gmin == _INF_KEY, 0, gmin & _IDX_MASK).to(_I32)
        packed = torch.cat(
            [torch.cat([self.gather(alloc, 1), inf[:, None]], dim=1),
             torch.nn.functional.pad(self.gather(budgets, 1), (0, 1))],
            dim=0)
        return packed, amin

    # -- kernels run on the first rank over every rank's rows -----------------
    def call_gathered(self, fn, *args):
        """Run the single-device ``fn`` on the first rank over every
        rank's rows, the way GSPMD runs an op it cannot partition: each
        ``(host, dtype)`` argument is uploaded whole to the first rank
        (other arguments pass as they are), and ``fn``'s last output,
        new_avail, is split back to the ranks by rows.  The localized,
        top-k and autoscale host wrappers take it: their rows arrive as
        host arrays and leave as host arrays, so placing them on the
        ranks moves the same bytes to the cards as this upload does, and
        the reference's saving (rows that stay sharded on the devices
        are never all-gathered) does not arise.  On ranks of one card
        the single-device kernel beats a shard-local scan's per-rank
        staging, and on distinct cards it beats the plain scan's
        per-class collectives.  A shard-local form waits for a caller
        that keeps node rows on the ranks.  Returns (outputs but the
        last, new_avail blocks per rank)."""
        home = self.ranks[0]

        def put(a):
            if not isinstance(a, tuple):
                return a
            host, dtype = a
            return None if host is None else torch.tensor(
                np.ascontiguousarray(host, dtype), device=home)

        *outs, new_avail = fn(*map(put, args))
        return outs, [b.to(d) for b, d in
                      zip(new_avail.chunk(self.n_shards), self.ranks)]


_PLANES: dict = {}


def plane_for(n_shards: int, reduce_mode: str = "auto",
              devices=None) -> ShardPlane:
    """Process-wide ShardPlane cache: one plane per (shard count, reduce
    topology, ranks) — engines come and go per raylet, the planes (and
    the NCCL communicators behind them) should not."""
    mesh = build_mesh(n_shards, reduce_mode, devices)
    key = (mesh.devices.shape, tuple(str(d) for d in mesh.ranks()))
    plane = _PLANES.get(key)
    if plane is None:
        plane = _PLANES[key] = ShardPlane(mesh)
    return plane


def gspmd_plane(n_shards: int = 0, reduce_mode: str = "auto",
                devices=None) -> ShardPlane:
    """Resolve + cache the ShardPlane for the ``*_sharded_np`` wrappers
    (hybrid/locality/topk/binpack).  Callers pad the node axis to a
    multiple of ``plane.n_shards`` with mask-False rows (no-ops)."""
    ranks = local_ranks() if devices is None else list(devices)
    return plane_for(resolve_shards(n_shards, len(ranks)), reduce_mode,
                     ranks)


def pad_node_rows(n: int, n_shards: int) -> int:
    """Rows of padding needed so the node axis divides the shard count."""
    return (-n) % max(n_shards, 1)

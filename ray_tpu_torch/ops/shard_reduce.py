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
Pallas kernels, so here they are plain PyTorch over each rank's tensors,
run rank by rank between the collectives.  Everything stays int32 under
the contract, so counts are bit-identical to ``schedule_grouped_oracle``
at any shard count.
"""

from __future__ import annotations

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


def _keys_cols_block(totals_l, avail_l, mask_l, reqs, idx_l, thr_fp,
                     offset):
    """Key columns for the B LOCAL node rows in ``idx_l`` against all C
    classes: (C, B).  Padding lanes (idx_l == n_local) gather the last
    row, as JAX's clamped gather does, and are dropped by the caller's
    scatter."""
    g = idx_l.long().clamp(0, totals_l.shape[0] - 1)
    return hk._keys(totals_l[g], avail_l[g], mask_l[g], reqs, thr_fp,
                    offset + idx_l.to(_I32))


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
    def full_rescore(self, totals, avail, mask, reqs, thr_fp) -> list:
        """(C, n_local) key columns of every rank."""
        off = self._offsets(totals[0].shape[0])
        return [_keys_block(t, a, m, rq, thr_fp, o)
                for t, a, m, rq, o in zip(totals, avail, mask, reqs, off)]

    def apply_dirty_rows(self, totals, avail, mask, keys, reqs, idx,
                         row_totals, row_avail, row_mask, thr_fp):
        """Scatter each rank's dirty-row bucket into ITS rows and
        re-score only its touched key columns."""
        off = self._offsets(totals[0].shape[0])
        out = ([], [], [], [])
        for r, o in enumerate(off):
            t = hk._drop_set(totals[r], idx[r], row_totals[r])
            a = hk._drop_set(avail[r], idx[r], row_avail[r])
            m = hk._drop_set(mask[r], idx[r], row_mask[r])
            cols = _keys_cols_block(t, a, m, reqs[r], idx[r], thr_fp, o)
            k = hk._drop_set(keys[r], idx[r], cols, dim=1)
            for lst, x in zip(out, (t, a, m, k)):
                lst.append(x)
        return out

    def apply_dirty_classes(self, totals, avail, mask, keys, reqs, idx,
                            class_reqs, thr_fp):
        """Install B new classes (replicated reqs scatter) and re-score
        their key rows rank by rank.  Padding idx == C."""
        off = self._offsets(totals[0].shape[0])
        new_reqs, new_keys = [], []
        for r, o in enumerate(off):
            new_reqs.append(hk._drop_set(reqs[r], idx[r], class_reqs[r]))
            rows = _keys_block(totals[r], avail[r], mask[r], class_reqs[r],
                               thr_fp, o)
            new_keys.append(hk._drop_set(keys[r], idx[r], rows))
        return new_reqs, new_keys

    def _scan(self, totals, avail, mask, group_reqs, group_counts,
              group_masks, thr_fp, require_available):
        """The class scan: G water-fills in order, carrying avail.
        Returns (alloc (G, n_local) per rank, inf (G,) on the first
        rank, final avail per rank)."""
        off = self._offsets(totals[0].shape[0])
        av = list(avail)
        rows: list[list] = [[] for _ in self.ranks]
        inf = []
        for gi in range(group_reqs[0].shape[0]):
            m = mask if group_masks is None else \
                [mk & gm[gi] for mk, gm in zip(mask, group_masks)]
            alloc, inf_c, av = _schedule_group_sharded(
                self.transport, av, totals, m,
                [gr[gi] for gr in group_reqs],
                [gc[gi] for gc in group_counts], thr_fp, off,
                require_available)
            for r, a in enumerate(alloc):
                rows[r].append(a)
            inf.append(inf_c[0])
        return [torch.stack(r) for r in rows], torch.stack(inf), av

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
        counts = counts.cpu().numpy()
        new_avail = np.concatenate([a.cpu().numpy() for a in av])
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
        exact), and the carried-key argmin via the ici->dcn pmin.

        Returns (packed (G + C, N+1) int32 on the first rank: rows [:G]
        the counts with the overflow column, rows [G:] the budgets;
        amin (C,) int32 on the first rank)."""
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
        new_avail, is split back to the ranks by rows.  A shard-local
        version is later work.  Returns (outputs but the last, new_avail
        blocks per rank)."""
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

"""Batched hybrid placement as dense device math, in PyTorch.

The port of ``ray_tpu/ops/hybrid_kernel.py``: the per-heartbeat batch of
pending tasks evaluated as one dense (classes x nodes x resources)
computation under the int32 scheduling contract
(``scheduling/contract.py``), bit-identical to the CPU oracle.

Within one scheduling class, sequential greedy placement onto min-key
nodes is a water-fill: find the smallest key level L* whose slot count
covers the class, take every slot below L*, and hand out the remaining
slots at L* in traversal order.  "Slots with key <= L" has a closed
integer form per (node, resource), so L* is a fixed 15-step bisection.
Classes run in order, carrying ``avail``.

That class loop — a ``lax.scan`` in the JAX package — is the hand-written
CUDA kernel ``waterfill_scan`` (``csrc/waterfill.cu``, one launch of a
thread-block cluster): eagerly, each class would cost ~45 small
launches.  Its plain PyTorch version ``waterfill_scan_plain`` repeats
the arithmetic as tensor ops; the wrapper takes it only for CPU
tensors.  The rest of the delta beat is two more hand-written kernels
(``csrc/beat.cu``), for one rank or for S ranks of a row-sharded plane
on one card: ``beat_rows`` before the scan (dirty-row scatters and
their key rescoring, the beat's overrides, soft mask and class gather;
a class install or a full rescore, spread over (row tile, class block)
CTAs with per-row magic divisors) and
``beat_tail`` after it (the packed counts and lease budgets, the
per-class argmin).  Their plain versions ``beat_rows_plain`` and
``beat_tail_plain`` are the functional programs below
(``apply_dirty_rows``, ``apply_dirty_classes``, ``full_rescore``,
``_budgets``, ``fused_beat``'s tail), written into the residents; the
wrappers take them only for CPU tensors.

All arithmetic is int32 and wraps as XLA's does; ``//`` floors on both.
torch's ``sum``/``cumsum`` widen int32 to int64, so every such result is
cast back to int32 (the wrap is the same modulo 2**32).
"""

from __future__ import annotations

import ctypes
import itertools
import operator

import numpy as np
import torch

from ..device import resolve_device
from ..scheduling.contract import (AVAIL_SHIFT, BUDGET_CAP, MAX_NODES, SCALE,
                                   SCORE_SHIFT)

_BIG = 1 << 30
_INF_KEY = 2**31 - 1
_BISECT_STEPS = SCALE.bit_length() + 2
_I32 = torch.int32


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _i32sum(x, dim=None):
    """int32 sum that wraps like XLA's (torch widens to int64)."""
    s = x.sum() if dim is None else x.sum(dim=dim)
    return s.to(_I32)


def _keys(totals, avail, mask, reqs, thr_fp, rows):
    """Packed int32 contract keys of C requests against B node rows.

    totals/avail: (B, R), mask: (B,), reqs: (C, R), rows: (B,) traversal
    indices for the low key bits.  Returns (C, B) int32 — the device twin
    of ``contract.compute_keys`` (``_keys_one_req``/``_keys_cols``)."""
    req_pos = (reqs > 0)[:, None, :]                        # (C, 1, R)
    t = totals[None]
    a = avail[None]
    r = reqs[:, None, :]
    feas = torch.where(req_pos, t >= r, True).all(dim=2) & mask[None]
    availb = torch.where(req_pos, a >= r, True).all(dim=2)
    denom = totals.clamp_min(1)[None]
    q = t - a + r
    s = torch.where(req_pos, _floordiv(q * SCALE, denom), 0)
    s = s.amax(dim=2).clamp_min(0)                          # initial=0
    eff = torch.where(availb & (s < thr_fp), 0, s)
    key = ((~availb).to(_I32) << AVAIL_SHIFT) | (eff << SCORE_SHIFT) \
        | rows.to(_I32)[None]
    return torch.where(feas, key, _INF_KEY).to(_I32)


def _keys_one_req(totals, avail, req, thr_fp, mask):
    """Packed keys of one request vs all nodes: (N,) int32."""
    n = totals.shape[0]
    rows = torch.arange(n, dtype=_I32, device=totals.device)
    return _keys(totals, avail, mask, req[None], thr_fp, rows)[0]


def _slots_at_or_below(L, totals, used, req, req_pos, m_max, thr_fp):
    """m_n(L): per-node count of placement slots with eff-score key <= L
    (levels below thr_fp collapse onto the level-0 count)."""
    Lp = torch.where(L < thr_fp, thr_fp - 1, L)
    num = (Lp + 1) * totals - used * SCALE - 1              # (N, R)
    denom = (req * SCALE).clamp_min(1)[None, :]
    jc = _floordiv(num, denom).clamp(0, _BIG)
    jcount = torch.where(req_pos[None, :], jc, _BIG).amin(dim=1)
    return torch.minimum(m_max, jcount)


def _schedule_group(avail, totals, node_mask, req, count, gmask, thr_fp,
                    require_available=False):
    """Place ``count`` identical requests: (counts_row (N+1,), new_avail).
    Tensor ops only — no host sync inside."""
    n = totals.shape[0]
    dev = totals.device
    req_pos = req > 0
    any_req = req_pos.any()
    used = totals - avail

    feas = torch.where(req_pos[None, :], totals >= req[None, :],
                       True).all(dim=1) & node_mask & gmask
    caps = torch.where(req_pos[None, :],
                       _floordiv(avail, req.clamp_min(1)[None, :]), _BIG)
    m_max = torch.where(feas & any_req, caps.amin(dim=1).clamp(0, _BIG), 0)
    m_max = m_max.to(_I32)

    total_cap = _i32sum(m_max)
    n_avail = torch.minimum(count, total_cap)   # placements that consume
    overflow = count - n_avail                  # queue on best feasible

    def m_of(L):
        return _slots_at_or_below(L, totals, used, req, req_pos, m_max,
                                  thr_fp)

    lo = torch.zeros((), dtype=_I32, device=dev)
    hi = torch.full((), 2 * SCALE, dtype=_I32, device=dev)
    for _ in range(_BISECT_STEPS):
        mid = _floordiv(lo + hi, 2)
        ok = _i32sum(m_of(mid)) >= n_avail
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    l_star = lo

    base = torch.where(l_star > 0, m_of((l_star - 1).clamp_min(0)), 0)
    at_level = m_of(l_star)
    extra = at_level - base
    rem = n_avail - _i32sum(base)
    prefix = torch.cumsum(extra, 0).to(_I32) - extra    # exclusive
    give = torch.minimum((rem - prefix).clamp_min(0), extra)
    alloc = (base + give).to(_I32)

    new_avail = avail - alloc[:, None] * req[None, :]

    okeys = _keys_one_req(totals, new_avail, req, thr_fp, node_mask & gmask)
    amin = torch.argmin(okeys).reshape(1)       # first minimum, as jnp
    onode = amin[0].to(_I32)
    okey = okeys.gather(0, amin)[0]             # no host sync
    infeasible = okey == _INF_KEY
    ocol = torch.where(infeasible, n, onode)
    if require_available:
        o_avail = ((okey >> AVAIL_SHIFT) & 1) == 0
        ocol = torch.where(infeasible | ~o_avail, n, onode)

    counts_row = torch.zeros(n + 1, dtype=_I32, device=dev)
    counts_row[:n] = alloc
    counts_row.index_add_(0, ocol.reshape(1).long(), overflow.reshape(1))
    return counts_row, new_avail.to(_I32)


def _localize(avail, totals, node_mask, req, count, gmask, pref):
    """The soft-locality step of ``schedule_grouped_localized``: a
    feasible preferred row takes the whole class (``m = count``; m = 0
    when there is no preference or p is infeasible), consuming only what
    its avail allows.  Returns (m, p (1,) int64, avail after the debit)."""
    n = totals.shape[0]
    p = pref.clamp(0, n - 1).long().reshape(1)
    req_pos = req > 0
    feas_p = torch.where(req_pos, totals.index_select(0, p)[0] >= req,
                         True).all() \
        & node_mask.index_select(0, p)[0] & gmask.index_select(0, p)[0]
    m = torch.where((pref >= 0) & feas_p, count, 0).to(_I32)
    cap_p = torch.where(req_pos, _floordiv(avail.index_select(0, p)[0],
                                           req.clamp_min(1)), _BIG).amin()
    consumed = torch.minimum(m, cap_p.clamp(0, _BIG))
    return m, p, avail.index_add(0, p, (-req * consumed).to(_I32)[None])


def waterfill_scan_plain(totals, avail, node_mask, group_reqs, group_counts,
                         group_masks, thr_fp, require_available=False,
                         pref_rows=None):
    """Plain PyTorch version of ``waterfill_scan``: the class scan and
    its bisection as Python loops over tensor ops (no ``.item()``)."""
    n = totals.shape[0]
    counts = torch.zeros((group_reqs.shape[0], n + 1), dtype=_I32,
                         device=totals.device)
    ones = torch.ones((n,), dtype=torch.bool, device=totals.device)
    av = avail
    for gi in range(group_reqs.shape[0]):
        gmask = ones if group_masks is None else group_masks[gi]
        req, count = group_reqs[gi], group_counts[gi]
        if pref_rows is not None:
            m, p, av = _localize(av, totals, node_mask, req, count, gmask,
                                 pref_rows[gi])
            count = count - m
        counts[gi], av = _schedule_group(
            av, totals, node_mask, req, count, gmask, thr_fp,
            require_available)
        if pref_rows is not None:
            counts[gi].index_add_(0, p, m.reshape(1))
    return counts, av.clone() if av is avail else av


def waterfill_scan(totals, avail, node_mask, group_reqs, group_counts,
                   group_masks, thr_fp, require_available=False,
                   pref_rows=None):
    """The grouped water-fill: G classes placed in order over N nodes,
    carrying ``avail``.  Returns (counts (G, N+1) int32, new_avail (N, R)
    int32); column N counts tasks queued nowhere.  Bit-identical to
    ``scheduling.oracle.schedule_grouped_oracle``.

    totals/avail (N, R) int32, node_mask (N,) bool, group_reqs (G, R)
    int32, group_counts (G,) int32 (0 = padding row), group_masks (G, N)
    bool or None, thr_fp the spread threshold in score fixed point.
    ``pref_rows`` (G,) int32 (-1 = none) selects the localized mode
    (``locality_kernel.schedule_grouped_localized``): a feasible
    preferred row takes its whole class before the water-fill.

    CPU tensors take ``waterfill_scan_plain``; CUDA tensors launch the
    hand-written kernel (``csrc/waterfill.cu``) or raise, and count the
    launch in ``waterfill_scan.launches`` or, given ``pref_rows``, in
    ``waterfill_scan.localized_launches``.  The kernel picks its launch
    from (N, R) and the card; ``waterfill_scan.last_layout`` holds the
    last one (cluster size, threads per CTA, columns of each row in
    shared memory, used*SCALE + 1 columns kept, ints of global scratch
    for the class arrays)."""
    if totals.device.type == "cpu":
        return waterfill_scan_plain(totals, avail, node_mask, group_reqs,
                                    group_counts, group_masks, thr_fp,
                                    require_available, pref_rows)
    if totals.device.type != "cuda":
        raise ValueError(f"waterfill_scan: unsupported device "
                         f"{totals.device}")
    from . import _build

    n, r = totals.shape
    g = group_reqs.shape[0]
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"waterfill_scan: {n} nodes outside "
                         f"[1, {MAX_NODES}]")
    args = [("totals", totals, _I32, (n, r)), ("avail", avail, _I32, (n, r)),
            ("node_mask", node_mask, torch.bool, (n,)),
            ("group_reqs", group_reqs, _I32, (g, r)),
            ("group_counts", group_counts, _I32, (g,))]
    if group_masks is not None:
        args.append(("group_masks", group_masks, torch.bool, (g, n)))
    if pref_rows is not None:
        args.append(("pref_rows", pref_rows, _I32, (g,)))
    for name, t, dtype, shape in args:
        if t.device != totals.device or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"waterfill_scan: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {totals.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    counts = torch.empty((g, n + 1), dtype=_I32, device=totals.device)
    new_avail = torch.empty((n, r), dtype=_I32, device=totals.device)
    layout = (ctypes.c_int * 5)()
    fn = _build.load("waterfill")
    with torch.cuda.device(totals.device):
        err = fn(totals.data_ptr(), avail.data_ptr(), node_mask.data_ptr(),
                 group_reqs.data_ptr(), group_counts.data_ptr(),
                 None if group_masks is None else group_masks.data_ptr(),
                 None if pref_rows is None else pref_rows.data_ptr(),
                 counts.data_ptr(), new_avail.data_ptr(), n, r, g,
                 int(thr_fp), int(bool(require_available)),
                 ctypes.addressof(layout),
                 torch.cuda.current_stream(totals.device).cuda_stream)
    _build.check(err, "waterfill")
    if pref_rows is None:
        waterfill_scan.launches += 1
    else:
        waterfill_scan.localized_launches += 1
    waterfill_scan.last_layout = dict(zip(
        ("cluster", "threads", "shared_cols", "u1_cols", "scratch_ints"),
        layout))
    return counts, new_avail


# launches without pref_rows (the delta beat's and the snapshot's) and
# with them (the localized mode), counted apart
waterfill_scan.launches = 0
waterfill_scan.localized_launches = 0
waterfill_scan.last_layout = None

# the JAX package's name for the snapshot entry
schedule_grouped = waterfill_scan


def _keys_one_req_host(totals, avail, req, thr_fp, mask):
    """Pure-numpy twin of ``_keys_one_req`` (int64 host arithmetic;
    values are int32-bounded by the contract audit, so results are
    bit-identical)."""
    n = totals.shape[0]
    req_pos = req > 0
    feas = np.where(req_pos[None, :], totals >= req[None, :],
                    True).all(axis=1) & mask
    availb = np.where(req_pos[None, :], avail >= req[None, :],
                      True).all(axis=1)
    denom = np.maximum(totals, 1)
    q = totals - avail + req[None, :]
    s = np.where(req_pos[None, :], (q * SCALE) // denom, 0).max(
        axis=1, initial=0)
    eff = np.where(availb & (s < thr_fp), 0, s)
    key = ((~availb).astype(np.int64) << AVAIL_SHIFT) \
        | (eff << SCORE_SHIFT) | np.arange(n, dtype=np.int64)
    return np.where(feas, key, np.int64(_INF_KEY))


def schedule_group_host(avail, totals, node_mask, req, count,
                        gmask=None, thr_fp=None, pref_row=-1,
                        require_available=False):
    """Pure-NUMPY water-fill for ONE scheduling class — no device: the
    raylet's small-round dispatch path, where a per-round device
    round-trip would cost more than the math.  Same closed-form
    water-fill as ``_schedule_group`` (bit-identical).

    ``pref_row`` >= 0 applies the soft-locality semantics: a FEASIBLE
    preferred node takes the whole class (availability only gates
    consumption); fallback to the water-fill fires only when the
    preferred node is infeasible.

    Returns ``(counts_row (N+1,) int32, new_avail (N, R) int64)``;
    column N counts infeasible/queued-nowhere tasks.
    """
    from ..scheduling.contract import threshold_fp
    if thr_fp is None:
        thr_fp = threshold_fp(None)
    thr_fp = int(thr_fp)
    totals = np.asarray(totals, np.int64)
    avail = np.asarray(avail, np.int64)
    node_mask = np.asarray(node_mask, bool)
    req = np.asarray(req, np.int64)
    n = totals.shape[0]
    if gmask is None:
        gmask = np.ones(n, dtype=bool)
    req_pos = req > 0
    count = int(count)

    if pref_row is not None and pref_row >= 0:
        p = min(max(int(pref_row), 0), n - 1)
        feas_p = bool(np.where(req_pos, totals[p] >= req, True).all()
                      and node_mask[p] and gmask[p])
        m = count if feas_p else 0
        cap_p = int(np.where(req_pos, avail[p] // np.maximum(req, 1),
                             _BIG).min(initial=_BIG))
        consumed = min(m, max(cap_p, 0))
        avail2 = avail.copy()
        avail2[p] -= req * consumed
        rest, avail3 = schedule_group_host(
            avail2, totals, node_mask, req, count - m, gmask, thr_fp,
            pref_row=-1, require_available=require_available)
        rest[p] += m
        return rest, avail3

    any_req = bool(req_pos.any())
    used = totals - avail
    feas = np.where(req_pos[None, :], totals >= req[None, :],
                    True).all(axis=1) & node_mask & gmask
    caps = np.where(req_pos[None, :],
                    avail // np.maximum(req, 1)[None, :], _BIG)
    m_max = np.where(feas & any_req,
                     caps.min(axis=1).clip(0, _BIG), 0)
    total_cap = int(m_max.sum())
    n_avail = min(count, total_cap)
    overflow = count - n_avail

    denom_req = np.maximum(req * SCALE, 1)[None, :]
    used_scaled = used * SCALE

    def m_of(L):
        Lp = thr_fp - 1 if L < thr_fp else L
        num = (Lp + 1) * totals - used_scaled - 1
        jc = (num // denom_req).clip(0, _BIG)
        jcount = np.where(req_pos[None, :], jc, _BIG).min(axis=1)
        return np.minimum(m_max, jcount)

    lo, hi = 0, 2 * SCALE
    while lo < hi:
        mid = (lo + hi) // 2
        if int(m_of(mid).sum()) >= n_avail:
            hi = mid
        else:
            lo = mid + 1
    l_star = lo
    base = m_of(l_star - 1) if l_star > 0 else np.zeros(n, np.int64)
    extra = m_of(l_star) - base
    rem = n_avail - int(base.sum())
    prefix = np.cumsum(extra) - extra
    give = (rem - prefix).clip(0, extra)
    alloc = base + give
    new_avail = avail - alloc[:, None] * req[None, :]

    okeys = _keys_one_req_host(totals, new_avail, req, thr_fp,
                               node_mask & gmask)
    onode = int(np.argmin(okeys))
    infeasible = okeys[onode] == _INF_KEY
    ocol = n if infeasible else onode
    if require_available:
        o_avail = (int(okeys[onode]) >> AVAIL_SHIFT) & 1 == 0
        if infeasible or not o_avail:
            ocol = n
    counts_row = np.zeros(n + 1, np.int32)
    counts_row[:n] = alloc
    counts_row[ocol] += overflow
    return counts_row, new_avail


# -- delta-heartbeat device programs ------------------------------------------
#
# The heartbeat keeps three residents on the device between beats: the CRM
# mirror (totals/avail/mask), the interned class request matrix ``reqs``
# (C, R), and the carried key tensor ``keys`` (C, N) — each class's packed
# placement keys against every node, bit-identical to
# contract.compute_keys on the mirror.  Per beat only the dirty slices move
# host->device and only the touched key columns/rows re-score; a beat's
# placement decisions come back in one readback (scheduling.policy).
#
# Index lanes equal to the axis length are padding: JAX drops them
# (``.at[idx].set(mode="drop")``).  ``_drop_set`` sends them to a scratch
# row that is cut off, so the scatter stays a single device op with no
# host-side masking.


def _drop_set(x, idx, vals, dim=0):
    """``x.at[idx].set(vals, mode="drop")`` along ``dim`` (returns a new
    tensor; ``x`` is not modified)."""
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = 1
    padded = torch.cat([x, x.new_zeros(pad_shape)], dim=dim)
    padded.index_copy_(dim, idx.long().clamp(0, n), vals.to(x.dtype))
    return padded.narrow(dim, 0, n).contiguous()


def full_rescore(totals, avail, mask, reqs, thr_fp, offset=0):
    """(C, N) carried key tensor: every resident scheduling class scored
    against every node.  ``offset`` (0 in the JAX package) is added to
    the row in the keys' low bits: a rank's first global row."""
    rows = offset + torch.arange(totals.shape[0], dtype=_I32,
                                 device=totals.device)
    return _keys(totals, avail, mask, reqs, thr_fp, rows)


def _keys_cols(totals, avail, mask, reqs, idx, thr_fp, offset=0):
    """Key columns for the B nodes in ``idx`` against all C classes —
    the delta rescore costs (C, B) instead of (C, N).  Padding lanes
    (idx == N) gather the last row, as JAX's clamped gather does; their
    columns are dropped by the caller."""
    g = idx.long().clamp(0, totals.shape[0] - 1)
    return _keys(totals[g], avail[g], mask[g], reqs, thr_fp,
                 offset + idx.to(_I32))


def apply_dirty_rows(totals, avail, mask, keys, reqs, idx,
                     row_totals, row_avail, row_mask, thr_fp, offset=0):
    """Scatter B dirty node rows into the device mirror and re-score ONLY
    the touched key columns.  ``idx`` entries == N are padding lanes.
    Returns (totals, avail, mask, keys), new tensors (the plain version
    of ``beat_rows`` with ``rows``)."""
    totals = _drop_set(totals, idx, row_totals)
    avail = _drop_set(avail, idx, row_avail)
    mask = _drop_set(mask, idx, row_mask)
    cols = _keys_cols(totals, avail, mask, reqs, idx, thr_fp, offset)
    keys = _drop_set(keys, idx, cols, dim=1)
    return totals, avail, mask, keys


def apply_dirty_classes(totals, avail, mask, keys, reqs, idx, class_reqs,
                        thr_fp, offset=0):
    """Install B new/changed scheduling classes (slots ``idx``; padding
    == C) and re-score their full key rows.  Returns (reqs, keys), new
    tensors (the plain version of ``beat_rows`` with ``classes``)."""
    reqs = _drop_set(reqs, idx, class_reqs)
    rows = full_rescore(totals, avail, mask, class_reqs, thr_fp, offset)
    keys = _drop_set(keys, idx, rows)
    return reqs, keys


def _budgets(totals, av_fin, mask_eff, reqs):
    """Per-(class, node) lease budgets off the post-beat avail
    (contract.compute_budgets device twin).  avail is clamped >= 0
    before the floor division; EVERY resident class is priced."""
    av_nn = av_fin.clamp_min(0)
    pos = (reqs > 0)[:, None, :]                            # (C, 1, R)
    r = reqs[:, None, :]
    feas = torch.where(pos, totals[None] >= r, True).all(dim=2) \
        & mask_eff[None]
    fill = torch.where(pos, _floordiv(av_nn[None], r.clamp_min(1)),
                       BUDGET_CAP)
    fill = fill.amin(dim=2).clamp_max(BUDGET_CAP)           # initial=CAP
    return torch.where(feas, fill.clamp(0, BUDGET_CAP), 0).to(_I32)


def fused_beat(totals, avail, mask, keys, reqs, class_slots, group_counts,
               extra_mask, ov_idx, ov_avail, thr_fp,
               require_available=False):
    """One heartbeat against the resident mirror: per-beat ephemeral row
    overrides (the raylet's planned-load debits), an extra soft mask
    (suspect avoidance), the grouped water-fill (one ``waterfill_scan``
    launch), the per-(class, node) lease budgets priced off its final
    avail, and the per-class argmin of the carried key tensor.

    class_slots: (G,) int32 slots into ``reqs``.  ov_idx/ov_avail:
    (B,) int32 rows + (B, R) int32 replacement avail rows applied for
    this beat only (padding idx == N; the resident mirror is untouched).
    Returns (packed (G + C, N+1) int32 — rows [:G] the water-fill counts
    with the overflow column, rows [G:] the lease budgets with a zero
    overflow column — and argmin_rows (C,) int32).

    CPU tensors run the plain programs (the JAX package's, eagerly).
    CUDA tensors run ``beat_rows`` (the overrides, mask and class
    gather), ``waterfill_scan`` and ``beat_tail``: three launches."""
    if totals.device.type != "cpu":
        st = BeatState([totals], [avail], [mask], [reqs], [keys])
        beat_rows(st, thr_fp, overrides=([ov_idx], [ov_avail]),
                  extra_mask=[extra_mask],
                  groups=([class_slots], [group_counts]))
        g, n = class_slots.shape[0], totals.shape[0]
        counts, av_fin = waterfill_scan(
            totals, st.avail_eff[0], st.mask_eff[0], st.group_reqs[0][:g],
            st.group_counts[0][:g], None, thr_fp, require_available)
        return beat_tail(st, [counts[:, :n]], counts[:, n], [av_fin])
    avail_eff = _drop_set(avail, ov_idx, ov_avail)
    mask_eff = mask & extra_mask
    slots = class_slots.long().clamp(0, reqs.shape[0] - 1)
    counts, av_fin = waterfill_scan(totals, avail_eff, mask_eff, reqs[slots],
                                    group_counts, None, thr_fp,
                                    require_available)
    budgets = _budgets(totals, av_fin, mask_eff, reqs)      # (C, N)
    packed = torch.cat(
        [counts, torch.nn.functional.pad(budgets, (0, 1))], dim=0)
    amin = torch.argmin(keys, dim=1).to(_I32)
    return packed, amin


# -- the delta beat's kernels (csrc/beat.cu) ----------------------------------
#
# The engines keep their residents in a BeatState and update them in place
# (the port may, where JAX's arrays are immutable): the kernels write the
# residents' memory, and the plain versions write their results into it,
# so the pointers in the kernels' table stay valid from beat to beat.


class BeatState:
    """The residents of a delta heartbeat and its beat buffers, for one
    rank or the S ranks of a row-sharded plane (rank k's node rows are
    the global rows [k * n_l, (k + 1) * n_l)).  Every field is a list of
    per-rank tensors in rank order, on one device:

      totals/avail (n_l, R) int32, mask (n_l,) bool   the CRM mirror
      reqs (C, R) int32                                the classes (a copy
                                                       a rank; may be one
                                                       tensor for all)
      keys (C, n_l) int32                              the carried keys
      avail_eff (n_l, R), mask_eff (n_l,)              this beat's, after
                                                       overrides and the
                                                       soft mask
      group_reqs (>= G, R), group_counts (>= G,)       the scan's classes
      xchg, scan_out                                   shard_scan's
                                                       exchange areas and
                                                       outputs (S ranks of
                                                       one card)

    The beat buffers are allocated stacked (each field's ranks equally
    spaced) and grow with G; a state whose residents are replaced gets
    its kernels' table rebuilt (``rank_table``)."""

    def __init__(self, totals, avail, mask, reqs=None, keys=None):
        self.totals, self.avail, self.mask = list(totals), list(avail), \
            list(mask)
        self.reqs = None if reqs is None else list(reqs)
        self.keys = None if keys is None else list(keys)
        self.avail_eff = self.mask_eff = None
        self.group_reqs = self.group_counts = None
        self.xchg = self.scan_out = None

    @property
    def n_shards(self) -> int:
        return len(self.totals)

    @property
    def n_local(self) -> int:
        return self.totals[0].shape[0]

    def offsets(self) -> list:
        """Each rank's first global row."""
        return [k * self.n_local for k in range(self.n_shards)]

    def _empty(self, shape, dtype):
        return torch.empty((self.n_shards, *shape), dtype=dtype,
                           device=self.totals[0].device)

    def alloc_keys(self) -> None:
        """Fresh (C, n_l) key blocks for a full rescore to fill."""
        self.keys = list(self._empty((self.reqs[0].shape[0], self.n_local),
                                     _I32))

    def ensure_beat_buffers(self, g: int) -> None:
        n_l, r = self.totals[0].shape
        if self.avail_eff is None or tuple(self.avail_eff[0].shape) != \
                (n_l, r):
            self.avail_eff = list(self._empty((n_l, r), _I32))
            self.mask_eff = list(self._empty((n_l,), torch.bool))
        if self.group_reqs is None or self.group_reqs[0].shape[0] < g or \
                self.group_reqs[0].shape[1] != r:
            cap = max(g, 8)
            self.group_reqs = list(self._empty((cap, r), _I32))
            self.group_counts = list(self._empty((cap,), _I32))

    def ensure_scan_buffers(self, g: int, exchange_ints: int) -> None:
        """shard_scan's outputs and exchange areas for G classes, kept
        from beat to beat (``beat_rows`` zeroes the exchange areas)."""
        n_l, r = self.totals[0].shape
        out = self.scan_out
        if out is None or out["alloc"].shape[1] < g or \
                tuple(out["new_avail"].shape[1:]) != (n_l, r) or \
                out["xchg"].shape[1] < exchange_ints:
            cap = max(g, 8)
            xchg = torch.zeros((self.n_shards, exchange_ints), dtype=_I32,
                               device=self.totals[0].device)
            self.scan_out = {"alloc": self._empty((cap, n_l), _I32),
                             "new_avail": self._empty((n_l, r), _I32),
                             "inf": torch.empty((cap,), dtype=_I32,
                                                device=xchg.device),
                             "xchg": xchg}
            self.xchg = list(xchg)

    def clone(self) -> "BeatState":
        """A deep copy (the residents and the beat buffers)."""
        out = BeatState.__new__(BeatState)
        for name in ("totals", "avail", "mask", "reqs", "keys", "avail_eff",
                     "mask_eff", "group_reqs", "group_counts", "xchg"):
            xs = getattr(self, name)
            setattr(out, name, None if xs is None
                    else [x.clone() for x in xs])
        out.scan_out = None if self.scan_out is None else \
            {k: v.clone() for k, v in self.scan_out.items()}
        return out


_TABLES: dict = {}
_TABLE_CAP = 16


def rank_table(rows, device) -> torch.Tensor:
    """The kernels' table of per-rank pointers on ``device``: ``rows`` is
    one list of pointers (ints) a rank.  Built once per distinct table
    (one host->device copy) and kept; a table whose tensors were
    reallocated is a new table and is built anew (the oldest of more than
    ``_TABLE_CAP`` is dropped).  ``rank_table.builds`` counts the
    builds."""
    key = (str(device), tuple(tuple(int(p) for p in r) for r in rows))
    table = _TABLES.pop(key, None)
    if table is None:
        table = torch.tensor(rows, dtype=torch.int64).to(device,
                                                         non_blocking=True)
        rank_table.builds += 1
        while len(_TABLES) >= _TABLE_CAP:
            _TABLES.pop(next(iter(_TABLES)))
    _TABLES[key] = table
    return table


rank_table.builds = 0


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def resident_table(st: BeatState) -> torch.Tensor:
    """``rank_table`` of a BeatState's residents and beat buffers, in
    ``csrc/beat.cu``'s RankRes order."""
    def each(xs):
        return [None] * st.n_shards if xs is None else xs
    rows = [[_ptr(x) for x in per_rank] for per_rank in zip(
        st.totals, st.avail, st.mask, each(st.keys), each(st.reqs),
        each(st.avail_eff), each(st.mask_eff), each(st.group_reqs),
        each(st.group_counts), each(st.xchg))]
    return rank_table(rows, st.totals[0].device)


def spaced(xs) -> list:
    """Per-rank tensors ``xs`` as the kernels take them, rank k's at rank
    0's address plus k times one step: ``xs`` itself when it is so (the
    engines' staged upload, one tensor for every rank), else a stacked
    copy."""
    p0 = xs[0].data_ptr()
    step = xs[1].data_ptr() - p0 if len(xs) > 1 else 0
    if all(x.is_contiguous() and x.data_ptr() == p0 + k * step
           for k, x in enumerate(xs)):
        return list(xs)
    return list(torch.stack([x.contiguous() for x in xs]))


def _rank_step(name, xs, dtype, shape, dev, contiguous=True):
    """(rank 0's pointer, bytes from one rank's to the next's) of ``xs``;
    raises ``ValueError`` unless each is a ``dtype`` tensor of ``shape``
    on ``dev`` (contiguous unless told), equally spaced."""
    for x in xs:
        if x.device != dev or x.dtype != dtype or \
                tuple(x.shape) != tuple(shape) or \
                (contiguous and not x.is_contiguous()):
            raise ValueError(
                f"{name} must be {'contiguous ' if contiguous else ''}"
                f"{dtype} tensors of shape {tuple(shape)} on {dev}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    p0 = xs[0].data_ptr()
    step = xs[1].data_ptr() - p0 if len(xs) > 1 else 0
    if any(x.data_ptr() != p0 + k * step for k, x in enumerate(xs)):
        raise ValueError(f"{name}: the ranks' tensors are not equally "
                         f"spaced (one staged upload, or ``spaced``)")
    return p0, step


_ROW_FIELDS = ("idx", "rows_totals", "rows_avail", "rows_mask", "ov_idx",
               "ov_avail", "extra_mask", "slots", "counts", "cls_idx",
               "cls_reqs")
_MODES = {"beat": 0, "classes": 1, "rescore": 2}
_BEAT_LAYOUT = ("ctas", "threads", "tile_rows", "class_block",
                "gather_ctas", "lane_ctas", "tile_ctas", "staged_cols")
_TAIL_LAYOUT = ("ctas", "threads", "tile_rows", "class_block",
                "argmin_ctas")


class _RowsArgs(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p * len(_ROW_FIELDS)),
                ("step", ctypes.c_longlong * len(_ROW_FIELDS))] + \
        [(f, ctypes.c_int) for f in ("s", "n_l", "r", "c", "b", "bo", "g",
                                      "bc", "thr_fp", "xchg_ints", "mode",
                                      "eff")]


class _TailArgs(ctypes.Structure):
    _fields_ = [("alloc", ctypes.c_void_p), ("alloc_rank", ctypes.c_longlong),
                ("inf", ctypes.c_void_p), ("av_fin", ctypes.c_void_p),
                ("av_rank", ctypes.c_longlong), ("packed", ctypes.c_void_p),
                ("amin", ctypes.c_void_p)] + \
        [(f, ctypes.c_int) for f in ("alloc_row", "inf_stride", "s", "n_l",
                                      "r", "c", "g")]


def beat_inputs(views) -> dict:
    """A staged beat's per-rank views (``policy.BeatBlob.views``) as
    ``beat_rows`` takes them: ``rows``, ``overrides``, ``extra_mask``,
    ``groups`` and the class install's ``classes``, None where the beat
    has none."""
    def pair(*names):
        return tuple(views[k] for k in names) if names[0] in views else None
    return {"rows": pair("idx", "rows_totals", "rows_avail", "rows_mask"),
            "overrides": pair("ov_idx", "ov_avail"),
            "extra_mask": views.get("extra_mask"),
            "groups": pair("slots", "counts"),
            "classes": pair("cls_idx", "cls_reqs")}


def _mode_of(classes, rescore) -> str:
    if rescore and classes is not None:
        raise ValueError("beat_rows: classes and rescore are two calls")
    return "rescore" if rescore else \
        "classes" if classes is not None else "beat"


def beat_rows_plain(state, thr_fp, rows=None, overrides=None,
                    extra_mask=None, groups=None, classes=None,
                    rescore=False):
    """Plain version of ``beat_rows``: rank by rank, the functional
    programs above (``full_rescore``, ``apply_dirty_classes``,
    ``apply_dirty_rows``; ``fused_beat``'s overrides, mask and gather)
    with the rank's first global row as the keys' offset, each result
    written into ``state``'s tensors (and, as the kernel does, the
    shard_scan exchange areas zeroed for the beat's scan)."""
    mode = _mode_of(classes, rescore)
    if groups is not None:
        state.ensure_beat_buffers(groups[0][0].shape[0])
    for k, off in enumerate(state.offsets()):
        t, a, m, rq = state.totals[k], state.avail[k], state.mask[k], \
            state.reqs[k]
        if mode == "rescore":
            state.keys[k].copy_(full_rescore(t, a, m, rq, thr_fp, off))
            continue
        if mode == "classes":
            new_reqs, new_keys = apply_dirty_classes(
                t, a, m, state.keys[k], rq, classes[0][k], classes[1][k],
                thr_fp, off)
            rq.copy_(new_reqs)
            state.keys[k].copy_(new_keys)
            continue
        if rows is not None:
            for dst, src in zip((t, a, m, state.keys[k]), apply_dirty_rows(
                    t, a, m, state.keys[k], rq, *(x[k] for x in rows),
                    thr_fp, off)):
                dst.copy_(src)
        if groups is not None:
            a_eff = a if overrides is None else \
                _drop_set(a, overrides[0][k], overrides[1][k])
            state.avail_eff[k].copy_(a_eff)
            state.mask_eff[k].copy_(m if extra_mask is None
                                    else m & extra_mask[k])
            slots, counts = groups[0][k], groups[1][k]
            g = slots.shape[0]
            state.group_reqs[k][:g].copy_(
                rq[slots.long().clamp(0, rq.shape[0] - 1)])
            state.group_counts[k][:g].copy_(counts)
            if state.xchg is not None:
                state.xchg[k].zero_()


def beat_rows(state, thr_fp, rows=None, overrides=None, extra_mask=None,
              groups=None, classes=None, rescore=False):
    """The delta beat's prologue on ``state`` (a ``BeatState``), in
    place, for every rank in one call.  Three calls:

    - the beat: ``rows`` = (idx (B,) local rows, padding == n_l; row
      totals (B, R); row avail (B, R); row mask (B,) bool) scattered into
      the mirror, their key columns rescored against every class; with
      ``groups`` = (slots (G,), counts (G,)), also this beat's avail_eff
      (``overrides`` = (idx (Bo,), avail (Bo, R)) or None) and mask_eff
      (mask & ``extra_mask`` (n_l,) bool, or mask), and the scan's
      group_reqs/group_counts (and zeroed shard_scan exchange areas);
    - ``classes`` = (slots (B,), padding == C; requests (B, R)): the
      class install, request rows scattered and their key rows rescored;
    - ``rescore=True``: every class against every node into ``keys``.

    Each per-beat input is a per-rank list (rank k's at rank 0's address
    plus k steps: ``spaced``).  CPU tensors take ``beat_rows_plain``;
    CUDA tensors launch the hand-written kernel (``csrc/beat.cu``) once
    or raise ``ValueError`` for what it does not take.  The checks, the
    table of residents and the C arguments are made once per layout
    (``rows_call``); a steady beat's call looks its layout up and makes
    the one ctypes call.  ``beat_rows.launches`` counts the launches
    (``launches_by_mode`` by call) and ``beat_rows.last_layout`` holds
    the last one (its grid: CTAs, gather / lane / tile CTAs, rows a tile,
    classes a key CTA, resource columns staged on chip)."""
    dev = state.totals[0].device
    if dev.type == "cpu":
        return beat_rows_plain(state, thr_fp, rows, overrides, extra_mask,
                               groups, classes, rescore)
    if dev.type != "cuda":
        raise ValueError(f"beat_rows: unsupported device {dev}")
    _launch_rows(state, thr_fp, rows, overrides, extra_mask, groups,
                 classes, rescore)


def _rows_inputs(mode, rows, overrides, extra_mask, groups, classes):
    """The call's per-rank inputs in ``_ROW_FIELDS`` order, None where the
    call has none (the overrides and the soft mask only with ``groups``)."""
    if mode == "classes":
        return (None,) * 9 + tuple(classes)
    if mode == "rescore":
        return (None,) * 11
    rows = (None,) * 4 if rows is None else tuple(rows)
    if groups is None:
        return rows + (None,) * 7
    ov = (None, None) if overrides is None else tuple(overrides)
    return rows + ov + (extra_mask, *groups, None, None)


def _residents(st):
    """A state's per-rank lists in ``csrc/beat.cu``'s RankRes order."""
    return (st.totals, st.avail, st.mask, st.keys, st.reqs, st.avail_eff,
            st.mask_eff, st.group_reqs, st.group_counts, st.xchg)


_PTR = torch.Tensor.data_ptr
_META = operator.attrgetter("shape", "dtype")
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_ROW_CALLS: dict = {}
_ROW_CALLS_CAP = 16


def _rows_key(mode, thr_fp, lists) -> tuple:
    """The cache key of a ``beat_rows`` call: what its checks read, every
    tensor's data pointer (so the rank steps), shape and dtype, and each
    list's length; a new key runs the checks.  A CPU tensor's address is
    never a CUDA allocation's (one virtual address space), so a CPU/CUDA
    mix is a new key.  Strides are not read: a non-contiguous view at the
    address, shape and dtype of a checked tensor (a transposed square
    block) would pass."""
    flat = list(itertools.chain.from_iterable(
        xs for xs in lists if xs is not None))
    return (mode, int(thr_fp),
            tuple(None if xs is None else len(xs) for xs in lists),
            tuple(map(_PTR, flat)), tuple(map(_META, flat)))


class _RowsCall:
    """One layout's checked launch: the table, the C arguments and the
    layout buffer, kept while the layout is."""

    __slots__ = ("table", "args", "buf", "ptrs", "device", "mode",
                 "layout")

    def __init__(self, table, args, mode, device):
        self.table, self.args, self.mode, self.device = table, args, mode, \
            device
        self.buf = (ctypes.c_int * len(_BEAT_LAYOUT))()
        self.ptrs = (table.data_ptr(), ctypes.addressof(args),
                     ctypes.addressof(self.buf))
        self.layout = None


def rows_call(state, thr_fp, rows=None, overrides=None, extra_mask=None,
              groups=None, classes=None, rescore=False) -> _RowsCall:
    """``beat_rows``' checked launch for this call's layout (its table of
    residents, ``RowsArgs`` and layout buffer), made and checked once per
    layout and kept; raises ``ValueError`` for what the kernel does not
    take.  A timing script calls another build's entry point with it."""
    mode = _mode_of(classes, rescore)
    if mode == "beat" and groups is not None:
        state.ensure_beat_buffers(groups[0][0].shape[0])
    if state.reqs is None or state.keys is None:
        raise ValueError("beat_rows: the state has no reqs or keys")
    inputs = _rows_inputs(mode, rows, overrides, extra_mask, groups,
                          classes)
    key = _rows_key(mode, thr_fp, _residents(state) + inputs)
    call = _ROW_CALLS.pop(key, None)
    if call is None:
        call = _check_rows(state, thr_fp, mode, inputs)
        while len(_ROW_CALLS) >= _ROW_CALLS_CAP:
            _ROW_CALLS.pop(next(iter(_ROW_CALLS)))
    _ROW_CALLS[key] = call
    return call


def _check_rows(state, thr_fp, mode, inputs) -> _RowsCall:
    """The checks and C arguments of a new layout."""
    dev = state.totals[0].device
    s = state.n_shards
    n_l, r = state.totals[0].shape
    c = state.reqs[0].shape[0]
    if not 1 <= s * n_l <= MAX_NODES:
        raise ValueError(f"beat_rows: {s} x {n_l} nodes outside "
                         f"[1, {MAX_NODES}]")
    for name, xs, dtype, shape in (
            ("totals", state.totals, _I32, (n_l, r)),
            ("avail", state.avail, _I32, (n_l, r)),
            ("mask", state.mask, torch.bool, (n_l,)),
            ("reqs", state.reqs, _I32, (c, r)),
            ("keys", state.keys, _I32, (c, n_l))):
        if len(xs) != s:
            raise ValueError(f"beat_rows: {len(xs)} {name} for {s} ranks")
        for x in xs:
            if x.device != dev or x.dtype != dtype or \
                    tuple(x.shape) != shape or not x.is_contiguous():
                raise ValueError(
                    f"beat_rows: {name} must be contiguous {dtype} tensors "
                    f"of shape {shape} on {dev}; got {x.dtype} "
                    f"{tuple(x.shape)} on {x.device}")
    args = _RowsArgs()
    args.s, args.n_l, args.r, args.c = s, n_l, r, c
    args.thr_fp, args.mode = int(thr_fp), _MODES[mode]
    f = dict(zip(_ROW_FIELDS, inputs))
    b = 0 if f["idx"] is None else f["idx"][0].shape[0]
    bo = 0 if f["ov_idx"] is None else f["ov_idx"][0].shape[0]
    g = 0 if f["slots"] is None else f["slots"][0].shape[0]
    bc = 0 if f["cls_idx"] is None else f["cls_idx"][0].shape[0]
    want = {"idx": (_I32, (b,)), "rows_totals": (_I32, (b, r)),
            "rows_avail": (_I32, (b, r)), "rows_mask": (torch.bool, (b,)),
            "ov_idx": (_I32, (bo,)), "ov_avail": (_I32, (bo, r)),
            "extra_mask": (torch.bool, (n_l,)), "slots": (_I32, (g,)),
            "counts": (_I32, (g,)), "cls_idx": (_I32, (bc,)),
            "cls_reqs": (_I32, (bc, r))}
    for i, name in enumerate(_ROW_FIELDS):
        xs = f[name]
        if xs is None:
            continue
        if len(xs) != s:
            raise ValueError(f"beat_rows: {len(xs)} {name} for {s} ranks")
        args.ptr[i], args.step[i] = _rank_step(f"beat_rows: {name}", xs,
                                               *want[name], dev)
    args.b, args.bo, args.bc = b, bo, bc
    if mode == "beat" and f["slots"] is not None:
        args.g, args.eff = g, 1
        if state.xchg is not None:
            args.xchg_ints = state.xchg[0].numel()
    return _RowsCall(resident_table(state), args, mode, dev)


def _launch_rows(state, thr_fp, rows, overrides, extra_mask, groups,
                 classes, rescore):
    """``beat_rows``' launch: the checked call of this layout, its one
    ctypes call on the current stream."""
    from . import _build

    call = rows_call(state, thr_fp, rows, overrides, extra_mask, groups,
                     classes, rescore)
    fn = _build.load("beat")
    index = call.device.index
    if torch.cuda.current_device() == index:
        stream = _RAW_STREAM(index) if _RAW_STREAM is not None else \
            torch.cuda.current_stream(call.device).cuda_stream
        err = fn(*call.ptrs, stream)
    else:
        with torch.cuda.device(call.device):
            err = fn(*call.ptrs,
                     torch.cuda.current_stream(call.device).cuda_stream)
    _build.check(err, "beat")
    if call.layout is None:
        call.layout = dict(zip(_BEAT_LAYOUT, call.buf), mode=call.mode)
    if call.layout["ctas"]:                # an install of no classes: none
        _ROWS.launches += 1
        _ROWS.launches_by_mode[call.mode] += 1
    _ROWS.last_layout = dict(call.layout)


beat_rows.launches = 0
beat_rows.launches_by_mode = dict.fromkeys(_MODES, 0)
beat_rows.last_layout = None
# the wrappers that own the counters, whatever the module's names are
# bound to (a timing script may swap in stand-ins)
_ROWS = beat_rows


def beat_tail_plain(state, alloc, inf, av_fin):
    """Plain version of ``beat_tail``: ``fused_beat``'s tail (``_budgets``
    rank by rank, the packing, ``torch.argmin`` of the keys) on one rank;
    on S ranks the sharded reference's, the argmin as the min packed key
    over the ranks (its low bits the global row; all-INF gives 0)."""
    budgets = [_budgets(t, a, m, rq) for t, a, m, rq in
               zip(state.totals, av_fin, state.mask_eff, state.reqs)]
    counts = torch.cat([*alloc, inf[:, None]], dim=1)
    packed = torch.cat(
        [counts, torch.nn.functional.pad(torch.cat(budgets, dim=1),
                                          (0, 1))], dim=0)
    if state.n_shards == 1:
        return packed, torch.argmin(state.keys[0], dim=1).to(_I32)
    gmin = torch.stack([k.amin(dim=1) for k in state.keys]).amin(dim=0)
    return packed, torch.where(gmin == _INF_KEY, 0,
                               gmin & (MAX_NODES - 1)).to(_I32)


def beat_tail(state, alloc, inf, av_fin):
    """The delta beat's tail after the class scan, for every rank in one
    call: returns (packed (G + C, S * n_l + 1) int32 — rows [:G] the
    scan's counts, each rank's ``alloc`` (G, n_l) block in its columns
    and ``inf`` (G,) in the last; rows [G:] the lease budgets of every
    class slot off ``av_fin`` (n_l, R per rank) and ``state.mask_eff``,
    a zero last column — and argmin (C,) int32, the first global row of
    each class's least carried key, 0 where every key is INF).

    ``alloc`` and ``av_fin`` are per-rank lists, equally spaced (rows of
    ``alloc`` may be strided, as the columns of waterfill_scan's counts
    are).  CPU tensors take ``beat_tail_plain``; CUDA tensors launch the
    hand-written kernel (``csrc/beat.cu``) once or raise.
    ``beat_tail.launches`` counts the launches and
    ``beat_tail.last_layout`` holds the last one."""
    dev = state.totals[0].device
    if dev.type == "cpu":
        return beat_tail_plain(state, alloc, inf, av_fin)
    if dev.type != "cuda":
        raise ValueError(f"beat_tail: unsupported device {dev}")
    return _launch_tail(state, alloc, inf, av_fin)


def _launch_tail(state, alloc, inf, av_fin):
    """``beat_tail``'s launch: checks, the arguments, the kernel."""
    from . import _build

    dev = state.totals[0].device
    table, args, packed, amin = tail_args(state, alloc, inf, av_fin)
    layout = (ctypes.c_int * len(_TAIL_LAYOUT))()
    fn = _build.load("beat", "rt_beat_tail")
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), ctypes.addressof(args),
                 ctypes.addressof(layout),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "beat")
    _TAIL.launches += 1
    _TAIL.last_layout = dict(zip(_TAIL_LAYOUT, layout))
    return packed, amin


def tail_args(state, alloc, inf, av_fin):
    """``beat_tail``'s checks and C arguments: (the residents' table, the
    ``TailArgs``, packed, argmin), the outputs allocated here (a timing
    script calls another build's entry point with them)."""
    dev = state.totals[0].device
    s = state.n_shards
    n_l, r = state.totals[0].shape
    c = state.reqs[0].shape[0]
    g = alloc[0].shape[0]
    if len(alloc) != s or len(av_fin) != s or state.mask_eff is None:
        raise ValueError(f"beat_tail: {len(alloc)} alloc and {len(av_fin)} "
                         f"av_fin for {s} ranks (and a beat's mask_eff)")
    args = _TailArgs()
    args.alloc, args.alloc_rank = _rank_step(
        "beat_tail: alloc", alloc, _I32, (g, n_l), dev, contiguous=False)
    row = alloc[0].stride(0) if g else n_l
    if g and any(x.stride(1) != 1 or x.stride(0) != row for x in alloc):
        raise ValueError("beat_tail: alloc's rows must be contiguous, "
                         "equally strided")
    args.av_fin, args.av_rank = _rank_step("beat_tail: av_fin", av_fin, _I32,
                                           (n_l, r), dev)
    if inf.device != dev or inf.dtype != _I32 or tuple(inf.shape) != (g,):
        raise ValueError(f"beat_tail: inf must be an int32 ({g},) tensor "
                         f"on {dev}")
    args.inf = inf.data_ptr()
    args.alloc_row, args.inf_stride = row, inf.stride(0) if g else 1
    args.s, args.n_l, args.r, args.c, args.g = s, n_l, r, c, g
    packed = torch.empty((g + c, s * n_l + 1), dtype=_I32, device=dev)
    amin = torch.empty((c,), dtype=_I32, device=dev)
    args.packed, args.amin = packed.data_ptr(), amin.data_ptr()
    return resident_table(state), args, packed, amin


beat_tail.launches = 0
beat_tail.last_layout = None
_TAIL = beat_tail


def schedule_grouped_np(totals, avail, node_mask, group_reqs, group_counts,
                        group_masks=None, thr_fp=None, spread_threshold=None,
                        device=None):
    """Convenience host wrapper: numpy in/out, compute on ``device``
    (the GPU unless the caller asks for the CPU)."""
    from ..scheduling.contract import threshold_fp
    if thr_fp is None:
        thr_fp = threshold_fp(spread_threshold)
    dev = resolve_device(device)
    g, n = group_reqs.shape[0], totals.shape[0]
    if group_masks is None:
        group_masks = np.ones((g, n), dtype=bool)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x, dtype), device=dev)

    counts, new_avail = schedule_grouped(
        put(totals, np.int32), put(avail, np.int32), put(node_mask, bool),
        put(group_reqs, np.int32), put(group_counts, np.int32),
        put(group_masks, bool), int(thr_fp))
    # the host wrapper's result: its one deliberate readback
    return counts.cpu().numpy(), new_avail.cpu().numpy()  # rtlint: disable=W6


def schedule_grouped_sharded_np(totals, avail, node_mask, group_reqs,
                                group_counts, group_masks=None,
                                thr_fp=None, spread_threshold=None,
                                n_shards: int = 0,
                                reduce_mode: str = "auto", devices=None):
    """Row-sharded twin of ``schedule_grouped_np``: node rows partition
    over the ranks' two-level ("dcn", "ici") grid (``ops.shard_reduce``;
    ``devices=None`` means the local CUDA cards) and the water-fill runs
    shard-local, its global sums and argmin as collectives
    (``ShardPlane.schedule_grouped``).  Bit-identical to the
    single-device call; node rows pad to a shard multiple with
    mask-False rows (no-ops)."""
    from ..scheduling.contract import threshold_fp
    from .shard_reduce import gspmd_plane
    if thr_fp is None:
        thr_fp = threshold_fp(spread_threshold)
    g, n = group_reqs.shape[0], totals.shape[0]
    if group_masks is None:
        group_masks = np.ones((g, n), dtype=bool)
    return gspmd_plane(n_shards, reduce_mode, devices).schedule_grouped_np(
        totals, avail, node_mask, group_reqs, group_counts, group_masks,
        thr_fp)

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
tensors.  The rest of the beat (key rescoring, dirty-row scatters,
budget pricing, the per-class argmin) is a few vectorised tensor ops
and stays PyTorch.

All arithmetic is int32 and wraps as XLA's does; ``//`` floors on both.
torch's ``sum``/``cumsum`` widen int32 to int64, so every such result is
cast back to int32 (the wrap is the same modulo 2**32).
"""

from __future__ import annotations

import ctypes

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


def waterfill_scan_plain(totals, avail, node_mask, group_reqs, group_counts,
                         group_masks, thr_fp, require_available=False):
    """Plain PyTorch version of ``waterfill_scan``: the class scan and
    its bisection as Python loops over tensor ops (no ``.item()``)."""
    n = totals.shape[0]
    counts = torch.zeros((group_reqs.shape[0], n + 1), dtype=_I32,
                         device=totals.device)
    ones = torch.ones((n,), dtype=torch.bool, device=totals.device)
    av = avail
    for gi in range(group_reqs.shape[0]):
        gmask = ones if group_masks is None else group_masks[gi]
        counts[gi], av = _schedule_group(
            av, totals, node_mask, group_reqs[gi], group_counts[gi], gmask,
            thr_fp, require_available)
    return counts, av.clone() if av is avail else av


def waterfill_scan(totals, avail, node_mask, group_reqs, group_counts,
                   group_masks, thr_fp, require_available=False):
    """The grouped water-fill: G classes placed in order over N nodes,
    carrying ``avail``.  Returns (counts (G, N+1) int32, new_avail (N, R)
    int32); column N counts tasks queued nowhere.  Bit-identical to
    ``scheduling.oracle.schedule_grouped_oracle``.

    totals/avail (N, R) int32, node_mask (N,) bool, group_reqs (G, R)
    int32, group_counts (G,) int32 (0 = padding row), group_masks (G, N)
    bool or None, thr_fp the spread threshold in score fixed point.

    CPU tensors take ``waterfill_scan_plain``; CUDA tensors launch the
    hand-written kernel (``csrc/waterfill.cu``) or raise.  The kernel
    picks its launch from (N, R) and the card; ``waterfill_scan.
    last_layout`` holds the last one (cluster size, threads per CTA,
    columns of each row in shared memory, used*SCALE + 1 columns kept)."""
    if totals.device.type == "cpu":
        return waterfill_scan_plain(totals, avail, node_mask, group_reqs,
                                    group_counts, group_masks, thr_fp,
                                    require_available)
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
    for name, t, dtype, shape in args:
        if t.device != totals.device or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"waterfill_scan: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {totals.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    counts = torch.empty((g, n + 1), dtype=_I32, device=totals.device)
    new_avail = torch.empty((n, r), dtype=_I32, device=totals.device)
    layout = (ctypes.c_int * 4)()
    fn = _build.load("waterfill")
    with torch.cuda.device(totals.device):
        err = fn(totals.data_ptr(), avail.data_ptr(), node_mask.data_ptr(),
                 group_reqs.data_ptr(), group_counts.data_ptr(),
                 None if group_masks is None else group_masks.data_ptr(),
                 counts.data_ptr(), new_avail.data_ptr(), n, r, g,
                 int(thr_fp), int(bool(require_available)),
                 ctypes.addressof(layout),
                 torch.cuda.current_stream(totals.device).cuda_stream)
    _build.check(err, "waterfill")
    waterfill_scan.launches += 1
    waterfill_scan.last_layout = dict(zip(
        ("cluster", "threads", "shared_cols", "u1_cols"), layout))
    return counts, new_avail


waterfill_scan.launches = 0
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


def full_rescore(totals, avail, mask, reqs, thr_fp):
    """(C, N) carried key tensor: every resident scheduling class scored
    against every node."""
    rows = torch.arange(totals.shape[0], dtype=_I32, device=totals.device)
    return _keys(totals, avail, mask, reqs, thr_fp, rows)


def _keys_cols(totals, avail, mask, reqs, idx, thr_fp):
    """Key columns for the B nodes in ``idx`` against all C classes —
    the delta rescore costs (C, B) instead of (C, N).  Padding lanes
    (idx == N) gather the last row, as JAX's clamped gather does; their
    columns are dropped by the caller."""
    g = idx.long().clamp(0, totals.shape[0] - 1)
    return _keys(totals[g], avail[g], mask[g], reqs, thr_fp, idx)


def apply_dirty_rows(totals, avail, mask, keys, reqs, idx,
                     row_totals, row_avail, row_mask, thr_fp):
    """Scatter B dirty node rows into the device mirror and re-score ONLY
    the touched key columns.  ``idx`` entries == N are padding lanes.
    Returns (totals, avail, mask, keys)."""
    totals = _drop_set(totals, idx, row_totals)
    avail = _drop_set(avail, idx, row_avail)
    mask = _drop_set(mask, idx, row_mask)
    cols = _keys_cols(totals, avail, mask, reqs, idx, thr_fp)
    keys = _drop_set(keys, idx, cols, dim=1)
    return totals, avail, mask, keys


def apply_dirty_classes(totals, avail, mask, keys, reqs, idx, class_reqs,
                        thr_fp):
    """Install B new/changed scheduling classes (slots ``idx``; padding
    == C) and re-score their full key rows.  Returns (reqs, keys)."""
    reqs = _drop_set(reqs, idx, class_reqs)
    rows = full_rescore(totals, avail, mask, class_reqs, thr_fp)
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
    overflow column — and argmin_rows (C,) int32)."""
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
    return counts.cpu().numpy(), new_avail.cpu().numpy()

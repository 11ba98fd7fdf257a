"""Gang placement of placement groups as device math, in PyTorch.

The port of ``ray_tpu/ops/bundle_kernel.py``: the device twin of
``scheduling/bundles.py`` (the CPU oracle; see its docstring for the
contract).  P placement groups, each padded to B bundle slots over R
resources, are placed in order, carrying ``avail``; each group is atomic
(its bundles apply only if every valid bundle found an available node).

The JAX program is two nested ``lax.scan``s that evaluate every strategy
for every group and select.  On a card they are the hand-written CUDA
kernel ``csrc/bundle.cu``: one launch compacts every bundle's request
(and every STRICT_PACK group's sum) off the chain, keeps the rows'
totals, reciprocals and avail on chip where they fit (one CTA, or a
thread-block cluster), steps the groups and their bundles in order with
one barrier a step, and undoes a failed group from a log of its placed
rows.  The layout is chosen from the shape before the launch
(``kernel_plan``) and reported in ``schedule_bundle_groups.last_layout``.
Its plain PyTorch version ``schedule_bundle_groups_plain`` (CPU tensors
take it) reads the strategies and the validity mask on the host once
and runs each group's own strategy's ops over its valid bundles (an
invalid bundle is a no-op in the scan: it places nothing and cannot fail
the group); eagerly that is ~55 launches a bundle.  Both are the JAX
program's arithmetic, bit for bit.

Width note: a STRICT_PACK group sums its bundle demands; the sum is
clamped to ``MAX_TOTAL_CU + 1``, which is infeasible on every node and
keeps ``(t - a + req) * SCALE`` inside int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..common.resources import MAX_TOTAL_CU
from ..device import resolve_device
from ..scheduling.bundles import PlacementStrategy, schedule_bundles
from ..scheduling.contract import AVAIL_SHIFT
from .hybrid_kernel import _INF_KEY, _keys_one_req

_PACK = PlacementStrategy.PACK.value
_STRICT_PACK = PlacementStrategy.STRICT_PACK.value
_STRICT_SPREAD = PlacementStrategy.STRICT_SPREAD.value
_I32 = torch.int32
# csrc/bundle.cu's layouts, by the code rt_bundle_plan returns: the rows'
# arrays on chip in one CTA or in a cluster, or in global memory
LAYOUTS = ("shared", "cluster", "global")


def _avail_keys(totals, avail, req, thr_fp, mask):
    """Hybrid keys with feasible-but-unavailable nodes forced to INF
    (a bundle reservation consumes resources: availability is hard)."""
    keys = _keys_one_req(totals, avail, req, thr_fp, mask)
    return torch.where((keys >> AVAIL_SHIFT) & 1 == 0, keys, _INF_KEY)


def _argmin_key(keys):
    """(row (1,) int64, found 0-d bool): the first minimum, no sync."""
    node = torch.argmin(keys).reshape(1)
    return node, keys.gather(0, node)[0] != _INF_KEY


def _place_soft(avail, totals, node_mask, reqs, strategy, thr_fp):
    """PACK / SPREAD / STRICT_SPREAD over the group's valid bundles.
    Returns (rows (b,) int32, ok 0-d bool, new_avail)."""
    n = totals.shape[0]
    used = torch.zeros(n, dtype=torch.bool, device=totals.device)
    ok = torch.ones((), dtype=torch.bool, device=totals.device)
    rows = []
    for req in reqs:
        primary = (used if strategy == _PACK else ~used) & node_mask
        n1, ok1 = _argmin_key(_avail_keys(totals, avail, req, thr_fp,
                                          primary))
        if strategy == _STRICT_SPREAD:
            node, found = n1, ok1
        else:
            n2, ok2 = _argmin_key(_avail_keys(totals, avail, req, thr_fp,
                                              node_mask))
            node = torch.where(ok1, n1, n2)
            found = ok1 | ok2
        avail = avail.index_add(0, node,
                                torch.where(found, -req, 0).to(_I32)[None])
        used = used.index_copy(0, node, (used.gather(0, node) | found))
        ok = ok & found
        rows.append(torch.where(found, node[0], -1))
    return torch.stack(rows).to(_I32), ok, avail


def _place_strict_pack(avail, totals, node_mask, reqs, thr_fp):
    # the int32 sum wraps as XLA's, then the width clamp
    total = reqs.sum(dim=0).to(_I32).clamp_max(MAX_TOTAL_CU + 1)
    node, ok = _argmin_key(_avail_keys(totals, avail, total, thr_fp,
                                       node_mask))
    rows = torch.where(ok, node[0], -1).to(_I32).expand(reqs.shape[0])
    avail = avail.index_add(0, node, torch.where(ok, -total, 0)[None])
    return rows, ok, avail


def schedule_bundle_groups(totals, avail, node_mask, bundle_reqs,
                           bundle_valid, strategies, thr_fp):
    """Atomically place P padded placement groups.

    totals/avail: (N, R) int32 cu tensors.  node_mask: (N,) bool.
    bundle_reqs: (P, B, R) int32.  bundle_valid: (P, B) bool.
    strategies: (P,) PlacementStrategy codes (host ints or a tensor).
    thr_fp: int.

    Returns (rows (P, B) int32 node rows, -1 for padded/failed bundles;
    ok (P,) bool per-group success; new_avail (N, R)).  Groups run in
    index order; a failed group leaves ``avail`` untouched.  Bit-identical
    to ``bundles.schedule_bundles`` applied sequentially and to the JAX
    program.

    CPU tensors take ``schedule_bundle_groups_plain``; CUDA tensors launch
    the hand-written kernel (``csrc/bundle.cu``; the mask and strategies
    are copied to the card when given on the host) or raise, count the
    launch in ``schedule_bundle_groups.launches`` and name its layout in
    ``.last_layout`` (one of ``LAYOUTS``; its CTAs in ``.last_cluster``)."""
    if totals.device.type == "cpu":
        return schedule_bundle_groups_plain(totals, avail, node_mask,
                                            bundle_reqs, bundle_valid,
                                            strategies, thr_fp)
    if totals.device.type != "cuda":
        raise ValueError(f"schedule_bundle_groups: unsupported device "
                         f"{totals.device}")
    dev = totals.device
    n, r = totals.shape
    p_n, b_n = bundle_reqs.shape[:2]
    valid = torch.as_tensor(bundle_valid, dtype=torch.bool,
                            device=dev).reshape(p_n, b_n).contiguous()
    strat = torch.as_tensor(strategies, dtype=_I32,
                            device=dev).reshape(p_n).contiguous()
    for name, t, dtype, shape in (
            ("totals", totals, _I32, (n, r)),
            ("avail", avail, _I32, (n, r)),
            ("node_mask", node_mask, torch.bool, (n,)),
            ("bundle_reqs", bundle_reqs, _I32, (p_n, b_n, r))):
        if t.device != dev or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"schedule_bundle_groups: {name} must be a contiguous "
                f"{dtype} tensor of shape {shape} on {dev}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if n < 1 or r < 1:
        raise ValueError(f"schedule_bundle_groups: empty shape N={n} R={r}")
    from . import _build
    layout, cluster, _threads, list_ints, col_ints = kernel_plan(
        n, r, p_n, b_n)
    rows = torch.empty((p_n, b_n), dtype=_I32, device=dev)
    ok = torch.empty(p_n, dtype=torch.bool, device=dev)
    new_avail = torch.empty_like(avail)
    # one scratch: the group blocks, then the column-major rows (16-byte
    # aligned: list_ints is a multiple of 4)
    scratch = torch.empty(list_ints + max(col_ints, 4), dtype=_I32,
                          device=dev)
    with torch.cuda.device(dev):
        err = _build.load("bundle")(
            totals.data_ptr(), avail.data_ptr(), node_mask.data_ptr(),
            bundle_reqs.data_ptr(), valid.data_ptr(), strat.data_ptr(),
            n, r, p_n, b_n, int(thr_fp), rows.data_ptr(), ok.data_ptr(),
            new_avail.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * list_ints,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bundle")
    schedule_bundle_groups.launches += 1
    schedule_bundle_groups.last_layout = layout
    schedule_bundle_groups.last_cluster = cluster
    return rows, ok, new_avail


schedule_bundle_groups.launches = 0
schedule_bundle_groups.last_layout = None
schedule_bundle_groups.last_cluster = None


@functools.lru_cache(maxsize=256)
def kernel_plan(n, r, p, b):
    """``csrc/bundle.cu``'s layout for N rows x R kinds, P groups of B
    slots: (layout name, CTAs, threads a CTA, list scratch ints, column
    scratch ints), from the shape alone (the library's
    ``rt_bundle_plan``; kept per shape)."""
    import ctypes

    from . import _build
    out = (ctypes.c_longlong * 5)()
    err = _build.load("bundle", "rt_bundle_plan")(n, r, p, b, out)
    if err != 0:
        raise ValueError(f"schedule_bundle_groups: no layout holds N={n} "
                         f"R={r} P={p} B={b}")
    return (LAYOUTS[out[0]], int(out[1]), int(out[2]), int(out[3]),
            int(out[4]))


def schedule_bundle_groups_plain(totals, avail, node_mask, bundle_reqs,
                                 bundle_valid, strategies, thr_fp):
    """The plain PyTorch version of ``schedule_bundle_groups``, on either
    device; ``bundle_valid`` and ``strategies`` are read on the host."""
    dev = totals.device
    p_n, b_n = bundle_reqs.shape[:2]
    # the plain version's loop bounds, read on the host (off the main
    # path: the kernel takes them as host arrays)
    strat = torch.as_tensor(strategies).reshape(-1)
    strat = strat.tolist()  # rtlint: disable=W6
    valid = torch.as_tensor(bundle_valid).reshape(p_n, b_n)
    valid = valid.cpu().numpy()  # rtlint: disable=W6
    rows = torch.full((p_n, b_n), -1, dtype=_I32, device=dev)
    oks = []
    for p in range(p_n):
        idx = np.flatnonzero(valid[p])
        if idx.size == 0 and strat[p] != _STRICT_PACK:
            # no bundle to place: the soft scan succeeds trivially (an
            # empty STRICT_PACK group still needs one masked-in node)
            oks.append(torch.ones((), dtype=torch.bool, device=dev))
            continue
        reqs = bundle_reqs[p, torch.as_tensor(idx, device=dev)]
        if strat[p] == _STRICT_PACK:
            r_p, ok, av_p = _place_strict_pack(avail, totals, node_mask,
                                               reqs, thr_fp)
        else:
            r_p, ok, av_p = _place_soft(avail, totals, node_mask, reqs,
                                        strat[p], thr_fp)
        avail = torch.where(ok, av_p, avail)            # atomicity
        rows[p, torch.as_tensor(idx, device=dev)] = torch.where(ok, r_p, -1)
        oks.append(ok)
    return rows, torch.stack(oks) if oks else \
        torch.zeros(0, dtype=torch.bool, device=dev), avail


def schedule_bundle_groups_np(totals, avail, node_mask, bundle_reqs,
                              bundle_valid, strategies, thr_fp=None,
                              spread_threshold=None, device=None):
    """Host wrapper: numpy in/out, compute on ``device`` (the GPU unless
    the caller asks for the CPU)."""
    from ..scheduling.contract import threshold_fp
    if thr_fp is None:
        thr_fp = threshold_fp(spread_threshold)
    dev = resolve_device(device)
    strat = [s.value if isinstance(s, PlacementStrategy) else int(s)
             for s in strategies]

    def put(x, dtype):
        return torch.tensor(np.ascontiguousarray(x, dtype), device=dev)

    rows, ok, new_avail = schedule_bundle_groups(
        put(totals, np.int32), put(avail, np.int32), put(node_mask, bool),
        put(bundle_reqs, np.int32), np.asarray(bundle_valid, bool), strat,
        int(thr_fp))
    # the host wrapper's result: its one deliberate readback
    return (rows.cpu().numpy(), ok.cpu().numpy(),  # rtlint: disable=W6
            new_avail.cpu().numpy())  # rtlint: disable=W6


def schedule_bundle_groups_oracle(totals, avail, node_mask, bundle_reqs,
                                  bundle_valid, strategies,
                                  spread_threshold=None):
    """Numpy oracle: ``bundles.schedule_bundles`` group by group on one
    carried state.  Same return as ``schedule_bundle_groups_np``."""
    from ..scheduling.oracle import ClusterState
    st = ClusterState(np.asarray(totals, np.int32).copy(),
                      np.asarray(avail, np.int32).copy(),
                      np.asarray(node_mask, bool).copy())
    p_n, b_n = np.asarray(bundle_valid).shape
    rows = np.full((p_n, b_n), -1, np.int32)
    ok = np.zeros(p_n, bool)
    for p in range(p_n):
        idx = np.flatnonzero(bundle_valid[p])
        s = strategies[p]
        s = s if isinstance(s, PlacementStrategy) else PlacementStrategy(s)
        got = schedule_bundles(st, np.asarray(bundle_reqs)[p, idx], s,
                               spread_threshold)
        if got is not None:
            rows[p, idx] = got
            ok[p] = True
    return rows, ok, st.avail

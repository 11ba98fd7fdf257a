"""Gang placement of placement groups as device math, in PyTorch.

The port of ``ray_tpu/ops/bundle_kernel.py``: the device twin of
``scheduling/bundles.py`` (the CPU oracle; see its docstring for the
contract).  P placement groups, each padded to B bundle slots over R
resources, are placed in order, carrying ``avail``; each group is atomic
(its bundles apply only if every valid bundle found an available node).

The JAX program is two nested ``lax.scan``s that evaluate every strategy
for every group and select.  Eagerly each tensor op is a launch, so the
strategies and the validity mask are read on the host once and each
group runs only its own strategy's ops over its valid bundles (an invalid
bundle is a no-op in the scan: it places nothing and cannot fail the
group).  The arithmetic is the JAX program's, bit for bit; there is no
kernel yet (PERF.md has the times).

Width note: a STRICT_PACK group sums its bundle demands; the sum is
clamped to ``MAX_TOTAL_CU + 1``, which is infeasible on every node and
keeps ``(t - a + req) * SCALE`` inside int32.
"""

from __future__ import annotations

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
    bundle_reqs: (P, B, R) int32.  bundle_valid: (P, B) bool (read on
    the host).  strategies: (P,) PlacementStrategy codes (host ints or a
    tensor).  thr_fp: int.

    Returns (rows (P, B) int32 node rows, -1 for padded/failed bundles;
    ok (P,) bool per-group success; new_avail (N, R)).  Groups run in
    index order; a failed group leaves ``avail`` untouched.  Bit-identical
    to ``bundles.schedule_bundles`` applied sequentially and to the JAX
    program."""
    dev = totals.device
    p_n, b_n = bundle_reqs.shape[:2]
    strat = torch.as_tensor(strategies).reshape(-1).tolist()
    valid = torch.as_tensor(bundle_valid).reshape(p_n, b_n).cpu().numpy()
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
    return rows.cpu().numpy(), ok.cpu().numpy(), new_avail.cpu().numpy()


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

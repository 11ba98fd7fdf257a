"""Soft-locality placement: the localized water-fill.

The port of ``ray_tpu/ops/locality_kernel.py::schedule_grouped_localized``:
per scheduling class, a preferred node row (the raylet's locality row)
takes the WHOLE class when it is feasible for it (the host's
NodeAffinity-soft semantics: tasks queue there; availability only gates
how much of the node is consumed), and the class falls through to the
ordinary water-fill when it is not.  Bit-identical to the sequential
host path (``hybrid_kernel.schedule_group_host(pref_row=...)``).

The kernel is the hand-written water-fill (``csrc/waterfill.cu``) in its
localized mode: ``waterfill_scan(..., pref_rows=...)`` decides each
class's preferred row while it sets the class up and debits it on the
thread that owns the row, so a localized class costs the same cluster
exchanges as any other.  Eagerly each class would be ~45 launches.  What
bounds it is what bounds the water-fill: the latency of each class's
chain of cluster exchanges, not bytes or operations (the preference adds
one warp's reads of the preferred row while the class is set up).  The
plain PyTorch version is ``waterfill_scan_plain(..., pref_rows=...)``;
CPU tensors take it.

``schedule_grouped_topk`` (the ``scheduler_top_k_fraction`` > 0 mode) is
not ported yet (ROADMAP.md A.4): its JAX draws cannot be reproduced, and
the default fraction is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .hybrid_kernel import waterfill_scan


def schedule_grouped_localized(totals, avail, node_mask, group_reqs,
                               group_counts, group_masks, pref_rows,
                               thr_fp, extra_mask=None):
    """Like ``schedule_grouped`` with per-group soft locality.

    pref_rows: (G,) int32 preferred node row per group, -1 = none.
    extra_mask: optional (N,) bool beat-scoped node filter (suspect
    soft-mask) ANDed into node_mask.  Returns (counts (G, N+1),
    new_avail).  CUDA tensors launch the water-fill kernel in its
    localized mode (counted in ``waterfill_scan.localized_launches``) or
    raise; CPU tensors take the plain version."""
    if extra_mask is not None:
        node_mask = node_mask & extra_mask
    return waterfill_scan(totals, avail, node_mask, group_reqs,
                          group_counts, group_masks, thr_fp, False,
                          pref_rows)


def schedule_grouped_localized_np(totals, avail, node_mask, group_reqs,
                                  group_counts, pref_rows,
                                  group_masks=None, thr_fp=None,
                                  spread_threshold=None,
                                  extra_mask=None, device=None):
    """Host wrapper: numpy in/out, compute on ``device`` (the GPU unless
    the caller asks for the CPU)."""
    from ..scheduling.contract import threshold_fp
    if thr_fp is None:
        thr_fp = threshold_fp(spread_threshold)
    dev = resolve_device(device)
    g, n = group_reqs.shape[0], totals.shape[0]
    if group_masks is None:
        group_masks = np.ones((g, n), dtype=bool)

    def put(x, dtype):
        return torch.tensor(np.ascontiguousarray(x, dtype), device=dev)

    counts, new_avail = schedule_grouped_localized(
        put(totals, np.int32), put(avail, np.int32), put(node_mask, bool),
        put(group_reqs, np.int32), put(group_counts, np.int32),
        put(group_masks, bool), put(pref_rows, np.int32), int(thr_fp),
        None if extra_mask is None else put(extra_mask, bool))
    return counts.cpu().numpy(), new_avail.cpu().numpy()

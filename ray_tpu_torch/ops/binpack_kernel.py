"""Autoscaler demand bin-packing onto node types, on the device.

The port of ``ray_tpu/ops/binpack_kernel.py``: the device twin of
``autoscaler/demand.py`` (the CPU oracle ``get_nodes_to_launch``; see its
docstring for the contract), bit for bit.

Phase 1 (fit onto existing nodes) IS the water-fill: one launch of
``waterfill_scan`` with the first-fit threshold, ``require_available``
and every node open to every class.  Phase 2 is the launch loop: each
iteration first-fit-packs one virtual node of every type (a scan over
the demand classes carrying per-type used vectors), picks the best type
by (utilization score, lowest index) and launches the repeat factor at
once; it is bounded by G*K + G + K + 2 iterations, independent of the
demand counts.

The launch loop is the hand-written CUDA kernel ``binpack_launch_loop``
(``csrc/binpack.cu``, one launch of one CTA over compact class rows,
stepping only the classes and types that can still move; its source
note says what bounds it).  Eagerly it would be a host sync per
iteration and ~8 launches per class step.  ``launch_loop_plain`` is the
same loop in plain PyTorch; CPU tensors take it.

All arithmetic is int32 and wraps as XLA's does; ``//`` floors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..common.resources import MAX_TOTAL_CU
from ..device import resolve_device
from ..scheduling.contract import SCALE
from .hybrid_kernel import _BIG, _floordiv, _i32sum, waterfill_scan

# Smallest fixed-point threshold above max score => first-fit traversal
# while keeping (L+1)*totals within int32 (see contract.py width audit).
FIRST_FIT_THR_FP = 2 * SCALE + 1

_I32 = torch.int32
# the .cu's enum Array, in its placement order
_ARRAYS = ("table", "state", "classes", "used", "caps", "packed", "capdiv")


def launch_loop_plain(type_caps, type_quotas, demand_reqs, remaining,
                      max_iters):
    """Plain PyTorch version of ``binpack_launch_loop``: the JAX
    ``_launch_loop`` as a Python loop over tensor ops (one host read of
    the loop condition per iteration).  Returns (launches (K,), unmet
    (G,), iterations run) as int32 tensors."""
    k_types = type_caps.shape[0]
    dev = type_caps.device
    pos = demand_reqs > 0
    any_pos = pos.any(dim=1)
    req1 = demand_reqs.clamp_min(1)
    quota = type_quotas.clone()
    launches = torch.zeros(k_types, dtype=_I32, device=dev)
    it, done = 0, False
    while it < max_iters and not done and int(_i32sum(remaining)) > 0:
        used = torch.zeros_like(type_caps)
        cols = []
        for g in range(demand_reqs.shape[0]):
            fit = torch.where(pos[g][None, :],
                              _floordiv(type_caps - used, req1[g][None, :]),
                              _BIG).amin(dim=1)
            fit = torch.minimum(fit.clamp_min(0),
                                remaining[g].clamp_min(0))
            fit = torch.where(any_pos[g], fit, 0).to(_I32)
            used = (used + fit[:, None] * demand_reqs[g][None, :]).to(_I32)
            cols.append(fit)
        packed = torch.stack(cols, dim=1)                   # (K, G)
        score = torch.where(type_caps > 0,
                            _floordiv(used * SCALE, type_caps.clamp_min(1)),
                            0).amax(dim=1)
        eligible = (quota > 0) & (_i32sum(packed, dim=1) > 0)
        s_eff = torch.where(eligible, score, -1)
        k = int(torch.argmax(s_eff))            # first max = lowest index
        ok = bool(s_eff[k] >= 0)
        p = packed[k]
        t = torch.where(p > 0, _floordiv(remaining, p.clamp_min(1)),
                        _BIG).amin()
        t = torch.minimum(t, quota[k]).clamp_min(1)
        if ok:
            remaining = (remaining - t * p).clamp_min(0).to(_I32)
            quota[k] -= t
            launches[k] += t
        done = not ok
        it += 1
    return launches, remaining.clone(), torch.tensor(it, dtype=_I32,
                                                     device=dev)


def binpack_launch_loop(type_caps, type_quotas, demand_reqs, remaining,
                        max_iters):
    """Phase 2 of ``autoscale``: type_caps (K, R), type_quotas (K,),
    demand_reqs (G, R), remaining (G,) int32; at most ``max_iters``
    iterations.  Returns (launches (K,), unmet (G,), iterations run
    (0-d)) as int32 tensors on the inputs' device.

    CPU tensors take ``launch_loop_plain``; CUDA tensors launch the
    hand-written kernel (``csrc/binpack.cu``) or raise, and count the
    launch in ``binpack_launch_loop.launches``.  The .cu places the
    compact class rows and the state in shared memory where they fit and
    in global memory past that (the rows then streamed through a ring);
    ``binpack_launch_loop.last_layout`` holds the launch it made, and
    ``binpack_launch_loop.last_class_steps`` (a 0-d int64 tensor on the
    device, read after a sync) the class steps it ran, summed over
    iterations and types, and ``last_chain_steps`` how many of them ran
    one after another (per iteration, the active classes of each round
    of types)."""
    if type_caps.device.type == "cpu":
        return launch_loop_plain(type_caps, type_quotas, demand_reqs,
                                 remaining, max_iters)
    if type_caps.device.type != "cuda":
        raise ValueError(f"binpack_launch_loop: unsupported device "
                         f"{type_caps.device}")
    from . import _build

    k, r = type_caps.shape
    g = demand_reqs.shape[0]
    for name, t, shape in (("type_caps", type_caps, (k, r)),
                           ("type_quotas", type_quotas, (k,)),
                           ("demand_reqs", demand_reqs, (g, r)),
                           ("remaining", remaining, (g,))):
        if t.device != type_caps.device or t.dtype != _I32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"binpack_launch_loop: {name} must be a contiguous int32 "
                f"tensor of shape {shape} on {type_caps.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if min(k, g, r) < 1:
        raise ValueError(f"binpack_launch_loop: empty shape K={k} G={g} "
                         f"R={r}")
    dev = type_caps.device
    launches = torch.empty(k, dtype=_I32, device=dev)
    unmet = torch.empty(g, dtype=_I32, device=dev)
    iters = torch.empty((), dtype=_I32, device=dev)
    steps = torch.empty(2, dtype=torch.int64, device=dev)
    layout = (ctypes.c_longlong * 4)()
    with torch.cuda.device(dev):
        _build.check(_build.load("binpack", "rt_binpack_plan")(
            k, g, r, ctypes.addressof(layout)), "binpack")
        # the arrays the plan keeps in global memory, from PyTorch's
        # caching allocator
        scratch = torch.empty(max(layout[2], 1), dtype=_I32, device=dev)
        err = _build.load("binpack")(
            type_caps.data_ptr(), type_quotas.data_ptr(),
            demand_reqs.data_ptr(), remaining.data_ptr(), k, g, r,
            int(max_iters), launches.data_ptr(), unmet.data_ptr(),
            iters.data_ptr(), steps.data_ptr(), scratch.data_ptr(),
            layout[2], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "binpack")
    binpack_launch_loop.launches += 1
    binpack_launch_loop.last_layout = {
        "shared_bytes": layout[0],
        "global": [a for i, a in enumerate(_ARRAYS) if layout[1] >> i & 1],
        "scratch_ints": layout[2], "ring_slots": layout[3]}
    binpack_launch_loop.last_class_steps = steps[0]
    binpack_launch_loop.last_chain_steps = steps[1]
    return launches, unmet, iters


binpack_launch_loop.launches = 0
binpack_launch_loop.last_layout = None
binpack_launch_loop.last_class_steps = None
binpack_launch_loop.last_chain_steps = None


def autoscale(totals, avail, node_mask, demand_reqs, demand_counts,
              type_caps, type_quotas, extra_mask=None):
    """Full demand-scheduler pass on the inputs' device.

    totals/avail: (N, R) int32 cu existing nodes.  node_mask: (N,) bool.
    demand_reqs: (G, R) int32.  demand_counts: (G,) int32.
    type_caps: (K, R) int32.  type_quotas: (K,) int32.
    extra_mask: optional (N,) bool beat-scoped node filter (suspect
    soft-mask) ANDed into node_mask.

    Returns (launches (K,), fit_counts (G, N+1), unmet (G,), new_avail).
    Bit-identical to autoscaler.demand.get_nodes_to_launch.  On CUDA:
    one ``waterfill_scan`` launch and one ``binpack_launch_loop`` launch,
    no host sync."""
    if extra_mask is not None:
        node_mask = node_mask & extra_mask
    fit_counts, new_avail = waterfill_scan(
        totals, avail, node_mask, demand_reqs, demand_counts, None,
        FIRST_FIT_THR_FP, require_available=True)
    zero_rows = ~(demand_reqs > 0).any(dim=1)
    remaining = torch.where(zero_rows, 0, fit_counts[:, -1]).to(_I32)
    g, k = demand_reqs.shape[0], type_caps.shape[0]
    launches, unmet, _ = binpack_launch_loop(
        type_caps, type_quotas, demand_reqs, remaining.contiguous(),
        g * k + g + k + 2)
    return launches, fit_counts, unmet, new_avail


def autoscale_np(totals, avail, node_mask, demand_reqs, demand_counts,
                 type_caps, type_quotas, extra_mask=None, device=None):
    """Host wrapper: numpy in/out, compute on ``device`` (the GPU unless
    the caller asks for the CPU).

    Enforces the int32 width contract on node-type capacities: the launch
    loop computes ``used * SCALE`` in int32 (the oracle uses int64), which
    is only exact for caps within MAX_TOTAL_CU — the same bound
    ``common.resources.to_cu`` applies to real node resources.
    """
    if (np.asarray(type_caps) > MAX_TOTAL_CU).any():
        raise ValueError(
            f"type_caps exceed MAX_TOTAL_CU={MAX_TOTAL_CU} cu "
            "(int32 score-arithmetic contract)")
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.tensor(np.ascontiguousarray(x, dtype), device=dev)

    out = autoscale(
        put(totals, np.int32), put(avail, np.int32), put(node_mask, bool),
        put(demand_reqs, np.int32), put(demand_counts, np.int32),
        put(type_caps, np.int32), put(type_quotas, np.int32),
        None if extra_mask is None else put(extra_mask, bool))
    # the host wrapper's result: its one deliberate readback
    return tuple(o.cpu().numpy() for o in out)  # rtlint: disable=W6


def autoscale_sharded_np(totals, avail, node_mask, demand_reqs,
                         demand_counts, type_caps, type_quotas,
                         extra_mask=None, n_shards: int = 0,
                         reduce_mode: str = "auto", devices=None):
    """Row-sharded twin of ``autoscale_np``: existing-node rows over the
    ranks of ``ops.shard_reduce`` (``devices=None``: the local CUDA
    cards).  ``autoscale`` runs on the first rank over every row (on a
    card: the first-fit water-fill and ``binpack_launch_loop``), and
    new_avail goes back to the ranks; the launch loop's (K, R) state is
    tiny and stays there (``ShardPlane.call_gathered`` says why the
    host wrappers gather).
    Bit-identical to the single-device call."""
    from .shard_reduce import gspmd_plane, pad_node_rows
    if (np.asarray(type_caps) > MAX_TOTAL_CU).any():
        raise ValueError(
            f"type_caps exceed MAX_TOTAL_CU={MAX_TOTAL_CU} cu "
            "(int32 score-arithmetic contract)")
    n = totals.shape[0]
    pl = gspmd_plane(n_shards, reduce_mode, devices)
    pad = pad_node_rows(n, pl.n_shards)
    if pad:
        totals = np.pad(totals, ((0, pad), (0, 0)))
        avail = np.pad(avail, ((0, pad), (0, 0)))
        node_mask = np.pad(node_mask, (0, pad))
        if extra_mask is not None:
            extra_mask = np.pad(extra_mask, (0, pad))
    (launches, fit_counts, unmet), new_avail = pl.call_gathered(
        autoscale, (totals, np.int32), (avail, np.int32),
        (node_mask, bool), (demand_reqs, np.int32),
        (demand_counts, np.int32), (type_caps, np.int32),
        (type_quotas, np.int32), (extra_mask, bool))
    # the host wrapper's results: its deliberate readbacks
    launches = launches.cpu().numpy()  # rtlint: disable=W6
    fit_counts = fit_counts.cpu().numpy()  # rtlint: disable=W6
    unmet = unmet.cpu().numpy()  # rtlint: disable=W6
    new_avail = np.concatenate(
        [a.cpu().numpy() for a in new_avail])  # rtlint: disable=W6
    if pad:
        fit_counts = np.concatenate([fit_counts[:, :n],
                                     fit_counts[:, -1:]], axis=1)
        new_avail = new_avail[:n]
    return launches, fit_counts, unmet, new_avail

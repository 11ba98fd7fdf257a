"""Entry points of the port: one heartbeat step, and a multi-rank dry run.

The port's counterpart of the JAX package's driver entry
(``__graft_entry__.py``).  The flagship computation is the scheduling
data plane: one heartbeat's pending-task batch placed by the grouped
water-fill (``ops.hybrid_kernel.schedule_grouped``; on a card the
``waterfill_scan`` kernel).

``entry()`` returns that step plus example arguments on the card.

``dryrun_multichip(n)`` runs the framework's multi-device design over n
ranks: cluster resource rows split over the ranks with the water-fill's
global sums as collectives (oracle-checked), the resource-view sync as a
psum, a sequence-parallel training step through causal ring attention
(its loss against single-device attention), and, for n >= 4 and even,
the two-level ("dcn", "ici") grid.  Its ranks are n distinct cards, or,
when the caller names a device, n ranks on it (``device="cpu"`` for the
tests, ``device="cuda:0"`` for n ranks on one card); it never switches
device by itself.

    python -c "import ray_tpu_torch.entry as e; e.dryrun_multichip(4, device='cuda:0')"
"""

from __future__ import annotations

import json

import numpy as np


def _example_problem(n_nodes=64, n_res=8, n_classes=8, n_tasks=512, seed=0):
    rng = np.random.default_rng(seed)
    totals = rng.integers(400, 12800, size=(n_nodes, n_res)).astype(np.int32)
    used = (totals * rng.random(totals.shape) * 0.5).astype(np.int32)
    avail = totals - used
    node_mask = np.ones(n_nodes, dtype=bool)
    reqs = rng.integers(0, 400, size=(n_classes, n_res)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    counts = rng.multinomial(
        n_tasks, np.full(n_classes, 1 / n_classes)).astype(np.int32)
    gmasks = np.ones((n_classes, n_nodes), dtype=bool)
    return totals, avail, node_mask, reqs, counts, gmasks


def entry(device=None):
    """(fn, example_args): one heartbeat scheduling step on ``device``
    (the GPU unless the caller asks for the CPU)."""
    import torch

    from .device import resolve_device
    from .ops.hybrid_kernel import schedule_grouped
    from .scheduling.contract import threshold_fp

    def heartbeat_step(totals, avail, node_mask, group_reqs, group_counts,
                       group_masks, thr_fp):
        counts, new_avail = schedule_grouped(
            totals, avail, node_mask, group_reqs, group_counts,
            group_masks, thr_fp)
        return counts, new_avail

    dev = resolve_device(device)
    args = tuple(torch.as_tensor(a, device=dev)
                 for a in _example_problem()) + (int(threshold_fp(0.5)),)
    return heartbeat_step, args


def _dryrun_ranks(n_devices: int, device=None) -> list:
    import torch

    from .device import resolve_device
    if device is not None:
        return [resolve_device(device)] * n_devices
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards, "
            f"have {have}; pass device='cuda:0' for {n_devices} ranks on "
            f"one card or device='cpu' for CPU ranks")
    return [torch.device("cuda", i) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the multi-rank checks over ``n_devices`` ranks (see the module
    docstring) and print the ``DRYRUN_PLATFORM:`` stamp; returns it.
    Any failed check raises."""
    return _dryrun_impl(_dryrun_ranks(n_devices, device))


def _dryrun_impl(ranks: list) -> dict:
    """The dry run over ``ranks``.  Sharding layout: node rows of the
    cluster state are the data-parallel axis (each rank owns N/n rows of
    totals/avail and computes feasibility, scores and slot counts for
    them); the water-fill's level search and placement totals are global
    sums, which go through the plane's collectives.  Demand rows are
    replicated."""
    import torch

    from .ops import shard_reduce as sr
    from .ops.ring_attention import full_attention, ring_attention
    from .scheduling.contract import threshold_fp
    from .scheduling.oracle import ClusterState, schedule_grouped_oracle

    n = len(ranks)
    host = _example_problem(n_nodes=8 * n, n_res=4, n_classes=4, n_tasks=64)
    totals_h, avail_h, mask_h, reqs_h, counts_h, gmasks_h = host
    thr = threshold_fp(0.5)
    want = schedule_grouped_oracle(
        ClusterState(totals_h.copy(), avail_h.copy(), mask_h.copy()),
        reqs_h, counts_h, spread_threshold=0.5)

    # the sharded water-fill vs the sequential CPU oracle
    pl = sr.plane_for(n, "flat", ranks)
    placed, new_avail = pl.schedule_grouped(
        pl.shard_rows(totals_h, np.int32), pl.shard_rows(avail_h, np.int32),
        pl.shard_rows(mask_h, bool), pl.replicate(reqs_h, np.int32),
        pl.replicate(counts_h, np.int32), pl.shard_cols(gmasks_h, bool),
        int(thr))
    placed = placed.cpu().numpy()
    if not (placed == want).all():
        raise AssertionError("sharded kernel diverged from CPU oracle")
    if placed.sum() != counts_h.sum():
        raise AssertionError("sharded kernel lost tasks")

    # ray_syncer analogue: each rank's available-resource rows aggregated
    # into a global per-resource load vector with an explicit psum
    load = pl.transport.psum2([a.sum(dim=0).to(torch.int32)
                               for a in new_avail])
    expect = np.concatenate([a.cpu().numpy() for a in new_avail]).sum(0)
    if not all((x.cpu().numpy() == expect).all() for x in load):
        raise AssertionError("psum resource sync diverged")

    _dryrun_sp_step(ranks, full_attention, ring_attention)

    two_level = n >= 4 and n % 2 == 0
    if two_level:
        _dryrun_two_level(ranks, host, thr, want)

    info = {"platform": ranks[0].type, "n_devices": n,
            "cards": len({d for d in ranks if d.type == "cuda"}),
            "two_level_mesh": bool(two_level),
            "checks": ["sharded_waterfill_vs_oracle", "psum_sync",
                       "ring_attention_sp_train_step"]
            + (["two_level_dcn_sync", "two_level_waterfill"]
               if two_level else [])}
    print(f"DRYRUN_PLATFORM: {json.dumps(info)}", flush=True)
    return info


def _dryrun_sp_step(ranks, full_attention, ring_attention):
    """A long-context training step: SEQUENCE-parallel causal ring
    attention inside one step (tokens split on the sequence axis, the
    params' grads through the ring), float32 at "highest" precision,
    its loss within 1e-4 of single-device attention's.  Returns (loss,
    {name: grad}) of the step, taken before the SGD update."""
    import torch

    n = len(ranks)
    b, t, h, dh = 2, 8 * n, 2, 8
    e = h * dh
    rng = np.random.default_rng(7)
    home = ranks[0]
    params = {name: torch.tensor(rng.normal(size=(e, e)) * 0.1,
                                 dtype=torch.float32, device=home,
                                 requires_grad=True)
              for name in ("wq", "wk", "wv")}
    tokens = torch.tensor(rng.normal(size=(b, t, e)), dtype=torch.float32,
                          device=home)

    def loss_of(attend, **kw):
        def proj(w):
            return (tokens @ w).reshape(b, t, h, dh)
        out = attend(proj(params["wq"]), proj(params["wk"]),
                     proj(params["wv"]), causal=True, precision="highest",
                     **kw)
        return (out ** 2).mean()

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")   # the backward's too
    try:
        loss = loss_of(ring_attention, mesh=ranks)
        grads = torch.autograd.grad(loss, list(params.values()))
        loss = float(loss.detach())
        with torch.no_grad():
            want = float(loss_of(full_attention))
    finally:
        torch.set_float32_matmul_precision(prev)
    for g in grads:
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("sp grads not finite")
    if abs(loss - want) >= 1e-4:
        raise AssertionError(f"sp loss {loss} vs {want}")
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p -= 0.01 * g
    return loss, dict(zip(params, grads))


def _dryrun_two_level(ranks, host, thr, want) -> None:
    """2 x (n/2) grid: slice-local (ici) and cross-slice (dcn) sync of the
    resource view, and the grouped water-fill with rows over both levels
    (oracle-checked)."""
    import torch

    from .ops import shard_reduce as sr
    totals_h, avail_h, mask_h, reqs_h, counts_h, gmasks_h = host
    pl = sr.plane_for(len(ranks), "two_level", ranks)
    n_slices, per_slice = pl.mesh.devices.shape
    local = [a.sum(dim=0).to(torch.int32)
             for a in pl.shard_rows(avail_h, np.int32)]
    intra = pl.transport.psum(local, "ici")          # within a slice
    inter = pl.transport.psum(intra, "dcn")          # across slices
    rows_per_slice = avail_h.shape[0] // n_slices
    for s in range(n_slices):
        want_s = avail_h[s * rows_per_slice:(s + 1) * rows_per_slice]
        if not (intra[s * per_slice].cpu().numpy()
                == want_s.sum(axis=0)).all():
            raise AssertionError("slice-local ici sync diverged")
    if not all((x.cpu().numpy() == avail_h.sum(axis=0)).all()
               for x in inter):
        raise AssertionError("cross-slice dcn sync diverged")
    placed, _ = pl.schedule_grouped(
        pl.shard_rows(totals_h, np.int32), pl.shard_rows(avail_h, np.int32),
        pl.shard_rows(mask_h, bool), pl.replicate(reqs_h, np.int32),
        pl.replicate(counts_h, np.int32), pl.shard_cols(gmasks_h, bool),
        int(thr))
    if not (placed.cpu().numpy() == want).all():
        raise AssertionError("two-level grid kernel diverged from CPU "
                             "oracle")

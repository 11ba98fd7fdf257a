#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout: builds every kernel of the slice from
``ray_tpu_torch/ops/csrc`` (one nvcc per source, all at once), holds each
kernel against its plain PyTorch version (and the scheduler against its
numpy host twin) at the shapes the main paths give it, drives the two
main paths through the entry points a user calls, and times them.  Each
phase prints one JSON line; any failure raises and exits non-zero.

Phases:
  device          the card (nvidia-smi name and power limit), torch, CUDA
  build           seconds to build both kernels, ptxas registers/spills,
                  and the SASS instructions that show the Hopper paths
                  (HGMMA and UTMALDG in flash attention, cluster barriers
                  in the water-fill)
  waterfill       ``schedule_grouped`` (kernel ``waterfill_scan``, one
                  launch of a thread-block cluster) at 1000 nodes x 8
                  resources x 64 classes x 1,000,000 tasks: kernel ==
                  plain version on the card == numpy host twin, bit for
                  bit; again at the contract's limit (8192 x 16 x 128,
                  per-class masks, negative avail), which is also timed,
                  and at 8192 x 64 x 32, where the rows spill out of
                  shared memory; the launch each made (cluster size,
                  threads, columns on chip), per-class cost, bounds
  beat            the main path: ``make_delta_scheduler(crm).beat(...)``
                  on the GPU, bench.py's churn cluster at 1000 nodes x 64
                  classes x 1,000,000 tasks per beat, 12 dirty rows of
                  churn between beats; every beat bit-equal to the host
                  twin (counts and lease budgets); beat p50/p99,
                  tasks/s, launches, readbacks per beat
  flash_attention the ops path: ``ops.flash_attention`` at B=2, T=4096,
                  H=16, D=128 (bf16 causal, bf16, f16), bf16 causal at
                  D=64, and f32 at T=1024, D=64, against the plain version
                  within an elementwise limit (FLASH_TOL) that must also
                  reject the plain version with its last 64 keys dropped;
                  kernel/plain/library times, the bound, the share of the
                  bound reached and the ratio to the library call
Then the ``kernels`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.

Exits 1 without printing a result when CUDA is not available.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): tensor-core bf16/f16, f32
# outside the tensor cores, HBM3.  The card's own power limit is printed
# beside every number; a card set below 700 W runs slower than these.
PEAK_TC_16BIT = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# int32 outside the tensor cores: 64 INT32 lanes per SM (a quarter of the
# f32 rate, which counts an FMA as two operations) x 132 SMs x 1.98 GHz
SM_COUNT = 132
PEAK_I32 = 64 * SM_COUNT * 1.98e9

# bench.py's headline problem (reproduced, not imported)
N_NODES, N_RES, N_CLASSES, N_TASKS = 1000, 8, 64, 1_000_000
# Flash attention, kernel vs plain version, elementwise in f32:
#   |kernel - plain| <= atol + rtol * |plain| + p_u * (softmax(QK^T) |V|)
# rtol covers the rounding of the output, p_u the rounding of p for the
# P V product (relative to the sum of |p v| it feeds, which is larger
# than |o| where the terms cancel), atol the f32 sums in another order.
FLASH_TOL = {  # dtype: (atol, rtol, p_u)
    # p stays f32; blockwise sums and FMA: a few hundred f32 ulps
    "float32": (1e-6, 1e-5, 1e-5),
    # output: two f16 ulps (each <= 2**-10 |o|); p to f16: roundoff 2**-11
    "float16": (1e-5, 2.0**-9, 2.0**-11),
    # output: two bf16 ulps (each <= 2**-7 |o|); p to bf16: roundoff 2**-8
    "bfloat16": (1e-5, 2.0**-6, 2.0**-8),
}
# the limit must reject a kernel that skips the last 64 keys (half of the
# 16-bit kernel's 128-key tile, the f32 kernel's whole tile)
FLASH_KEY_TILE = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """p50 over ``reps`` launches of ``fn``, each timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.percentile(times, 50))


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes/HBM rate and ops/peak."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase: device -----------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # the plain versions' f32 products run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})
    return smi


# -- phase: build ------------------------------------------------------------

def phase_build():
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    per_kernel = _build.build()
    total = time.perf_counter() - t0
    ptxas = {}
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln or "warning" in ln]
        ptxas[name] = lines[:40]
    emit({"phase": "build", "seconds": round(total, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in per_kernel.items()},
          "ptxas": ptxas, "sass": sass_evidence(_build)})


# SASS opcodes that show each kernel's Hopper path was compiled in: wgmma
# (HGMMA) and TMA loads (UTMALDG) in flash attention, cluster barriers
# (UCGABAR) in the water-fill
SASS_REQUIRED = {"flash_attention": ("HGMMA", "UTMALDG"),
                 "waterfill": ("UCGABAR",)}


def sass_evidence(_build):
    """Counts of those opcodes in each built library (cuobjdump -sass);
    raises if one is missing."""
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    found = {}
    for name, opcodes in SASS_REQUIRED.items():
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        found[name] = {op: sass.count(op) for op in opcodes}
        missing = [op for op, k in found[name].items() if k == 0]
        if missing:
            raise AssertionError(f"{name}: no {missing} in its SASS")
    return found


# -- phase: waterfill (schedule_grouped) -------------------------------------

def build_problem(seed=0, n_nodes=N_NODES, n_res=N_RES, n_classes=N_CLASSES,
                  n_tasks=N_TASKS):
    """bench.py's build_problem, reproduced."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(400, 12800, size=(n_nodes, n_res)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.25] = 0
    used = (totals * rng.random(totals.shape) * 0.5).astype(np.int32)
    avail = totals - used
    node_mask = np.ones(n_nodes, dtype=bool)
    reqs = rng.integers(0, 400, size=(n_classes, n_res)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    counts = rng.multinomial(n_tasks, np.full(n_classes, 1 / n_classes))
    return totals, avail, node_mask, reqs, counts.astype(np.int32)


def limit_problem(seed=1, n=8192, r=16, g=128, n_tasks=N_TASKS):
    """The contract's limit: MAX_NODES nodes, totals up to MAX_TOTAL_CU,
    per-class masks, dead rows, and rows overcommitted below zero (the
    raylet's planned-load overrides) so floor division sees negatives.
    Overcommit stays within one total (used <= 2 * total), where the
    packed key's score field cannot overflow and the numpy host twin's
    int64 arithmetic agrees with int32."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(400, 1 << 17, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.3] = 0
    avail = totals - (totals * rng.random(totals.shape) * 0.9).astype(
        np.int32)
    neg = rng.random(n) < 0.02
    avail[neg] = -(totals[neg] * rng.random((int(neg.sum()), r))).astype(
        np.int32)
    node_mask = rng.random(n) > 0.01
    reqs = rng.integers(0, 4000, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.6] = 0
    reqs[0] = 0                                   # the empty request
    counts = rng.multinomial(n_tasks, np.full(g, 1 / g)).astype(np.int32)
    counts[1] = 0                                 # a padding row
    masks = rng.random((g, n)) > 0.1
    masks[2] = False                              # an all-masked class
    return totals, avail, node_mask, reqs, counts, masks


def host_twin(totals, avail, node_mask, reqs, counts, masks=None, thr=None,
              require_available=False):
    from ray_tpu_torch.ops.hybrid_kernel import schedule_group_host
    av = np.asarray(avail, np.int64)
    rows = []
    for g in range(reqs.shape[0]):
        row, av = schedule_group_host(
            av, totals, node_mask, reqs[g], counts[g],
            None if masks is None else masks[g], thr,
            require_available=require_available)
        rows.append(row)
    return np.stack(rows), av


def waterfill_ops(reqs, n_nodes):
    """Integer operations the water-fill needs for these inputs: per
    (class, node, requested resource) 17 slot counts (15 bisection steps,
    base, level) of ~6 ops, ~10 for feasibility/capacity and the key."""
    return float((reqs > 0).sum()) * n_nodes * (17 * 6 + 10)


def phase_waterfill(dev):
    import torch

    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling.contract import SCALE, threshold_fp
    thr = threshold_fp(None)

    def on_card(*arrays):
        return [torch.as_tensor(np.ascontiguousarray(a), device=dev)
                for a in arrays]

    def check(name, totals, avail, node_mask, reqs, counts, masks,
              require_available=False, thr=thr):
        args = on_card(totals, avail, node_mask, reqs, counts, masks)
        kc, ka = hk.schedule_grouped(*args, thr, require_available)
        pc, pa = hk.waterfill_scan_plain(*args, thr, require_available)
        torch.cuda.synchronize()
        hc, ha = host_twin(totals, avail, node_mask, reqs, counts, masks,
                           thr, require_available)
        kc, ka, pc, pa = (x.cpu().numpy() for x in (kc, ka, pc, pa))
        ok = (np.array_equal(kc, pc) and np.array_equal(ka, pa)
              and np.array_equal(kc, hc) and np.array_equal(ka, ha))
        if not ok:
            raise AssertionError(
                f"waterfill {name}: kernel/plain/host disagree "
                f"(kernel==plain {np.array_equal(kc, pc)}, "
                f"kernel==host {np.array_equal(kc, hc)}, "
                f"avail {np.array_equal(ka, pa)}/{np.array_equal(ka, ha)})")
        return args, int(kc[:, :-1].sum()), int(kc[:, -1].sum())

    totals, avail, node_mask, reqs, counts = build_problem(seed=0)
    masks = np.ones((N_CLASSES, N_NODES), bool)
    args, placed, queued = check("headline", totals, avail, node_mask, reqs,
                                 counts, masks)
    check("headline require_available", totals, avail, node_mask, reqs,
          counts, masks, True)
    def timing(args, reqs):
        """Kernel ms, the cost of one class ((G classes - 1 class) / (G -
        1): the cluster's dependent chain of 6 exchanges per class), the
        bound, and the same operations at the rate of one SM and of the
        cluster's SMs."""
        n, r = args[0].shape
        g = reqs.shape[0]
        kernel_ms = cuda_ms(lambda: hk.schedule_grouped(*args, thr))
        layout = hk.waterfill_scan.last_layout      # the launch just timed
        one = [args[0], args[1], args[2], args[3][:1], args[4][:1],
               args[5][:1]]
        one_class_ms = cuda_ms(lambda: hk.schedule_grouped(*one, thr))
        n_bytes = (2 * n * r * 4 + n + g * r * 4 + g * 4 + g * n  # inputs
                   + g * (n + 1) * 4 + n * r * 4)                 # outputs
        n_ops = waterfill_ops(reqs, n)
        bound_ms, bound_by = bound(n_bytes, n_ops, PEAK_I32)
        sm_ms = n_ops / (PEAK_I32 / SM_COUNT) * 1e3
        return {"shape": [n, r, g], "cluster": layout["cluster"],
                "layout": layout, "kernel_ms": kernel_ms,
                "one_class_ms": one_class_ms,
                "per_class_ms": (kernel_ms - one_class_ms) / (g - 1),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "one_sm_ops_ms": sm_ms,
                "cluster_sms_ops_ms": sm_ms / layout["cluster"]}

    snap = timing(args, reqs)
    plain_ms = cuda_ms(lambda: hk.waterfill_scan_plain(*args, thr))

    lt, la, lm, lr, lc, lmask = limit_problem()
    largs, _, _ = check("limit 8192x16x128", lt, la, lm, lr, lc, lmask)
    # the autoscaler's first-fit threshold with its fit semantics
    check("limit 8192x16x128 first-fit", lt, la, lm, lr, lc, lmask,
          True, 2 * SCALE + 1)
    limit = timing(largs, lr)
    # 64 resource kinds at the node limit: the rows spill past what 16
    # CTAs' shared memory holds.  Classes ask for kinds among the first
    # and last 6 columns, the last ones past the columns kept on chip.
    wt, wa, wm, wr, wc, wmask = limit_problem(seed=2, r=64, g=32)
    wr[:, 6:58] = 0
    wargs, wplaced, _ = check("wide 8192x64x32", wt, wa, wm, wr, wc, wmask)
    wide = timing(wargs, wr)
    if wide["layout"]["shared_cols"] >= 64 or wplaced == 0:
        raise AssertionError(f"8192 x 64: spilled nothing or placed "
                             f"nothing ({wide['layout']}, {wplaced})")
    wide["placed"] = wplaced
    result = {"phase": "waterfill", "entry": "schedule_grouped",
              "tasks": N_TASKS, "bit_exact": True,
              "checked": ["headline", "headline require_available",
                          "limit 8192x16x128",
                          "limit 8192x16x128 first-fit",
                          "wide 8192x64x32"],
              "placed": placed, "queued_or_infeasible": queued,
              **snap, "plain_ms": plain_ms, "limit": limit, "wide": wide}
    emit(result)
    return result


# -- phase: beat (the main path) ---------------------------------------------

def device_profile(step, n):
    """``torch.profiler`` over ``n`` calls of ``step``: per call, the wall
    time, the device busy time (sum of kernel and copy durations on the
    one stream), the idle share, the device->host copies, and device time
    by kernel name.  The profiler's own overhead is in the wall time, so
    the idle share is an upper bound.  None where the trace holds no
    device events (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    d2h = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name[:80]
        by_name[name] = by_name.get(name, 0.0) + \
            evt.time_range.elapsed_us() / 1e3
        if "DtoH" in evt.name:
            d2h += 1
    if not by_name:
        return {"wall_ms": wall_ms / n, "device_busy_ms": None,
                "idle_share": None, "d2h_copies": None, "by_name_ms": None}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms / n, "device_busy_ms": busy / n,
            "idle_share": 1.0 - busy / wall_ms, "d2h_copies": d2h / n,
            "by_name_ms": {k: v / n for k, v in top}}


def build_cluster(seed=0, n_nodes=N_NODES, n_classes=N_CLASSES,
                  n_tasks=N_TASKS):
    """A port CRM with bench.py's churn cluster (``delta_churn_bench``:
    nodes of CPU 4-63, memory 8-255 and one accelerator 0-7; classes of
    CPU 1-3 and memory 0-7), drawn in the same order, at 1000 nodes x 64
    classes.  The accelerator is named GPU here (TPU there).  Task counts
    are bench.py's headline draw: a multinomial summing to ``n_tasks``."""
    from ray_tpu_torch.common.ids import NodeID
    from ray_tpu_torch.common.resources import NodeResources, ResourceRequest
    from ray_tpu_torch.scheduling import ClusterResourceManager

    rng = np.random.default_rng(seed)
    crm = ClusterResourceManager(capacity=n_nodes)
    for _ in range(n_nodes):
        crm.add_node(NodeID.from_random(), NodeResources(
            {"CPU": int(rng.integers(4, 64)),
             "memory": int(rng.integers(8, 256)),
             "GPU": int(rng.integers(0, 8))}))
    classes = [ResourceRequest({"CPU": int(rng.integers(1, 4)),
                                "memory": float(rng.integers(0, 8))})
               for _ in range(n_classes)]
    vecs = np.stack([crm.intern_request(c) for c in classes])
    counts = rng.multinomial(n_tasks, np.full(n_classes, 1 / n_classes))
    return rng, crm, vecs, counts.astype(np.int32)


def phase_beat(dev, warmup=5, beats=50, churn=12):
    from ray_tpu_torch.common.resources import ResourceRequest
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling import make_delta_scheduler
    from ray_tpu_torch.scheduling.contract import (compute_budgets,
                                                   threshold_fp)

    rng, crm, vecs, counts = build_cluster()
    thr = threshold_fp(None)
    churn_req = ResourceRequest({"CPU": 1})
    debts: list[int] = []

    def mutate():
        # bench.py's delta churn: force_subtract / add_back
        for _ in range(churn):
            if debts and rng.random() < 0.5:
                crm.add_back(debts.pop(), churn_req)
            else:
                row = int(rng.integers(0, N_NODES))
                crm.force_subtract(row, churn_req)
                debts.append(row)

    # --- the main path: counts start at 0 here and are read after ---
    hk.waterfill_scan.launches = 0
    eng = make_delta_scheduler(crm)
    if eng.device.type != "cuda":
        raise AssertionError(f"the heartbeat resolved to {eng.device}")
    times, mismatches = [], 0
    for i in range(warmup + beats):
        mutate()
        t0 = time.perf_counter()
        got = eng.beat(vecs, counts)
        dt = (time.perf_counter() - t0) * 1e3
        if i >= warmup:
            times.append(dt)
        st = crm.snapshot()
        want, post = host_twin(st.totals, st.avail, st.node_mask, vecs,
                               counts, None, thr)
        budgets = np.stack([eng.budget_row_host(v) for v in vecs])
        want_b = compute_budgets(st.totals, post, vecs, st.node_mask)
        if not (np.array_equal(got, want) and np.array_equal(budgets,
                                                             want_b)):
            mismatches += 1
    launches = hk.waterfill_scan.launches
    layout = hk.waterfill_scan.last_layout
    readbacks = eng.readbacks
    # --- end of the main path ---
    n_beats = warmup + beats
    if mismatches:
        raise AssertionError(f"{mismatches}/{n_beats} beats disagree with "
                             "the host twin")
    if launches != n_beats:
        raise AssertionError(f"waterfill_scan launched {launches} times in "
                             f"{n_beats} beats")
    if readbacks != n_beats:
        raise AssertionError(f"{readbacks} readbacks in {n_beats} beats")

    def step():
        mutate()
        eng.beat(vecs, counts)

    trace = device_profile(step, 10)
    # per-layer breakdown: profile mode syncs after every phase, so these
    # beats are slower than the timed ones and are not counted above
    eng.profile = True
    for k in eng.phase_ms:
        eng.phase_ms[k] = 0.0
    n_prof = 10
    for _ in range(n_prof):
        mutate()
        eng.beat(vecs, counts)
    p50 = float(np.percentile(times, 50))
    result = {"phase": "beat", "entry": "make_delta_scheduler(crm).beat",
              "nodes": N_NODES, "classes": N_CLASSES,
              "tasks_per_beat": int(counts.sum()),
              "dirty_rows_per_beat": churn, "beats": n_beats,
              "timed_beats": beats, "bit_exact_beats": n_beats,
              "beat_p50_ms": p50,
              # p80: the highest percentile with ten timed beats above it
              "beat_p80_ms": float(np.percentile(times, 80)),
              "beat_p99_ms": float(np.percentile(times, 99)),
              "tasks_per_s": int(counts.sum()) / (p50 / 1e3),
              "hit_rate": eng.hit_rate(),
              "waterfill_launches": launches,
              "waterfill_layout": layout,
              "readbacks_per_beat": readbacks / n_beats,
              "phases_ms_per_beat_profiled": {
                  k: v / n_prof for k, v in eng.phase_ms.items()},
              "device_profile": trace, "stats": eng.stats}
    emit(result)
    return result


# -- phase: flash attention --------------------------------------------------

def drop_last_key_tile(q, k, v, causal, tile=FLASH_KEY_TILE):
    """The plain version with the last ``tile`` keys left out: what a
    kernel that skipped its last key tile would return."""
    import torch
    t, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() / math.sqrt(d), k.float())
    dead = torch.zeros((t, t), dtype=torch.bool, device=q.device)
    dead[:, t - tile:] = True
    if causal:
        dead |= torch.ones_like(dead).triu(1)
    p = torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def phase_flash(dev):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, t, h, d, dtype):
        return [torch.randn((b, t, h, d), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
                for _ in range(3)]

    # --- the main path: the ops entry point at the headline shape ---
    q, k, v = qkv(2, 4096, 16, 128, torch.bfloat16)
    ops.flash_attention.launches = 0
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    main_launches = ops.flash_attention.launches
    # --- end of the main path ---
    if main_launches < 1:
        raise AssertionError("ops.flash_attention did not launch the kernel")
    if out.shape != q.shape or out.dtype != q.dtype or \
            not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("flash attention output: wrong shape/dtype or "
                             "not finite")

    cases = [("bfloat16", True, 2, 4096, 16, 128),
             ("bfloat16", False, 2, 4096, 16, 128),
             ("float16", False, 2, 4096, 16, 128),
             ("bfloat16", True, 2, 4096, 16, 64),
             ("float32", False, 2, 1024, 16, 64)]
    rows = []
    for dtype_name, causal, b, t, h, d in cases:
        dtype = getattr(torch, dtype_name)
        q, k, v = qkv(b, t, h, d, dtype)
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention_plain(q, k, v, causal=causal).float()
        atol, rtol, p_u = FLASH_TOL[dtype_name]
        pv_abs = ops.flash_attention_plain(q.float(), k.float(),
                                           v.float().abs(), causal=causal)
        limit = atol + rtol * want.abs() + p_u * pv_abs
        del pv_abs
        err = (got.float() - want).abs()
        max_err, ratio = float(err.max()), float((err / limit).max())
        if not ratio <= 1.0:
            raise AssertionError(f"flash attention {dtype_name} causal="
                                 f"{causal}: error {ratio} x its limit "
                                 f"(max abs err {max_err})")
        # the limit must be tight enough to fail a kernel that skips its
        # last key tile
        faulty = drop_last_key_tile(q, k, v, causal).float()
        fault_ratio = float(((faulty - want).abs() / limit).max())
        del faulty, err, limit
        if not fault_ratio > 1.0:
            raise AssertionError(f"flash attention {dtype_name} causal="
                                 f"{causal}: the limit passes a dropped "
                                 f"key tile ({fault_ratio} x)")
        kernel_ms = cuda_ms(lambda: ops.flash_attention(q, k, v,
                                                       causal=causal))
        plain_ms = cuda_ms(lambda: ops.flash_attention_plain(
            q, k, v, causal=causal))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        flops = 4.0 * b * h * t * t * d * (0.5 if causal else 1.0)
        n_bytes = 4.0 * b * t * h * d * q.element_size()
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_TC_16BIT
        bound_ms, bound_by = bound(n_bytes, flops, peak)
        rows.append({"dtype": dtype_name, "causal": causal,
                     "shape": [b, t, h, d], "max_abs_err": max_err,
                     "atol": atol, "rtol": rtol, "p_u": p_u,
                     "max_err_over_limit": ratio,
                     "dropped_tile_err_over_limit": fault_ratio,
                     "kernel_ms": kernel_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / kernel_ms,
                     "vs_library": kernel_ms / library_ms,
                     "tflops": flops / (kernel_ms / 1e3) / 1e12})
    result = {"phase": "flash_attention", "entry": "ops.flash_attention",
              "main_path_launches": main_launches, "cases": rows}
    emit(result)
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs a GPU", file=sys.stderr)
        return 1
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    wf = phase_waterfill(dev)
    beat = phase_beat(dev)
    fl = phase_flash(dev)
    head = fl["cases"][0]
    emit({"kernels": [
        {"name": "waterfill_scan", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/waterfill.cu",
         "replaces": "ray_tpu/ops/hybrid_kernel.py:160 (schedule_grouped "
                     "lax.scan; fused_beat scan :406, body "
                     "_schedule_group :95)",
         # 0: the waterfill phase raises unless it is bit-exact
         "launches": beat["waterfill_launches"], "max_abs_err": 0,
         "ms": wf["kernel_ms"], "plain_ms": wf["plain_ms"],
         "cluster": wf["cluster"],
         "bound_ms": wf["bound_ms"], "bound_by": wf["bound_by"],
         "library_ms": None, "checked": True},
        {"name": "flash_attention", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:25",
         "launches": fl["main_path_launches"],
         "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
         "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "library_ms": head["library_ms"],
         "checked": True},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout: builds every kernel of the slice from
``ray_tpu_torch/ops/csrc`` (one nvcc per source, all at once), holds each
kernel against its plain PyTorch version (and the scheduler against its
numpy host twin) at the shapes the main paths give it, drives the main
paths (the heartbeat, the runtime through ``init/remote/get``, flash
attention) through the entry points a user calls, and times them.  Each
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
  locality        ``schedule_grouped_localized`` (the water-fill kernel's
                  localized mode) == plain version == host twin with
                  preferred rows, bit for bit, at the beat cell's width
                  (1000 x 8 x 64 x 1M), the limit (8192 x 16 x 128) and a
                  spilling width (8192 x 64 x 32): infeasible and
                  negative-avail preferred rows, avoid masks; times, bound
  runtime         the main path through the user's entry points:
                  ``ray_tpu_torch.init`` on the GPU with 8 nodes, a
                  10,000-task burst over 4 classes (device rounds by
                  route, launches by mode, tasks/s, the driver's CPU by
                  thread, time in placement rounds, where the raylet
                  threads are), a 2,000-consumer locality burst
                  over 8 blobs (localized launches, every consumer on its
                  data node by pid), two placement groups in one device
                  batch, an actor, put/get/wait; then the head raylet at
                  1000 rows: 100,000 specs over 64 classes with locality
                  rows and avoid flags, rows == the host twin's
  dataplane       bundle (1000 x 64 groups x 8), pull (4096 x 1000) and
                  broadcast (1000 members, fan-out 4) programs on the card
                  == their numpy oracles; ms and kernel launches
  flash_attention the ops path: ``ops.flash_attention`` at B=2, T=4096,
                  H=16, D=128 (bf16 causal, bf16, f16), bf16 causal at
                  D=64, and f32 at T=1024, D=64, against the plain version
                  within an elementwise limit (FLASH_TOL) that must also
                  reject the plain version with its last 64 keys dropped;
                  kernel/plain/library times, the bound, the share of the
                  bound reached and the ratio to the library call; then
                  every head dim of FLASH_HEAD_DIMS (zero-padded or the
                  D=256 FMA kernel), bf16 and f32, causal and not
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
        # each kernel's (mangled) name, then its spills and registers
        lines = [ln.strip().replace("ptxas info    : ", "")
                 for ln in _build.build_log(name).splitlines()
                 if "Function properties for" in ln or "registers" in ln
                 or "spill" in ln or "warning" in ln]
        ptxas[name] = lines[:60]
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
              require_available=False, prefs=None):
    """The numpy host twin class by class (``schedule_group_host``; with
    ``prefs``, each class's preferred row, -1 for none)."""
    from ray_tpu_torch.ops.hybrid_kernel import schedule_group_host
    av = np.asarray(avail, np.int64)
    rows = []
    for g in range(reqs.shape[0]):
        pref = -1 if prefs is None else int(prefs[g])
        row, av = schedule_group_host(
            av, totals, node_mask, reqs[g], counts[g],
            None if masks is None else masks[g], thr,
            pref_row=min(pref, totals.shape[0] - 1),
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
    plain_ms = cuda_ms(lambda: hk.waterfill_scan_plain(*args, thr), reps=2,
                       warmup=0)

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


# -- phase: locality (the localized water-fill) ------------------------------

def with_prefs(seed, totals, avail, node_mask, reqs, masks):
    """A localized problem from a water-fill one: half the classes prefer
    a row; of those a quarter find it infeasible (its total below the
    request) and a quarter find its avail negative (within one total); a
    quarter of all classes carry an avoid mask (their class mask drops
    one row, their preferred one where they have it)."""
    rng = np.random.default_rng(seed)
    g, n = reqs.shape[0], totals.shape[0]
    totals, avail, node_mask = totals.copy(), avail.copy(), node_mask.copy()
    masks = np.ones((g, n), bool) if masks is None else masks.copy()
    prefs = np.full(g, -1, np.int32)
    has = np.flatnonzero(rng.random(g) < 0.5)
    prefs[has] = rng.integers(0, n, size=has.size)
    for gi in has[::4]:                          # infeasible preferred row
        pos = np.flatnonzero(reqs[gi] > 0)
        if pos.size:
            p, c = prefs[gi], pos[0]
            totals[p, c] = reqs[gi, c] - 1
            avail[p, c] = min(avail[p, c], totals[p, c])
    for gi in has[1::4]:                         # negative avail there
        p = prefs[gi]
        avail[p] = -(totals[p] // 2)
        node_mask[p] = True
    for gi in np.flatnonzero(rng.random(g) < 0.25):   # avoid masks
        masks[gi, prefs[gi] if prefs[gi] >= 0 else rng.integers(0, n)] = False
    return totals, avail, node_mask, masks, prefs


def phase_locality(dev):
    """``schedule_grouped_localized`` (the water-fill kernel's localized
    mode) against its plain version on the card and the numpy host twin,
    bit for bit, at the beat cell's width, the contract's limit and a
    spilling width; kernel, per-class and plain times and the bound."""
    import torch

    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import locality_kernel as lk
    from ray_tpu_torch.scheduling.contract import threshold_fp
    thr = threshold_fp(None)
    problems = {}
    t, a, m, r, c = build_problem(seed=0)
    problems["beat 1000x8x64"] = (t, a, m, r, c, None)
    problems["limit 8192x16x128"] = limit_problem()
    wt, wa, wm, wr, wc, wmask = limit_problem(seed=2, r=64, g=32)
    wr[:, 6:58] = 0
    problems["wide 8192x64x32"] = (wt, wa, wm, wr, wc, wmask)
    out = {}
    for name, (t, a, m, r, c, masks) in problems.items():
        t, a, m, masks, prefs = with_prefs(len(out) + 5, t, a, m, r, masks)
        args = [torch.as_tensor(np.ascontiguousarray(x), device=dev)
                for x in (t, a, m, r, c, masks, prefs)]
        kc, ka = lk.schedule_grouped_localized(*args, thr)
        layout = hk.waterfill_scan.last_layout
        pc, pa = hk.waterfill_scan_plain(*args[:6], thr, False, args[6])
        torch.cuda.synchronize()
        hc, ha = host_twin(t, a, m, r, c, masks, thr, prefs=prefs)
        kc, ka, pc, pa = (x.cpu().numpy() for x in (kc, ka, pc, pa))
        if not (np.array_equal(kc, pc) and np.array_equal(ka, pa)
                and np.array_equal(kc, hc) and np.array_equal(ka, ha)):
            raise AssertionError(
                f"locality {name}: kernel/plain/host disagree (kernel=="
                f"plain {np.array_equal(kc, pc)}, kernel==host "
                f"{np.array_equal(kc, hc)}, avail {np.array_equal(ka, pa)}"
                f"/{np.array_equal(ka, ha)})")
        pref_rows = prefs >= 0
        took = int(sum(kc[g, prefs[g]] for g in np.flatnonzero(pref_rows)))
        n, rr = t.shape
        g = r.shape[0]
        kernel_ms = cuda_ms(lambda: lk.schedule_grouped_localized(*args,
                                                                  thr))
        one_ms = cuda_ms(lambda: lk.schedule_grouped_localized(
            *[x[:1] if i >= 3 else x for i, x in enumerate(args)], thr))
        plain_ms = cuda_ms(lambda: hk.waterfill_scan_plain(
            *args[:6], thr, False, args[6]), reps=1, warmup=0)
        n_bytes = (2 * n * rr * 4 + n + g * rr * 4 + g * 4 + g * n + g * 4
                   + g * (n + 1) * 4 + n * rr * 4)
        bound_ms, bound_by = bound(n_bytes, waterfill_ops(r, n), PEAK_I32)
        out[name] = {"shape": [n, rr, g], "layout": layout,
                     "classes_with_pref": int(pref_rows.sum()),
                     "placed_on_pref_rows": took,
                     "placed": int(kc[:, :-1].sum()),
                     "kernel_ms": kernel_ms,
                     "per_class_ms": (kernel_ms - one_ms) / (g - 1),
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "max_abs_err": 0}
    result = {"phase": "locality", "entry": "schedule_grouped_localized",
              "bit_exact": True, "problems": out}
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


def phase_beat(dev, warmup=2, beats=50, churn=12):
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


# -- phase: runtime (the main path through init/remote/get) ------------------

# 20,000 tasks took 85 s of a 264 s run on the H100 (PERF.md); 10,000
# keeps the run near 3 minutes
RUNTIME_TASKS = 10_000
RUNTIME_CONSUMERS = 2_000
RAYLET_NODES, RAYLET_SPECS, RAYLET_CLASSES = 1000, 100_000, 64


def _noop(i):
    return i


def _blob(i):
    return bytes([i]) * 300_000


def _where(b):
    import os
    return os.getpid(), b[0]


class _Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


def raylet_specs(rng, crm, n_specs, n_classes):
    """Default-strategy task specs over ``n_classes`` resource classes,
    each with a preferred row for half its tasks (as ``_locality_row``
    would answer for tasks with plasma args) and an avoid flag (a lease
    spillback) on one task in 20."""
    from ray_tpu_torch.common.ids import JobID, TaskID
    from ray_tpu_torch.common.resources import ResourceRequest
    from ray_tpu_torch.common.task_spec import TaskSpec, TaskType
    job = JobID.from_int(3)
    classes = [ResourceRequest({"CPU": int(rng.integers(1, 4)),
                                "memory": int(rng.integers(0, 8))})
               for _ in range(n_classes)]
    class_pref = rng.integers(0, crm.num_nodes(), size=n_classes)
    picks = rng.integers(0, n_classes, size=n_specs)
    with_pref = rng.random(n_specs) < 0.5
    avoid = rng.random(n_specs) < 0.05
    specs = [TaskSpec(task_id=TaskID.for_task(job), job_id=job,
                      task_type=TaskType.NORMAL_TASK,
                      function_descriptor="chip_smoke:_noop",
                      resources=classes[int(c)]) for c in picks]
    # a spilled-back task places away from this node with no locality
    # row (_schedule_rows_soft drops it: the data node starved it)
    prefs = [int(class_pref[c]) if w and not a else None
             for c, w, a in zip(picks, with_pref, avoid)]
    return specs, prefs, [bool(a) for a in avoid]


class _Rec:
    def __init__(self, spec):
        self.spec = spec


def _cpu_s(stat_path):
    """utime + stime of a /proc stat file, in seconds (0 if it is gone)."""
    import os
    try:
        with open(stat_path) as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return 0.0
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def host_cpu(cluster):
    """CPU seconds so far of this process's threads, summed by thread name
    without its trailing number (raylet-3 -> raylet), and of every worker
    process of the cluster's pools (Linux /proc)."""
    import re
    import threading
    names = {t.native_id: re.sub(r"[-_]?\d+$", "", t.name)
             for t in threading.enumerate()}
    by_name: dict[str, float] = {}
    for tid in Path("/proc/self/task").iterdir():
        name = names.get(int(tid.name), "other")
        by_name[name] = by_name.get(name, 0.0) + _cpu_s(tid / "stat")
    pids = set()
    for r in cluster.raylets.values():
        with r.pool._lock:
            pids |= {h.proc.pid for h in r.pool._workers}
    return by_name, sum(_cpu_s(f"/proc/{p}/stat") for p in pids)


class StackSampler:
    """Where this process's threads named ``prefix``... are, sampled
    every ``interval`` s from a thread of its own (``sys._current_frames``):
    per sample of such a thread, its innermost frame in the port and that
    frame's caller in the port (file:function), or "waiting" where it is
    parked in a wait of threading, selectors or queue.  The sampler takes
    the GIL to look, so a thread that holds it is seen where it lets go."""

    _WAITS = ("threading.py", "selectors.py", "queue.py")

    def __init__(self, prefix, interval=0.005):
        import threading
        self.prefix, self.interval = prefix, interval
        self.counts: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stack-sampler")

    def _label(self, frame):
        if frame.f_code.co_filename.endswith(self._WAITS):
            return "waiting"
        names = []
        while frame is not None and len(names) < 2:
            path = frame.f_code.co_filename
            if "/ray_tpu_torch/" in path:
                names.append(path.rsplit("/ray_tpu_torch/", 1)[1] + ":"
                             + frame.f_code.co_name)
            frame = frame.f_back
        return " <- ".join(names) or "outside the port"

    def _run(self):
        import threading
        while not self._stop.wait(self.interval):
            ids = {t.ident for t in threading.enumerate()
                   if t.name.startswith(self.prefix)}
            for ident, frame in sys._current_frames().items():
                if ident in ids:
                    label = self._label(frame)
                    self.counts[label] = self.counts.get(label, 0) + 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def report(self, top=10):
        """Samples, the share waiting, and the top labels by their share
        of the samples that were not waiting."""
        n = sum(self.counts.values())
        busy = n - self.counts.get("waiting", 0)
        shares = sorted(((k, v / busy) for k, v in self.counts.items()
                         if k != "waiting"), key=lambda kv: -kv[1]) \
            if busy else []
        return {"threads": self.prefix + "*", "samples": n,
                "interval_s": self.interval,
                "waiting_share": 1 - busy / n if n else None,
                "busy_shares": dict(shares[:top])}


class _RoundTimer:
    """Wall seconds a raylet method spends, wrapped on the instance."""

    def __init__(self, raylets, method):
        self.seconds = 0.0
        for r in raylets:
            setattr(r, method, self._timed(getattr(r, method)))

    def _timed(self, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
        return run


def raylet_full_width(cluster, seed=0):
    """The head raylet at 1000 rows: its CRM grown with ``crm.add_node``
    (no raylets behind the new rows), one 100,000-spec round of 64
    classes with locality rows and avoid flags through
    ``_schedule_rows_soft`` (the device path), held row for row against
    ``_schedule_rows_host_subgrouped`` on the same snapshot."""
    from ray_tpu_torch.common.ids import NodeID
    from ray_tpu_torch.common.resources import NodeResources
    from ray_tpu_torch.ops import hybrid_kernel as hk
    rng = np.random.default_rng(seed)
    crm, head = cluster.crm, cluster.head()
    while crm.num_nodes() < RAYLET_NODES:
        crm.add_node(NodeID.from_random(), NodeResources(
            {"CPU": int(rng.integers(4, 64)),
             "memory": int(rng.integers(8, 256))}))
    specs, prefs, avoids = raylet_specs(rng, crm, RAYLET_SPECS,
                                        RAYLET_CLASSES)
    by_id = {s.task_id: p for s, p in zip(specs, prefs)}
    head._locality_row = lambda spec: by_id[spec.task_id]
    head._avoid_local.update(s.task_id for s, a in zip(specs, avoids) if a)
    rounds, loc0 = head.device_rounds, hk.waterfill_scan.localized_launches
    t0 = time.perf_counter()
    got = head._schedule_rows_soft([_Rec(s) for s in specs])
    device_ms = (time.perf_counter() - t0) * 1e3
    del head._locality_row
    if head.device_rounds != rounds + 1 or \
            hk.waterfill_scan.localized_launches != loc0 + 1:
        raise AssertionError("the full-width round did not take the "
                             "localized kernel")
    t0 = time.perf_counter()
    want = head._schedule_rows_host_subgrouped(specs, prefs, avoids)
    host_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"full-width raylet: {bad} of {len(got)} rows "
                             "differ from the host twin")
    return {"nodes": crm.num_nodes(), "specs": len(specs),
            "classes": RAYLET_CLASSES,
            "subgroups": len({(s.scheduling_class(), p, a)
                              for s, p, a in zip(specs, prefs, avoids)}),
            "placed": sum(r >= 0 for r in got),
            "on_pref_row": sum(r == p for r, p in zip(got, prefs)),
            "rows_equal_host_twin": True, "device_round_ms": device_ms,
            "host_twin_ms": host_ms}


def phase_runtime(dev):
    """The runtime on the card through the entry points a user calls:
    ``init`` on the GPU, 7 more nodes, a 10,000-task burst over 4
    resource classes (the delta beat), a locality burst (the localized
    kernel; every consumer in a worker of its argument's node), two
    placement groups in one device batch, an actor, put/get/wait, and
    the head raylet at 1000 rows (rows == host twin); then shutdown."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.api import _get_runtime
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    placement_group_table,
                                                    remove_placement_group)
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    t_start = time.perf_counter()
    rt.init(resources={"CPU": 8, "memory": 8}, num_workers=2,
            system_config={"scheduler_device_batch_min": 256})
    try:
        runtime = _get_runtime()
        cluster = runtime.cluster
        if cluster.scheduler_device.type != "cuda":
            raise AssertionError(f"the scheduler resolved to "
                                 f"{cluster.scheduler_device}")
        nodes = [cluster.head().node_id] + [
            cluster.add_node(num_workers=2) for _ in range(7)]
        noop = rt.remote(_noop)
        shapes = [{"num_cpus": 1}, {"num_cpus": 0.5},
                  {"resources": {"CPU": 1, "memory": 0.5}},
                  {"num_cpus": 0.25}]
        noop.remote(0)                          # warm the function table
        rt.get([noop.remote(i) for i in range(len(nodes) * 2)])
        head = cluster.head()

        raylets = list(cluster.raylets.values())
        placing = _RoundTimer(raylets, "_schedule_rows_soft")
        on_device = _RoundTimer(raylets, "_schedule_rows_device")

        def rounds():
            return np.array([[r.device_rounds, r.delta_rounds, r.host_rounds]
                             for r in raylets]).sum(axis=0)

        # --- the main path: counts start at 0 here and are read after ---
        hk.waterfill_scan.launches = 0
        hk.waterfill_scan.localized_launches = 0
        rounds0 = rounds()
        cpu0, workers_cpu0 = host_cpu(cluster)
        driver_cpu0 = _cpu_s("/proc/self/stat")
        with StackSampler("raylet") as sampler:
            t0 = time.perf_counter()
            refs = [noop.options(**shapes[i % 4]).remote(i)
                    for i in range(RUNTIME_TASKS)]
            out = rt.get(refs, timeout=600)
            burst_s = time.perf_counter() - t0
        driver_cpu = _cpu_s("/proc/self/stat") - driver_cpu0
        cpu1, workers_cpu1 = host_cpu(cluster)
        if out != list(range(RUNTIME_TASKS)):
            raise AssertionError("the task burst returned wrong results")
        burst_launches = {"waterfill_scan": hk.waterfill_scan.launches,
                          "localized": hk.waterfill_scan.localized_launches}
        device_rounds, delta_rounds, host_rounds = \
            (int(x) for x in rounds() - rounds0)
        burst_host = {
            "driver_cpu_s": driver_cpu,
            "driver_cpu_per_wall_s": driver_cpu / burst_s,
            "driver_threads_cpu_s": dict(sorted(
                ((k, v - cpu0.get(k, 0.0)) for k, v in cpu1.items()),
                key=lambda kv: -kv[1])),
            "workers_cpu_s": workers_cpu1 - workers_cpu0,
            "placement_rounds_s": placing.seconds,
            "device_rounds_s": on_device.seconds,
            "raylet_stacks": sampler.report()}
        loc0 = hk.waterfill_scan.localized_launches

        blob = rt.remote(_blob)
        where = rt.remote(_where)
        blobs = [blob.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=nid, soft=False)).remote(i) for i, nid in enumerate(nodes)]
        rt.wait(blobs, num_returns=len(blobs), timeout=120)
        t0 = time.perf_counter()
        got = rt.get([where.remote(blobs[i % len(blobs)])
                      for i in range(RUNTIME_CONSUMERS)], timeout=600)
        locality_s = time.perf_counter() - t0
        loc_launches = hk.waterfill_scan.localized_launches - loc0
        pids = {}
        for r in cluster.raylets.values():
            with r.pool._lock:
                pids[r.row] = {h.proc.pid for h in r.pool._workers}
        home = {i: cluster.crm.row_of(nid) for i, nid in enumerate(nodes)}
        misplaced = sum(pid not in pids[home[b]] for pid, b in got)
        if loc_launches < 1 or misplaced:
            raise AssertionError(f"locality burst: {loc_launches} localized "
                                 f"launches, {misplaced} consumers off "
                                 "their data node")

        # two placement groups pending together, placed in one pass
        pg_dev0 = getattr(cluster.pg_manager, "device_batches", 0)
        hog = placement_group([{"CPU": 1}] * 22, strategy="PACK")
        if not hog.wait(timeout_seconds=60):
            raise AssertionError("the hog placement group did not place")
        spread = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
        pack = placement_group([{"CPU": 1}] * 2, strategy="STRICT_PACK")
        remove_placement_group(hog)
        if not (spread.wait(timeout_seconds=60)
                and pack.wait(timeout_seconds=60)):
            raise AssertionError("placement groups did not place")
        table = placement_group_table()
        s_rows = table[spread.id.hex()]["node_rows"]
        p_rows = table[pack.id.hex()]["node_rows"]
        pg_batches = getattr(cluster.pg_manager, "device_batches", 0) - \
            pg_dev0
        if len(set(s_rows)) != 3 or len(set(p_rows)) != 1 or pg_batches < 1:
            raise AssertionError(f"placement groups: spread {s_rows}, pack "
                                 f"{p_rows}, {pg_batches} device batches")
        remove_placement_group(spread)
        remove_placement_group(pack)

        counter = rt.remote(_Counter).remote()
        calls = rt.get([counter.incr.remote() for _ in range(100)])
        arr = np.arange(1 << 18, dtype=np.float32)          # 1 MB
        back = rt.get(rt.put(arr))
        ready, rest = rt.wait([noop.remote(1), counter.incr.remote()],
                              num_returns=2, timeout=60)
        if calls != list(range(1, 101)) or not np.array_equal(back, arr) \
                or len(ready) != 2 or rest:
            raise AssertionError("actor / put-get / wait returned wrong "
                                 "results")
        launches = {"waterfill_scan": hk.waterfill_scan.launches,
                    "localized": hk.waterfill_scan.localized_launches}
        # --- end of the main path ---
        # the burst's uniform rounds went through the delta beat
        if burst_launches["waterfill_scan"] < 1 or delta_rounds < 1:
            raise AssertionError(
                f"the burst made {device_rounds} device rounds, "
                f"{delta_rounds} through the delta beat, and launched "
                f"{burst_launches}")
        full = raylet_full_width(cluster)
    finally:
        rt.shutdown()
    result = {"phase": "runtime", "entry": "ray_tpu_torch.init/remote/get",
              "nodes": len(nodes), "tasks": RUNTIME_TASKS,
              "burst_s": burst_s, "tasks_per_s": RUNTIME_TASKS / burst_s,
              "device_rounds": device_rounds, "delta_rounds": delta_rounds,
              # device rounds that uploaded a snapshot: a locality row or
              # an avoid flag (a lease spillback) in the batch
              "snapshot_rounds": device_rounds - delta_rounds,
              "host_rounds": host_rounds,
              "burst_launches": burst_launches, "burst_host": burst_host,
              "consumers": RUNTIME_CONSUMERS, "locality_s": locality_s,
              "consumers_on_data_node": RUNTIME_CONSUMERS - misplaced,
              "placement_group_device_batches": pg_batches,
              "launches": launches, "raylet_full_width": full,
              "seconds": time.perf_counter() - t_start}
    emit(result)
    return result


# -- phase: dataplane (bundle, pull and broadcast programs) ------------------

def kernel_launches(fn):
    """CUDA kernels one call of ``fn`` launches (torch.profiler), or None
    where the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the trace's raw events: prof.events() builds a Python object per
    # event (~0.25 ms each), most of this phase's time at ~160,000 launches
    n = sum(1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and "Memcpy" not in e.name() and "Memset" not in e.name())
    return n or None


def phase_dataplane(dev):
    """The bundle, pull and broadcast programs on the card (plain
    PyTorch loops) against their numpy oracles, exact: 1000 nodes x 64
    placement groups x 8 bundles of every strategy, 4096 pulls over 1000
    nodes, a 1000-member broadcast tree of fan-out 4."""
    from ray_tpu_torch.ops import broadcast_kernel as bc
    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import pull_kernel as pk
    rng = np.random.default_rng(0)
    n = 1000
    totals = rng.integers(0, 6400, size=(n, 8)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.25] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.02
    reqs = rng.integers(0, 800, size=(64, 8, 8)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    valid = rng.random((64, 8)) < 0.85
    strat = np.arange(64) % 4
    bw = rng.integers(0, 50_000, size=(n, n)).astype(np.int32)
    bw[rng.random((n, n)) < 0.05] = 0
    np.fill_diagonal(bw, 0)
    infl = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    loc = rng.random((4096, n)) < 0.01
    dest = rng.integers(0, n, size=4096).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=4096).astype(np.int32)
    member = rng.random(n) < 0.9
    member[0] = True
    # (bytes, int32 operations) each program needs for these inputs: every
    # input read once, every output written once; the operations of the
    # JAX formulation (per bundle two masked key passes of ~16 ops per
    # (node, resource); per pull ~6 per node; per attach step ~8 per
    # (parent, child) pair)
    r_w, n_b = totals.shape[1], int(valid.sum())
    work = {"bundles": (2 * n * r_w * 4 + n + reqs.size * 4 + valid.size
                        + 64 * 8 * 4 + 64 + n * r_w * 4,
                        n_b * 2 * n * r_w * 16),
            "pulls": (loc.size + bw.size * 4 + 4096 * 8 + n * 4 + 4096 * 8,
                      4096 * n * 6),
            "broadcast": (n + bw.size * 4 + n * 4 + n * 8, n * n * n * 8)}
    programs = {
        "bundles": (lambda: bk.schedule_bundle_groups_np(
            totals, avail, mask, reqs, valid, strat, device=dev),
            lambda: bk.schedule_bundle_groups_oracle(
                totals, avail, mask, reqs, valid, strat)),
        "pulls": (lambda: pk.choose_sources_np(loc, bw, dest, sizes, infl,
                                               device=dev),
                  lambda: pk.choose_sources_oracle(loc, bw, dest, sizes,
                                                   infl)),
        "broadcast": (lambda: bc.plan_fanout_np(member, bw, 0, 4, infl,
                                                device=dev),
                      lambda: bc.plan_fanout_oracle(member, bw, 0, 4, infl)),
    }
    out = {}
    for name, (run, oracle) in programs.items():
        t0 = time.perf_counter()
        got = run()                 # numpy out: the call ends in a sync
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = oracle()
        oracle_ms = (time.perf_counter() - t0) * 1e3
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"dataplane {name}: the card disagrees "
                                 "with the numpy oracle")
        bound_ms, bound_by = bound(*work[name], PEAK_I32)
        out[name] = {"ms": ms, "oracle_ms": oracle_ms,
                     "launches": kernel_launches(run), "bound_ms": bound_ms,
                     "bound_by": bound_by, "exact": True}
        if name == "bundles":
            out[name]["placed_groups"] = int(got[1].sum())
    result = {"phase": "dataplane", "problems": {
        "bundles": [n, 64, 8], "pulls": [4096, n], "broadcast": [n, 4]},
        **out}
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
              "main_path_launches": main_launches, "cases": rows,
              "head_dims": flash_head_dims(qkv)}
    emit(result)
    return result


# head dims the kernel reaches by zero padding (64, 128) or at 256 (FMA)
FLASH_HEAD_DIMS = (16, 32, 80, 96, 160, 256)


def flash_head_dims(qkv, b=2, t=1024, h=4):
    """Every head dim up to 256, causal and not, bf16 and f32, at (b, t,
    h, d): the kernel within FLASH_TOL of the plain version, and the limit
    still rejecting the plain version with its last key tile dropped."""
    import torch

    from ray_tpu_torch import ops
    rows = []
    for d in FLASH_HEAD_DIMS:
        for dtype_name in ("bfloat16", "float32"):
            for causal in (False, True):
                q, k, v = qkv(b, t, h, d, getattr(torch, dtype_name))
                got = ops.flash_attention(q, k, v, causal=causal).float()
                want = ops.flash_attention_plain(q, k, v,
                                                 causal=causal).float()
                atol, rtol, p_u = FLASH_TOL[dtype_name]
                limit = atol + rtol * want.abs() + p_u * \
                    ops.flash_attention_plain(q.float(), k.float(),
                                              v.float().abs(), causal=causal)
                ratio = float(((got - want).abs() / limit).max())
                fault = float(((drop_last_key_tile(q, k, v, causal).float()
                                - want).abs() / limit).max())
                if not (ratio <= 1.0 < fault):
                    raise AssertionError(
                        f"flash attention D={d} {dtype_name} causal={causal}"
                        f": error {ratio} x its limit, dropped tile {fault} x")
                rows.append({"d": d, "dtype": dtype_name, "causal": causal,
                             "max_abs_err": float((got - want).abs().max()),
                             "max_err_over_limit": ratio,
                             "dropped_tile_err_over_limit": fault,
                             "kernel_ms": cuda_ms(lambda: ops.flash_attention(
                                 q, k, v, causal=causal), reps=5, warmup=1)})
    return {"shape": [b, t, h], "cases": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs a GPU", file=sys.stderr)
        return 1
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    wf = timed("waterfill", phase_waterfill, dev)
    beat = timed("beat", phase_beat, dev)
    loc = timed("locality", phase_locality, dev)
    run = timed("runtime", phase_runtime, dev)
    timed("dataplane", phase_dataplane, dev)
    fl = timed("flash_attention", phase_flash, dev)
    head = fl["cases"][0]
    lw = loc["problems"]["beat 1000x8x64"]
    emit({"phase": "summary", "phase_seconds": seconds,
          "seconds": time.perf_counter() - t_start})   # build included
    emit({"kernels": [
        {"name": "waterfill_scan", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/waterfill.cu",
         "replaces": "ray_tpu/ops/hybrid_kernel.py:160 (schedule_grouped "
                     "lax.scan; fused_beat scan :406, body "
                     "_schedule_group :95)",
         # launches without pref_rows: the runtime path's (init/remote/
         # get; the delta beat and snapshot rounds), the beat path's beside
         # it.  max_abs_err 0: the phases raise unless bit-exact
         "launches": run["launches"]["waterfill_scan"],
         "launches_by_path": {"runtime": run["launches"]["waterfill_scan"],
                              "beat": beat["waterfill_launches"]},
         "max_abs_err": 0,
         "ms": wf["kernel_ms"], "plain_ms": wf["plain_ms"],
         "cluster": wf["cluster"],
         "bound_ms": wf["bound_ms"], "bound_by": wf["bound_by"],
         "library_ms": None, "checked": True},
        {"name": "waterfill_scan (localized)", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/waterfill.cu",
         "replaces": "ray_tpu/ops/locality_kernel.py:41 "
                     "(schedule_grouped_localized lax.scan)",
         # launches with pref_rows on the runtime path
         "launches": run["launches"]["localized"], "max_abs_err": 0,
         "ms": lw["kernel_ms"], "plain_ms": lw["plain_ms"],
         "bound_ms": lw["bound_ms"], "bound_by": lw["bound_by"],
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

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout: builds every kernel of the slice from
``ray_tpu_torch/ops/csrc`` (one nvcc per source, all at once), holds each
kernel against its plain PyTorch version (and the scheduler against its
numpy host twin) at the shapes the main paths give it, drives the main
paths (the heartbeat, the runtime through ``init/remote/get``, serve
beside a task burst, flash attention, data, the simulator, the
training libraries and the sharded paths) through the entry points a
user calls, and times them.  Each
phase prints one JSON line; any failure raises and exits non-zero.

Phases:
  device          the card (nvidia-smi name and power limit), torch, CUDA
  lint            ``python -m ray_tpu_torch lint --format=json`` (the
                  port's rtlint; run beside the build): exit 0, findings
                  by rule, baselined and new
  build           seconds to build the kernels, ptxas registers/spills,
                  and the SASS instructions that show the Hopper paths
                  (HGMMA and UTMALDG in every instantiation of flash
                  attention's seven tensor-core kernels, cluster
                  barriers in the water-fill)
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
                  twin (counts and lease budgets); a delta beat is one
                  ``beat_rows``, one ``waterfill_scan`` and one
                  ``beat_tail`` launch (``csrc/beat.cu``), three kernels
                  in all (profiler); both beat kernels == their plain
                  versions on a beat's captured inputs, bit for bit, and
                  ``beat_rows``' class install and full rescore on a
                  fresh engine's own calls, with their ms, device ms,
                  plain ms, the wrapper's host ms and bounds; beat
                  p50/p80/p99,
                  tasks/s, launches, readbacks per beat, idle share; the
                  parent's route (the rest of the beat on the plain
                  versions) timed in the same call, then the kernels'
                  again; every host<->device sync of 10 steady beats (a
                  child process's engine) put on a line of the package
                  (torch's sync debug mode and the profiler's runtime
                  calls) and held to rtlint's W6 (each a pragma'd or
                  baselined site), syncs per steady beat; the beat with
                  the parent's staging fence (an event wait every
                  upload) timed against this one, 50 beats a block in
                  the order parent, this, this, parent
  shard           the sharded paths on ranks of the card (``["cuda:0"]
                  * S``): ``make_delta_scheduler(crm, n_shards=S,
                  reduce_mode=mode, devices=...)`` for (2, flat), (4,
                  two_level) and (8, flat) at the beat cell's width beside
                  the single-device engine, every beat's counts and
                  budgets == it and the host twin (2 warm-up, 8 timed
                  beats; p50, p80, p99, kernels and idle share a beat);
                  a delta beat is one ``beat_rows``, one ``shard_scan``
                  and one ``beat_tail`` launch, three kernels at every S,
                  and no ``_Transport`` call; ``shard_scan`` ==
                  ``shard_scan_plain`` on a beat's scan inputs and the two
                  beat kernels == their plain versions on a beat's inputs
                  (ms of each, bound, launch; ``beat_rows``' install and
                  rescore too, from a fresh engine's calls); the same
                  beats with the
                  rest of the beat on its plain versions (the parent's
                  route; 2 warm-up, 8 timed); the four ``*_sharded_np``
                  wrappers at S = 4 == the single-device calls (ms,
                  launches; the kernel == plain on the water-fill's group
                  masks); ring and Ulysses
                  attention at B=2 T=4096 H=16 D=128 float32 on 4 and 8
                  ranks, causal and not, within RING_ATOL of
                  ``full_attention``, a limit that must reject the ring
                  missing its last fold (ms beside ``ops.flash_attention``
                  f32 and SDPA); ``entry()`` == the host twin;
                  ``dryrun_multichip(4 and 8, device="cuda:0")``; over
                  distinct cards through NCCL when there are two or more
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
                  batch (the bundle kernel's launches), a batch of 161
                  pulls through the PullManager (the pull kernel's
                  launches), an actor, put/get/wait; then the head raylet at
                  1000 rows: 100,000 specs over 64 classes with locality
                  rows and avoid flags, rows == the host twin's
  serve           serve on the runtime: ``init`` on the GPU with 8
                  nodes and the metrics and dashboard ports set, a
                  deployment of 8 replicas (``@serve.batch``, batches up
                  to 16, 8 ongoing requests a replica), 2,000 requests
                  through handles from 32 threads and 400 through the
                  HTTP ingress, AT THE SAME TIME a 10,000-task burst over
                  4 classes placed through the delta beat, and a v1 -> v2
                  rollout in the middle of the traffic: every response
                  right and from v1 or v2, the rollout sealed on all 8
                  replicas, delta rounds and water-fill launches within
                  the phase, /metrics == serve.status()'s request plane,
                  the dashboard's JSON APIs; requests/s, p50/p99, batch
                  sizes, the burst's tasks/s beside the runtime phase's
  dataplane       the bundle and pull kernels (``csrc/bundle.cu``,
                  ``csrc/pull.cu``) == their plain versions on the card ==
                  their numpy oracles, exact, at 1000 x 64 groups x 8
                  bundles and 4096 pulls x 1000 nodes, and at 8192 nodes;
                  kernel, plain and oracle ms, CUDA kernels a call, bound,
                  ns a bundle step and the bundle layout, ns a pull;
                  kernel and oracle ms at the runtime thresholds' sizes (2
                  groups of 8, 128 pulls); the broadcast kernel
                  (``csrc/broadcast.cu``) == its plain version on the card
                  at 1000 members, fan-out 4 (and == its oracle), at 8192
                  nodes, and with uniform bandwidth at 1000 (its worst
                  case; == its oracle); kernel, plain and oracle ms,
                  launches, both bounds
  broadcast       ``cluster.broadcasts.broadcast`` on a port Cluster of 72
                  rows serving object-plane endpoints, seeded link rates:
                  an 8 MiB object in 1 MB chunks reaches all 71 members
                  bit-exact, no fallback, the plan on the card in one
                  kernel launch of a 2-CTA cluster; on the plan's
                  captured inputs the kernel == the plain version on the
                  card == the oracle == the tree the manager used
  autoscaler      ``autoscale`` (a first-fit water-fill launch, then the
                  ``binpack_launch_loop`` kernel) at 1000 nodes x 64
                  resources x 64 classes x 1,000,000 demands x 16 node
                  types and the 1M-demand single-class case, == the numpy
                  oracle bit for bit; the kernel == its plain version on
                  the card, there and at 16 x 1024 x 64 with the class
                  rows streamed; then the user's path, a
                  StandardAutoscaler round on a port Cluster (5,000
                  requested bundles), launching the oracle's node types;
                  ms, iterations, class steps (all, and in a chain) and
                  ns a step, layout,
                  bound, the phase-1 scan's ms
  topk            the top-k kernel (``csrc/topk.cu``) == its plain
                  version on the card, bit for bit, at the beat width
                  (1000 x 8 x 64 x 1M) and the contract's limit (8192 x
                  16 x 128); the card == the CPU bit for bit, an even
                  spread over each class's k best keys, consumption
                  capped; the rotation offsets on the card == the CPU ==
                  a pinned table of the JAX function's
                  (TOPK_JAX_OFFSETS); kernel, plain and CPU ms, launches,
                  bound; then a 2,000-task burst with
                  scheduler_top_k_fraction = 0.5 through the raylet's
                  top-k rounds, which launch the kernel
  daemon          ``python -m ray_tpu_torch start --head`` on the card,
                  two ``agent`` subprocesses, a driver subprocess with
                  ``init(address=...)`` whose 3,000 tasks land on both
                  agents, ``job submit --wait``, ``rollout``,
                  ``status``, ``stop``; the head's device rounds and
                  water-fill launches; its /metrics and dashboard
                  (started by RT_METRICS_EXPORT_PORT/RT_DASHBOARD_PORT)
                  scraped over HTTP against its status RPC; only the
                  head (and this script) hold a CUDA context
  flash_attention the ops path: ``ops.flash_attention`` at B=2, T=4096,
                  H=16, D=128 bf16 causal (the main path), then bf16
                  causal at the widths of the wgmma kernels past 128
                  (FLASH_WIDE_PATHS: B=2 T=4096 H=16 D=256, Gemma 7B's
                  head dim, and H=8 D=512), then f32 causal at D=128
                  (the split-TF32 kernel's path), then the two-pass
                  routes' paths (FLASH_TWOPASS_PATHS: bf16 and f32 at
                  B=2 T=4096 H=8 D=576, five chunks of scratch, f32 at
                  B=2 T=1024 H=4 D=1600, f32 at B=2 T=4096 H=8 D=2048,
                  and bf16 at B=2 T=1024 H=4 D=1088), each driven with the launch
                  count set to 0 and the entry point's route read, with
                  the kernel launches of each two-pass call (two a
                  chunk); then the cases: D=128 (bf16
                  causal, bf16, f16, f32 causal and not), bf16 causal at
                  D=64, f32 at T=1024, D=64, bf16 and f32 causal and
                  not at the three full-card widths, and f32 causal and
                  not at B=2 T=4096 H=8 D=2048, against the plain
                  version within an elementwise limit (FLASH_TOL) that
                  must also reject the plain version with its last 64
                  keys dropped (and, for f32 and past D=512, its last
                  key tile of the route's kernel);
                  kernel/plain/library times, the bound (f32: three
                  TF32 products, the FMA bound beside it), the share of
                  the bound reached and the ratio to the library call;
                  then every head dim of FLASH_HEAD_DIMS (zero-padded;
                  past 512 on the two-pass pairs of both dtypes), bf16
                  and f32, causal and not, each on the route the route
                  table gives, beside the plain
                  version's time, its bound and the library call's time
                  and SDPA backend
  data            ``ray_tpu_torch.data`` feeding the card: ``init`` with a
                  4096 MB object store (bytes spilled: 0), ``from_numpy``
                  of 2**20 rows x 128 float32 features (512 MiB, seed 0)
                  in 64 blocks, a ``map_batches`` scale and shift in the
                  workers, ``iter_torch_batches(batch_size=8192)`` with
                  no device: every batch on the GPU, the column sums and
                  row count on the card == numpy's (exact in float64);
                  rows/s, GB/s, the seconds of the driver's gets, row
                  pivot and copies, the device's idle share; then a .rtb
                  round trip (``write_blocks``, ``stream_block_files``)
                  of the 64 blocks, rows and column sums == the source's
  sim             ``python -m ray_tpu_torch simulate`` at 1000 nodes,
                  seed 7, 50 faults: ``serve_diurnal``, ``train_diurnal``
                  and ``mixed`` (``--verify-replay``), each trace hash ==
                  the reference's (SIM_PINNED); events, seconds, events/s
  train           the training libraries: every ``DeviceCollectiveGroup``
                  op (NCCL) on every visible card, a 256 MiB float32
                  slice a rank, == its plain version on CPU ranks (exact,
                  float sum and product past one card within
                  COLL_RTOL_PER_RANK x W); W, ms, GB/s; then on one head
                  node in this process: ``MeshTrainer`` at 128 -> 4096 x
                  3 -> 1 (34.1 M parameters, Adam 1e-3, float32 without
                  TF32), its first step on the card == the CPU's
                  (TRAIN_STEP_RTOL), one epoch of 2**20 seeded rows in
                  batches of 8192 through ``from_numpy`` and ``fit``,
                  whose last 16 losses average below the first; ms a
                  step, samples/s, the bound, host seconds by part, the
                  idle share over 16 steps, peak memory; a 2-worker gang
                  trainer == the serial fit (1e-6); the live elastic
                  stage of bench_train.py (a member SIGKILLed
                  mid-allreduce beside a control: a typed gang loss, no
                  failure burned, monotone epochs, the run's gauges in
                  the head's status and on /metrics; re-form seconds);
                  ASHA over 16 trials (best lr 0.4; trials/s); PG and PPO
                  on the bandit and corridor to the reference tests'
                  bars with the update on the card, the first update ==
                  the CPU's (1e-6); ms an iteration on each
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
# TF32 in the tensor cores, dense (NVIDIA data sheet): flash attention's
# f32 route runs three TF32 products for each f32 one (split TF32)
PEAK_TC_TF32 = 495e12
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
    # p stays f32; both products in split TF32 (hi*hi + hi*lo + lo*hi,
    # each operand within 2**-21 of itself), blockwise sums: a few hundred
    # f32 ulps
    "float32": (1e-6, 1e-5, 1e-5),
    # output: two f16 ulps (each <= 2**-10 |o|); p to f16: roundoff 2**-11
    "float16": (1e-5, 2.0**-9, 2.0**-11),
    # output: two bf16 ulps (each <= 2**-7 |o|); p to bf16: roundoff 2**-8
    "bfloat16": (1e-5, 2.0**-6, 2.0**-8),
}
# the limit must reject a kernel that skips the last 64 keys (half of the
# 16-bit kernel's 128-key tile, the f32 kernel's whole tile at D = 64)
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


# -- phase: lint -------------------------------------------------------------

def start_lint():
    """``python -m ray_tpu_torch lint --format=json`` from the checkout,
    in a subprocess: host work, run beside the kernels' build."""
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "lint", "--format=json"],
        cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def phase_lint(proc):
    """The port's rtlint over the checkout: exit 0 (every finding
    baselined), its findings by rule, baselined and new."""
    out, err = proc.communicate(timeout=600)
    report = json.loads(out) if out.strip() else {}
    by_rule: dict[str, dict] = {}
    for key in ("baselined", "new"):
        for f in report.get(key, ()):
            by_rule.setdefault(f["rule"], {"baselined": 0, "new": 0})
            by_rule[f["rule"]][key] += 1
    result = {"phase": "lint",
              "command": "python -m ray_tpu_torch lint --format=json",
              "rc": proc.returncode, "counts": report.get("counts"),
              "by_rule": dict(sorted(by_rule.items()))}
    emit(result)
    if proc.returncode != 0:
        new = [f"{f['path']}:{f['line']}: {f['rule']} {f['message']}"
               for f in report.get("new", ())]
        raise AssertionError(f"lint exited {proc.returncode}: "
                             f"{new or err[-2000:]}")
    return result


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
        ptxas[name] = lines[:120]
    emit({"phase": "build", "seconds": round(total, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in per_kernel.items()},
          "ptxas": ptxas, "sass": sass_evidence(_build)})


# SASS opcodes that show each kernel's Hopper path was compiled in: wgmma
# (HGMMA) and TMA loads (UTMALDG) in flash attention, cluster barriers
# (UCGABAR) in the water-fill and the sharded scan
# ({kernel: opcodes}, each required in every instantiation of a kernel
# whose mangled name holds it; "" the whole library)
SASS_REQUIRED = {
    "flash_attention": {k: ("HGMMA", "UTMALDG") for k in (
        "flash_wgmma_kernel", "flash_big16_kernel", "flash_tf32_kernel",
        "flash_scores32_kernel", "flash_values32_kernel",
        "flash_scores16_kernel", "flash_values16_kernel")},
    "waterfill": {"": ("UCGABAR",)},
    "shard_scan": {"": ("UCGABAR",)}}


def sass_evidence(_build):
    """Counts of those opcodes in each built library (cuobjdump -sass),
    by kernel instantiation; raises if one is missing."""
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    found = {}
    for name, kernels in SASS_REQUIRED.items():
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        # "Function : <mangled name>" opens each kernel's code
        funcs = {part.split(None, 1)[0]: part
                 for part in sass.split("Function : ")[1:]}
        for kernel, opcodes in kernels.items():
            texts = {"library": sass} if not kernel else {
                f[f.index(kernel):][:40]: text
                for f, text in funcs.items() if kernel in f}
            if not texts:
                raise AssertionError(f"{name}: no {kernel} in its SASS")
            for fn, text in texts.items():
                found.setdefault(name, {})[fn] = counts = {
                    op: text.count(op) for op in opcodes}
                missing = [op for op, k in counts.items() if k == 0]
                if missing:
                    raise AssertionError(f"{name} {fn}: no {missing} in "
                                         "its SASS")
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


def scan_work(reqs, n_nodes, masks=True, prefs=False):
    """(bytes, int32 operations) of one water-fill over these inputs:
    totals, avail, node mask, requests, counts (and the (G, N) class
    masks, the (G,) preferred rows) read once, counts and avail written
    once."""
    g, r = reqs.shape
    n = n_nodes
    n_bytes = (2 * n * r * 4 + n + g * r * 4 + g * 4
               + (g * n if masks else 0) + (g * 4 if prefs else 0)
               + g * (n + 1) * 4 + n * r * 4)
    return n_bytes, waterfill_ops(reqs, n)


def beat_rest_work(n_cls, r_w, n_nodes, dirty):
    """(bytes, int32 operations) of a delta beat less its water-fill
    (apply_dirty_rows on the dirty rows, the budgets, the per-class
    argmin): every input read once, every output written once; ~12 ops
    per (class, dirty row, resource) for a key, ~4 per (class, node,
    resource) for a budget, 1 per (class, node) for the argmin."""
    n_bytes = (2 * n_nodes * r_w * 4 + n_nodes + n_cls * r_w * 4
               + 2 * dirty * r_w * 4 + n_cls * n_nodes * 4
               + n_cls * dirty * 4 + n_cls * n_nodes * 4 + n_cls * 4)
    n_ops = (n_cls * dirty * r_w * 12 + n_cls * n_nodes * r_w * 4
             + n_cls * n_nodes)
    return n_bytes, n_ops


def _positive_cols(reqs) -> int:
    """The positive request columns of the rows ``reqs`` (a key reads and
    divides only those)."""
    return int((reqs > 0).sum())


def beat_rows_work(st, kw):
    """(bytes, int32 operations) of one ``beat_rows`` beat call on these
    inputs: the real dirty rows (read, written into the mirror, their key
    columns against every class: ~12 ops per (class, row, positive
    request column)), the real override rows, avail and the masks read
    once, avail_eff and mask_eff written once, the class gather (slots
    and counts read, group_reqs and group_counts written), the exchange
    areas zeroed."""
    s = st.n_shards
    n_l, r = st.totals[0].shape
    c = st.reqs[0].shape[0]
    n = s * n_l
    rows, ov = kw.get("rows"), kw.get("overrides")
    b = 0 if rows is None else sum(int((i < n_l).sum()) for i in rows[0])
    bo = 0 if ov is None else sum(int((i < n_l).sum()) for i in ov[0])
    g = kw["groups"][0][0].shape[0]
    xchg = 0 if st.xchg is None else s * st.xchg[0].numel()
    n_bytes = (b * (4 + 2 * r * 4 + 1) * 2 + c * r * 4 + c * b * 4
               + bo * (4 + r * 4) + 2 * n * r * 4 + 3 * n
               + s * g * (4 + 4 + r * 4 + 4) + xchg * 4)
    return n_bytes, b * _positive_cols(st.reqs[0]) * 12 + n


def beat_keys_work(st, kw):
    """(bytes, int32 operations) of one ``beat_rows`` class install or full
    rescore on these inputs: every rank's totals, avail and mask read
    once, the scored request rows read (and, for an install, written
    into each rank's reqs), their key rows written; ~12 ops per (class,
    node, positive request column)."""
    s = st.n_shards
    n_l, r = st.totals[0].shape
    n = s * n_l
    if kw.get("classes") is not None:
        idx, reqs = (x[0].cpu().numpy() for x in kw["classes"])
        real = (idx >= 0) & (idx < st.reqs[0].shape[0])
        reqs = reqs[real]
        extra = s * (len(idx) * 4 + len(reqs) * r * 4)   # slots, reqs rows
    else:
        reqs = st.reqs[0].cpu().numpy()
        extra = 0
    n_bytes = (2 * n * r * 4 + n + s * len(reqs) * r * 4 + extra
               + len(reqs) * n * 4)
    return n_bytes, n * _positive_cols(reqs) * 12


def host_ms(fn, n=200) -> float:
    """The host's ms a call of ``fn`` (a wrapper's enqueue: its checks or
    lookup, its arguments and the launch), the device left to finish
    after the clock stops."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def beat_tail_work(st, g):
    """(bytes, int32 operations) of one ``beat_tail`` call: the scan's
    counts, inf and final avail, totals, mask_eff, the requests and the
    carried keys read once, the packed (G + C, N + 1) readback and the
    argmin written once; ~4 ops per (class, node, resource) for a budget
    and 1 per (class, node) for the argmin."""
    s = st.n_shards
    n_l, r = st.totals[0].shape
    c = st.reqs[0].shape[0]
    n = s * n_l
    n_bytes = (g * n * 4 + g * 4 + 2 * n * r * 4 + n + c * r * 4
               + c * n * 4 + (g + c) * (n + 1) * 4 + c * 4)
    return n_bytes, c * n * r * 4 + c * n


def _max_abs_err(xs, ys):
    return max((int((x.long() - y.long()).abs().max()) if x.numel() else 0)
               for x, y in zip(xs, ys))


FRESH_CLASSES = 4                # an install's new classes (fits C = 32)


def fresh_classes(crm, n=FRESH_CLASSES):
    """``n`` request vectors no class of ``build_cluster`` has (CPU 4 and
    up), interned in ``crm``."""
    from ray_tpu_torch.common.resources import ResourceRequest
    return np.stack([crm.intern_request(ResourceRequest({"CPU": 4 + i}))
                     for i in range(n)])


def keys_calls(make_engine, vecs, counts, fresh):
    """``beat_rows``' class install and full rescore as an engine makes
    them: a fresh engine's first beat (a full sync, so a full rescore)
    and its next beat, which brings the classes ``fresh`` (an install).
    Returns {"rescore": (state, thr, kwargs), "classes": ...}, copies
    taken at each call (the first beat's last rescore: the first one
    scores an empty class plane, the class axis then grows)."""
    from ray_tpu_torch.ops import hybrid_kernel as hk

    real = hk.beat_rows
    seen = {}

    def rows(st, thr, **kw):
        mode = "rescore" if kw.get("rescore") else \
            "classes" if kw.get("classes") is not None else None
        if mode == "rescore" or mode is not None and mode not in seen:
            seen[mode] = (st.clone(), thr, kw)  # the last rescore: the
        return real(st, thr, **kw)              # one with every class

    rows.launches = 0                       # the sharded engine reads it
    hk.beat_rows = rows
    try:
        eng = make_engine()
        eng.beat(vecs, counts)
        eng.beat(np.concatenate([vecs, fresh]),
                 np.concatenate([counts, np.full(len(fresh), 7, np.int32)]))
    finally:
        hk.beat_rows = real
    if set(seen) != {"rescore", "classes"}:
        raise AssertionError(f"the engine made the calls {sorted(seen)}, "
                             "not a full rescore and a class install")
    return seen


def beat_kernels_vs_plain(step, make_engine=None, vecs=None, counts=None,
                          fresh=None):
    """``beat_rows`` and ``beat_tail`` held to their plain versions on one
    beat's inputs, captured from ``step()`` (the engine's own calls on the
    card): every resident and buffer beat_rows writes, and the packed
    readback and argmin, bit for bit; then each kernel's ms (CUDA events,
    p50 of 20 calls) beside its plain version's on the same inputs, its
    device ms (the profiler), the wrapper's host ms a call, and its bound
    for this beat's work.  With ``make_engine``, ``beat_rows``' class
    install and full rescore too, captured from a fresh engine's calls
    (``keys_calls``), each held and timed the same way (under
    ``beat_rows_calls``).  Each beat_rows call is idempotent on its
    inputs (the dirty rows land where they landed, the keys are scored
    again), so every timed call starts from the same state.  The
    comparison's launches are taken off the counters again."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import shard_reduce as sr

    real_rows, real_tail = hk.beat_rows, hk.beat_tail
    seen = {}

    def rows(st, thr, **kw):
        if kw.get("groups") is not None:
            seen["rows"] = (st.clone(), thr, kw)
        return real_rows(st, thr, **kw)

    def tail(st, alloc, inf, av_fin):
        # copies equally spaced, as the kernel takes them
        seen["tail"] = (st.clone(), hk.spaced([a.clone() for a in alloc]),
                        inf.clone(), hk.spaced([a.clone() for a in av_fin]))
        return real_tail(st, alloc, inf, av_fin)

    rows.launches = tail.launches = 0       # the sharded engine reads them
    hk.beat_rows, hk.beat_tail = rows, tail
    try:
        step()
    finally:
        hk.beat_rows, hk.beat_tail = real_rows, real_tail
    counters = (real_rows.launches, dict(real_rows.launches_by_mode),
                real_tail.launches, hk.waterfill_scan.launches,
                sr.shard_scan.launches)
    calls = {"beat": seen["rows"]}
    if make_engine is not None:
        calls.update(keys_calls(make_engine, vecs, counts, fresh))
    fields = ("totals", "avail", "mask", "keys", "reqs", "avail_eff",
              "mask_eff", "group_reqs", "group_counts")
    by_call = {}
    for name, (snap, thr, kw) in calls.items():
        a, p = snap.clone(), snap.clone()
        real_rows(a, thr, **kw)
        layout = real_rows.last_layout
        hk.beat_rows_plain(p, thr, **kw)
        err = max(_max_abs_err(getattr(a, f), getattr(p, f))
                  for f in fields if getattr(a, f) is not None)
        if err:
            raise AssertionError(f"beat_rows' {name} call (max abs err "
                                 f"{err}) disagrees with its plain version "
                                 f"on {snap.n_shards} rank(s)")
        work = beat_rows_work(snap, kw) if name == "beat" else \
            beat_keys_work(snap, kw)
        bound_ms, bound_by = bound(*work, PEAK_I32)
        by_call[name] = {
            "max_abs_err": 0, "ms": cuda_ms(lambda: real_rows(a, thr, **kw)),
            "device_ms": kernel_device_ms(
                lambda: real_rows(a, thr, **kw),
                "beat_rows_kernel" if name == "beat"
                else "beat_rows_keys_kernel"),
            "plain_ms": cuda_ms(lambda: hk.beat_rows_plain(p, thr, **kw)),
            "host_ms": host_ms(lambda: real_rows(a, thr, **kw)),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": work[0],
            "int32_ops": work[1], "layout": layout}
    snap = calls["beat"][0]
    st, alloc, inf, av_fin = seen["tail"]
    got = real_tail(st, alloc, inf, av_fin)
    want = hk.beat_tail_plain(st, alloc, inf, av_fin)
    tail_err = _max_abs_err(got, want)
    if tail_err:
        raise AssertionError(f"beat_tail (max abs err {tail_err}) disagrees "
                             f"with its plain version on {snap.n_shards} "
                             f"rank(s)")
    g = alloc[0].shape[0]
    work = beat_tail_work(st, g)
    bound_ms, bound_by = bound(*work, PEAK_I32)
    tail_row = {
        "max_abs_err": 0, "ms": cuda_ms(lambda: real_tail(st, alloc, inf,
                                                          av_fin)),
        "device_ms": kernel_device_ms(
            lambda: real_tail(st, alloc, inf, av_fin), "beat_tail_kernel"),
        "plain_ms": cuda_ms(lambda: hk.beat_tail_plain(st, alloc, inf,
                                                       av_fin)),
        "host_ms": host_ms(lambda: real_tail(st, alloc, inf, av_fin)),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": work[0],
        "int32_ops": work[1], "layout": real_tail.last_layout}
    real_rows.launches, real_rows.launches_by_mode, real_tail.launches, \
        hk.waterfill_scan.launches, sr.shard_scan.launches = counters
    out = {"beat_rows": {"ranks": snap.n_shards, **by_call["beat"],
                         "beat_rows_calls": by_call},
           "beat_tail": {"ranks": snap.n_shards, **tail_row}}
    return out


def topk_work(n, reqs):
    """(bytes, int32 operations) of a top-k round over these requests:
    per class the keys over the request's positive columns (~12 ops per
    (node, positive column); a zero column leaves a key as it is), the
    three order statistics the spread needs by a radix select of N keys
    (4 passes of 8 bits: a digit a key and pass), the spread and cap (~8
    per node)."""
    g, r = reqs.shape
    n_ops = (float((np.asarray(reqs) > 0).sum()) * n * 12
             + g * (n * 4 + n * 8))
    n_bytes = 2 * n * r * 4 + n + g * r * 4 + g * 4 + g * 4 \
        + g * (n + 1) * 4 + n * r * 4
    return n_bytes, n_ops


def loop_work(k, g, r, iters):
    """(bytes, int32 operations) of the launch loop for ``iters``
    iterations: per iteration, per (type, class) a pass over the R
    resources (sub, floordiv, min for the fit; mul, add for used: 5 ops)
    and per type the score (mul, div, max); the inputs read once, the
    outputs written once."""
    n_ops = iters * (k * g * r * 5 + k * r * 3 + k * g * 2)
    n_bytes = 4 * (2 * k * r + g * r + g + 2 * k + g) + 4
    return n_bytes, n_ops


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
    d2h = kernels = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name[:80]
        by_name[name] = by_name.get(name, 0.0) + \
            evt.time_range.elapsed_us() / 1e3
        if "DtoH" in evt.name:
            d2h += 1
        elif "Memcpy" not in evt.name and "Memset" not in evt.name:
            kernels += 1
    if not by_name:
        return {"wall_ms": wall_ms / n, "device_busy_ms": None,
                "idle_share": None, "d2h_copies": None,
                "kernels_per_call": None, "by_name_ms": None}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms / n, "device_busy_ms": busy / n,
            "idle_share": 1.0 - busy / wall_ms, "d2h_copies": d2h / n,
            "kernels_per_call": kernels / n,
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


def _plain_beat_kernels():
    """Stand-ins for ``beat_rows``/``beat_tail`` that run their plain
    versions on the card's tensors: the parent's route (the rest of the
    beat as eager PyTorch), swapped in by this script only."""
    from ray_tpu_torch.ops import hybrid_kernel as hk

    def rows(st, thr, **kw):
        return hk.beat_rows_plain(st, thr, **kw)

    def tail(st, alloc, inf, av_fin):
        return hk.beat_tail_plain(st, alloc, inf, av_fin)

    rows.launches = tail.launches = 0       # the sharded engine reads them
    return rows, tail


def timed_beats(beat, mutate, agrees, n_warm, n_timed, label):
    """``n_warm + n_timed`` calls of ``beat()`` after ``mutate()``, each
    held to ``agrees(got)``; the timed beats' p50/p80/p99 (host clock
    around a beat, which ends in its readback)."""
    times = []
    for i in range(n_warm + n_timed):
        mutate()
        t0 = time.perf_counter()
        got = beat()
        dt = (time.perf_counter() - t0) * 1e3
        if i >= n_warm:
            times.append(dt)
        if not agrees(got):
            raise AssertionError(f"a beat of {label} disagrees with the "
                                 "host twin")
    return {"beat_p50_ms": float(np.percentile(times, 50)),
            "beat_p80_ms": float(np.percentile(times, 80)),
            "beat_p99_ms": float(np.percentile(times, 99)),
            "timed_beats": n_timed, "bit_exact_beats": n_warm + n_timed}


def parent_fence(slot):
    """The parent's staging fence: a host wait on each of a slot's
    events at every upload, done or not (``DeltaScheduler._wait_slot``
    asks first)."""
    for ev in slot.events:
        ev.synchronize()


def churner(rng, crm, churn):
    """bench.py's delta churn between beats: ``churn`` rows a call, each
    a force_subtract of one CPU or the add_back of an earlier one."""
    from ray_tpu_torch.common.resources import ResourceRequest
    churn_req = ResourceRequest({"CPU": 1})
    debts: list[int] = []

    def mutate():
        for _ in range(churn):
            if debts and rng.random() < 0.5:
                crm.add_back(debts.pop(), churn_req)
            else:
                row = int(rng.integers(0, N_NODES))
                crm.force_subtract(row, churn_req)
                debts.append(row)

    return mutate


FENCE_BEATS = (2, 50)                # warm-up, timed


def fence_p50(mutate, beat, beats):
    """p50 ms of ``beats[1]`` beats after ``beats[0]`` warm-up ones, each
    after ``mutate()`` (host clock around a beat, which ends in its
    readback)."""
    times = []
    for i in range(sum(beats)):
        mutate()
        t0 = time.perf_counter()
        beat()
        if i >= beats[0]:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50))


SYNC_BEATS = 10


def steady_syncs_child(churn=12):
    """Every host<->device sync of ``SYNC_BEATS`` steady delta beats of
    the beat cell's engine (after 3 that place the mirror and its
    classes), put on a line of the package and held to W6
    (``card_syncs``); prints the report as JSON, and raises where a sync
    is not sanctioned or W6 does not see it.  ``phase_beat`` runs it in
    a process of its own, so the profiler session it needs (Python
    stacks, sync debug mode) leaves the run's other sessions as they
    were."""
    from ray_tpu_torch.scheduling import make_delta_scheduler
    from ray_tpu_torch.tools.rtlint import card_syncs

    rng, crm, vecs, counts = build_cluster()
    mutate = churner(rng, crm, churn)
    eng = make_delta_scheduler(crm)

    def step():
        mutate()
        eng.beat(vecs, counts)

    for _ in range(3):
        step()
    before = (eng.stats["delta_beats"], eng.stats["classes_installed"],
              eng.readbacks)
    report = card_syncs.hold(card_syncs.observe(step, SYNC_BEATS))
    after = (eng.stats["delta_beats"], eng.stats["classes_installed"],
             eng.readbacks)
    if (after[0] - before[0], after[1] - before[1]) != (SYNC_BEATS, 0):
        raise AssertionError(f"the observed beats were not {SYNC_BEATS} "
                             f"steady delta beats: {before} -> {after}")
    report["readbacks_per_call"] = (after[2] - before[2]) / SYNC_BEATS
    if not report["ok"]:
        raise AssertionError("steady beats' syncs not held to W6: "
                             + json.dumps(report))
    emit(report)


def steady_syncs_subprocess():
    """``steady_syncs_child`` in a fresh process from the checkout; its
    report, or an error with the child's last output."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.steady_syncs_child()"],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"steady beats' syncs (exit {r.returncode}): "
                             f"{r.stdout[-3000:]} {r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def phase_beat(dev, warmup=2, beats=50, churn=12, parent_beats=(2, 20)):
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling import make_delta_scheduler
    from ray_tpu_torch.scheduling.contract import (compute_budgets,
                                                   threshold_fp)

    rng, crm, vecs, counts = build_cluster()
    thr = threshold_fp(None)
    mutate = churner(rng, crm, churn)

    def agrees(got):
        st = crm.snapshot()
        want, post = host_twin(st.totals, st.avail, st.node_mask, vecs,
                               counts, None, thr)
        budgets = np.stack([eng.budget_row_host(v) for v in vecs])
        want_b = compute_budgets(st.totals, post, vecs, st.node_mask)
        return np.array_equal(got, want) and np.array_equal(budgets, want_b)

    # --- the main path: counts start at 0 here and are read after ---
    hk.waterfill_scan.launches = 0
    hk.beat_rows.launches = hk.beat_tail.launches = 0
    hk.beat_rows.launches_by_mode = dict.fromkeys(
        hk.beat_rows.launches_by_mode, 0)
    eng = make_delta_scheduler(crm)
    if eng.device.type != "cuda":
        raise AssertionError(f"the heartbeat resolved to {eng.device}")
    times, mismatches, per_delta_beat = [], 0, set()
    for i in range(warmup + beats):
        mutate()
        before = (eng.stats["delta_beats"], eng.stats["classes_installed"],
                  hk.beat_rows.launches, hk.beat_tail.launches)
        t0 = time.perf_counter()
        got = eng.beat(vecs, counts)
        dt = (time.perf_counter() - t0) * 1e3
        if i >= warmup:
            times.append(dt)
        if eng.stats["delta_beats"] > before[0] and \
                eng.stats["classes_installed"] == before[1]:
            per_delta_beat.add((hk.beat_rows.launches - before[2],
                                hk.beat_tail.launches - before[3]))
        if not agrees(got):
            mismatches += 1
    launches = hk.waterfill_scan.launches
    beat_launches = {"beat_rows": hk.beat_rows.launches,
                     "beat_rows_by_call": dict(hk.beat_rows.launches_by_mode),
                     "beat_tail": hk.beat_tail.launches}
    layout = hk.waterfill_scan.last_layout
    readbacks = eng.readbacks
    # --- end of the main path ---
    n_beats = warmup + beats
    if mismatches:
        raise AssertionError(f"{mismatches}/{n_beats} beats disagree with "
                             "the host twin")
    if launches != n_beats or beat_launches["beat_tail"] != n_beats:
        raise AssertionError(f"waterfill_scan launched {launches} times and "
                             f"beat_tail {beat_launches['beat_tail']} in "
                             f"{n_beats} beats")
    if per_delta_beat != {(1, 1)}:
        raise AssertionError(f"(beat_rows, beat_tail) launches per delta "
                             f"beat: {sorted(per_delta_beat)}, not (1, 1)")
    if readbacks != n_beats:
        raise AssertionError(f"{readbacks} readbacks in {n_beats} beats")

    def step():
        mutate()
        eng.beat(vecs, counts)

    # every sync of the beat cell's steady beats held to W6, early in the
    # run (PERF.md section 7), in a process of its own
    syncs = steady_syncs_subprocess()
    trace = device_profile(step, 10)
    kpc = trace["kernels_per_call"]
    if kpc is None or kpc > 3:
        raise AssertionError(f"a steady delta beat ran {kpc} kernels "
                             "(beat_rows, the water-fill, beat_tail: 3)")
    kernels = beat_kernels_vs_plain(step, lambda: make_delta_scheduler(crm),
                                    vecs, counts, fresh_classes(crm))
    # per-layer breakdown: profile mode syncs after every phase, so these
    # beats are slower than the timed ones and are not counted above
    eng.profile = True
    for k in eng.phase_ms:
        eng.phase_ms[k] = 0.0
    n_prof = 10
    for _ in range(n_prof):
        step()
    eng.profile = False

    # the parent's route in this call: the rest of the beat as the plain
    # versions (eager PyTorch on the card) around the water-fill kernel;
    # then the kernels' route again, the two timed back to back
    def beat():
        return eng.beat(vecs, counts)

    real = hk.beat_rows, hk.beat_tail
    hk.beat_rows, hk.beat_tail = _plain_beat_kernels()
    try:
        parent = timed_beats(beat, mutate, agrees, *parent_beats,
                             "the parent's route")
        ptrace = device_profile(step, 10)
    finally:
        hk.beat_rows, hk.beat_tail = real
    again = timed_beats(beat, mutate, agrees, *parent_beats,
                        "the kernels' route")
    atrace = device_profile(step, 10)
    # the staging fence: the parent's wait on every upload against this
    # tree's query-first wait, in the order parent, this, this, parent
    # (timing only: a wait cannot change a beat's counts, which every
    # beat above held to the host twin)
    fence = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        if who == "parent":
            eng._wait_slot = parent_fence
        try:
            fence[who].append(fence_p50(mutate, beat, FENCE_BEATS))
        finally:
            eng.__dict__.pop("_wait_slot", None)
    for r, t in ((parent, ptrace), (again, atrace)):
        r.update({"kernels_per_beat": t["kernels_per_call"],
                  "idle_share": t["idle_share"],
                  "device_busy_ms_per_beat": t["device_busy_ms"],
                  "wall_ms_per_beat_profiled": t["wall_ms"]})
    p50 = float(np.percentile(times, 50))
    # the rest of a delta beat: its launches are the beat's kernels less
    # the water-fill, its bound the bytes and int32 operations it needs
    rest_bound_ms, rest_bound_by = bound(
        *beat_rest_work(*vecs.shape, N_NODES, churn), PEAK_I32)
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
              "beat_kernel_launches": beat_launches,
              "launches_per_delta_beat": {"beat_rows": 1, "beat_tail": 1},
              "readbacks_per_beat": readbacks / n_beats,
              # W6 held against the card: every sync of steady beats on
              # a sanctioned line (torch's sync debug mode, the profiler)
              "syncs_per_steady_beat": syncs["syncs_per_call"],
              "readbacks_per_steady_beat": syncs["readbacks_per_call"],
              "steady_syncs": {k: syncs[k] for k in (
                  "by_call", "by_site", "warned", "runtime_calls_seen")},
              "fence_p50_ms": fence,
              "phases_ms_per_beat_profiled": {
                  k: v / n_prof for k, v in eng.phase_ms.items()},
              "device_profile": trace, "stats": eng.stats,
              "kernels": kernels,
              "rest_of_beat": {
                  "launches_per_beat": kpc - 1,
                  "bound_ms": rest_bound_ms, "bound_by": rest_bound_by},
              "parent_route": parent, "kernel_route_again": again}
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


PULL_BATCH = 160                 # past pull_device_batch_min (128)
PULL_OBJECT_F64 = 25_000         # 200 KB a put: sealed in the arena


def pull_batch(cluster, n_pulls=PULL_BATCH):
    """One activation batch of ``n_pulls`` pulls through
    ``PullManager.request_pull``: a first pull claiming the whole
    in-flight quota is queued with the others behind it while the
    manager's lock is held, so when it lands the rest activate together
    and ``_choose_sources`` picks their sources in one device call.
    Returns (pulls done, the manager's device batches, every pull ok)."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch.api import _get_runtime
    from ray_tpu_torch.runtime.pull_manager import PullPriority
    pm = cluster.pull_manager
    src_row = _get_runtime().raylet.row          # where rt.put seals
    dests = [r for r in sorted(cluster.raylets) if r != src_row]
    refs = [rt.put(np.full(PULL_OBJECT_F64, i, np.float64))
            for i in range(n_pulls + 1)]
    done = threading.Semaphore(0)
    oks = []

    def landed(ok):
        oks.append(ok)
        done.release()

    batches0 = pm.device_batches
    with pm._cv:                          # activation waits for the queue
        pm.request_pull(refs[0].id, pm._quota, dests[0], PullPriority.GET,
                        callback=landed)
        for i, ref in enumerate(refs[1:]):
            pm.request_pull(ref.id, PULL_OBJECT_F64 * 8,
                            dests[i % len(dests)], PullPriority.TASK_ARG,
                            callback=landed)
    for _ in refs:
        if not done.acquire(timeout=120):
            raise AssertionError("pull batch: a pull did not land")
    return len(refs), pm.device_batches - batches0, all(oks)


def phase_runtime(dev):
    """The runtime on the card through the entry points a user calls:
    ``init`` on the GPU, 7 more nodes, a 10,000-task burst over 4
    resource classes (the delta beat), a locality burst (the localized
    kernel; every consumer in a worker of its argument's node), two
    placement groups in one device batch, an actor, put/get/wait, and
    the head raylet at 1000 rows (rows == host twin); then shutdown."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.api import _get_runtime
    from ray_tpu_torch.ops import bundle_kernel as bdk
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import pull_kernel as pk
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
        hk.beat_rows.launches = hk.beat_tail.launches = 0
        bdk.schedule_bundle_groups.launches = 0
        pk.choose_sources.launches = 0
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
                          "localized": hk.waterfill_scan.localized_launches,
                          "beat_rows": hk.beat_rows.launches,
                          "beat_tail": hk.beat_tail.launches}
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

        # two placement groups pending together, placed in one pass (the
        # bundle kernel's count set to 0 just before, read just after)
        bdk.schedule_bundle_groups.launches = 0
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
        pg_launches = bdk.schedule_bundle_groups.launches
        if len(set(s_rows)) != 3 or len(set(p_rows)) != 1 or \
                pg_batches < 1 or pg_launches < 1:
            raise AssertionError(f"placement groups: spread {s_rows}, pack "
                                 f"{p_rows}, {pg_batches} device batches, "
                                 f"{pg_launches} bundle kernel launches")
        remove_placement_group(spread)
        remove_placement_group(pack)

        # a pull activation batch past pull_device_batch_min (the pull
        # kernel's count set to 0 just before, read just after)
        pk.choose_sources.launches = 0
        n_pulls, pull_batches, pulls_ok = pull_batch(cluster)
        pull_launches = pk.choose_sources.launches
        if not pulls_ok or pull_batches < 1 or pull_launches < 1:
            raise AssertionError(f"pull batch: ok {pulls_ok}, "
                                 f"{pull_batches} device batches, "
                                 f"{pull_launches} pull kernel launches")

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
                    "localized": hk.waterfill_scan.localized_launches,
                    "beat_rows": hk.beat_rows.launches,
                    "beat_tail": hk.beat_tail.launches,
                    "schedule_bundle_groups":
                        bdk.schedule_bundle_groups.launches,
                    "choose_sources": pk.choose_sources.launches}
        # --- end of the main path ---
        # the burst's uniform rounds went through the delta beat: its
        # three kernels
        if min(burst_launches[k] for k in (
                "waterfill_scan", "beat_rows", "beat_tail")) < 1 or \
                delta_rounds < 1:
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
              "placement_group_kernel_launches": pg_launches,
              "pulls": n_pulls, "pull_device_batches": pull_batches,
              "pull_kernel_launches": pull_launches,
              "launches": launches, "raylet_full_width": full,
              "seconds": time.perf_counter() - t_start}
    emit(result)
    return result


# -- phase: serve (deployments, HTTP ingress, a rollout, beside a burst) -----

SERVE_NODES = 8
SERVE_REPLICAS = 8
SERVE_BATCH = 16
SERVE_ONGOING = 8
SERVE_HANDLE_REQUESTS = 2000
SERVE_CLIENTS = 32
SERVE_HTTP_REQUESTS = 400
SERVE_HTTP_CLIENTS = 8
SERVE_BURST_TASKS = RUNTIME_TASKS
# The rollout's SLO guard compares the router's request-latency EWMA after
# each flip with one reading taken as flipping starts, and rolls back past
# a factor of it.  Beside the burst, on the host's shared cores, the
# replicas' latencies are heavy-tailed (the client p99 is 3-6x its p50)
# and their mean drifts with the burst: at the default alpha of 0.2 (an
# EWMA of about 5 requests) an unchanged model read 7.1 ms and then
# 14.9 ms on the H100 host and tripped the default factor of 2, and at
# alpha 0.02 (about 50 requests) its largest reading was 2.28x its first
# within one 4.7 s rollout.  The guard stays armed above that drift.
SERVE_EWMA_ALPHA = 0.02
SERVE_SLO_FACTOR = 5.0
# the serve gauges /metrics must report as serve.status()["request_plane"]
SERVE_GAUGES = {"replicas": "serve_replicas",
                "queued": "serve_queued_requests",
                "inflight": "serve_inflight_requests",
                "shed": "serve_shed_requests_total",
                "expired": "serve_expired_requests_total",
                "completed": "serve_completed_requests_total",
                "batches": "serve_batches_total",
                "batch_size_mean": "serve_batch_size_mean",
                "shards": "serve_router_shards"}
DASHBOARD_APIS = ("summary", "nodes", "actors", "tasks", "objects",
                  "placement_groups", "serve", "versions", "leases",
                  "broadcasts", "health", "timeline", "jobs")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_get(url, timeout=60):
    """(status, headers, body) of a GET, HTTP errors included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _scrape(port):
    """{metric{labels}: value} from an exporter's /metrics."""
    status, _, body = _http_get(f"http://127.0.0.1:{port}/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    out = {}
    for line in body.decode().splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _quantile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


def phase_serve(dev, runtime_tasks_per_s=None):
    """Serve on the card's runtime: ``init`` on the GPU with 8 nodes and
    the exporter and dashboard ports set, a deployment of 8 replicas
    (``@serve.batch(max_batch_size=16)``, ``max_ongoing_requests=8``),
    2,000 requests through handles from 32 client threads and 400
    through the HTTP ingress, and AT THE SAME TIME a 10,000-task burst
    over 4 classes that the raylet places through the delta beat; a
    v1 -> v2 rollout of the deployment in the middle of the traffic, its
    SLO guard armed as ``SERVE_SLO_FACTOR`` says.  Gates: every response right and from v1 or v2; no request fails
    (none is shed either: the callers never outnumber the replicas'
    slots); the rollout seals with all 8 replicas flipped; delta rounds
    and water-fill launches within the phase; /metrics reads
    serve.status()'s request plane; the dashboard's JSON APIs answer;
    no replica worker maps libcuda."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve, versioning
    from ray_tpu_torch.api import _get_runtime
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.serve.deployment import _apps
    from ray_tpu_torch.serve.router import RequestRouter

    t_start = time.perf_counter()
    metrics_port, dash_port = _free_port(), _free_port()
    rt.init(resources={"CPU": 8, "memory": 8}, num_workers=2,
            system_config={"scheduler_device_batch_min": 256,
                           "serve_latency_ewma_alpha": SERVE_EWMA_ALPHA,
                           "rollout_slo_factor": SERVE_SLO_FACTOR,
                           "metrics_export_port": metrics_port,
                           "dashboard_port": dash_port})
    try:
        cluster = _get_runtime().cluster
        if cluster.scheduler_device.type != dev.type:
            raise AssertionError(f"the scheduler resolved to "
                                 f"{cluster.scheduler_device}")
        for _ in range(SERVE_NODES - 1):
            cluster.add_node(num_workers=2)
        noop = rt.remote(_noop)
        rt.get([noop.remote(i) for i in range(SERVE_NODES * 2)])

        @serve.deployment(num_replicas=SERVE_REPLICAS,
                          max_ongoing_requests=SERVE_ONGOING)
        class Model:
            def __init__(self):
                self.weights = "v1"

            @serve.batch(max_batch_size=SERVE_BATCH,
                         batch_wait_timeout_s=0.005)
            def __call__(self, items):
                xs = [int(x.query["x"]) if hasattr(x, "query") else x
                      for x in items]
                return [[self.weights, 2 * x + 1] for x in xs]

            def reload(self, artifact):
                self.weights = bytes(artifact).decode()

        handle = serve.run(Model.bind(), route_prefix="/model")
        base = serve.http_address()
        rt.get([handle.remote(i) for i in range(SERVE_REPLICAS * 2)],
               timeout=120)                              # warm every path

        raylets = list(cluster.raylets.values())
        shapes = [{"num_cpus": 1}, {"num_cpus": 0.5},
                  {"resources": {"CPU": 1, "memory": 0.5}},
                  {"num_cpus": 0.25}]
        wrong, failures, lock = [], [], threading.Lock()
        client_cpu = []                 # each client thread's CPU seconds
        handle_lat, http_lat, http_codes = [], [], []
        done = [0]
        half = threading.Event()
        rollout_out = {}

        def check(x, got):
            if not (isinstance(got, (list, tuple)) and len(got) == 2 and
                    got[0] in ("v1", "v2") and got[1] == 2 * x + 1):
                with lock:
                    wrong.append((x, got))

        def handle_client(k):
            for i in range(k, SERVE_HANDLE_REQUESTS, SERVE_CLIENTS):
                t0 = time.perf_counter()
                try:
                    got = rt.get(handle.remote(i), timeout=120)
                except Exception as e:      # noqa: BLE001 — a gate
                    with lock:
                        failures.append(f"handle {i}: {e!r}")
                    continue
                dt = time.perf_counter() - t0
                check(i, got)
                with lock:
                    handle_lat.append(dt)
                    done[0] += 1
                    if done[0] == SERVE_HANDLE_REQUESTS // 2:
                        half.set()
            client_cpu.append(time.thread_time())

        def http_client(k):
            for i in range(k, SERVE_HTTP_REQUESTS, SERVE_HTTP_CLIENTS):
                t0 = time.perf_counter()
                status, headers, body = _http_get(f"{base}/model?x={i}")
                dt = time.perf_counter() - t0
                with lock:
                    http_codes.append(status)
                if status != 200:
                    with lock:
                        failures.append(f"http {i}: {status} {body[:200]}")
                    continue
                check(i, json.loads(body))
                with lock:
                    http_lat.append(dt)
            client_cpu.append(time.thread_time())

        # the latency EWMA the SLO guard reads, from this process's router
        router = RequestRouter.for_controller(_apps["default"].controller)
        ewma_ms = []

        def read_ewma():
            ewma_ms.append(router.backlog()[2])

        def watch_ewma():
            while "t_end" not in rollout_out:
                time.sleep(0.1)
                read_ewma()

        def roll():
            half.wait(timeout=600)
            rollout_out["t"] = time.perf_counter()
            read_ewma()
            watch = threading.Thread(target=watch_ewma, name="ewma-watch")
            watch.start()
            try:
                rollout_out["summary"] = versioning.rollout(
                    b"v2", artifact_label="v2")
            except Exception as e:          # noqa: BLE001 — a gate
                rollout_out["error"] = repr(e)
            rollout_out["t_end"] = time.perf_counter()
            watch.join(10)

        burst = {}

        def burst_run():
            t0 = time.perf_counter()
            refs = [noop.options(**shapes[i % 4]).remote(i)
                    for i in range(SERVE_BURST_TASKS)]
            burst["ok"] = rt.get(refs, timeout=900) == \
                list(range(SERVE_BURST_TASKS))
            burst["s"] = time.perf_counter() - t0

        def rounds():
            return np.array([[r.device_rounds, r.delta_rounds,
                              r.host_rounds] for r in raylets]).sum(axis=0)

        # --- the main path: counts start at 0 here and are read after ---
        hk.waterfill_scan.launches = 0
        hk.waterfill_scan.localized_launches = 0
        hk.beat_rows.launches = hk.beat_tail.launches = 0
        rounds0 = rounds()
        threads = [threading.Thread(target=handle_client, args=(k,),
                                    name=f"handle-client-{k}")
                   for k in range(SERVE_CLIENTS)]
        h_threads = [threading.Thread(target=http_client, args=(k,),
                                      name=f"http-client-{k}")
                     for k in range(SERVE_HTTP_CLIENTS)]
        r_thread = threading.Thread(target=roll, name="rollout")
        b_thread = threading.Thread(target=burst_run, name="burst")
        cpu0, workers_cpu0 = host_cpu(cluster)
        driver_cpu0 = _cpu_s("/proc/self/stat")
        t0 = time.perf_counter()
        for t in [b_thread, r_thread] + threads + h_threads:
            t.start()
        for t in threads:
            t.join(600)
        handle_s = time.perf_counter() - t0
        for t in h_threads:
            t.join(600)
        http_s = time.perf_counter() - t0
        traffic_end = time.perf_counter()
        # the driver's CPU over the traffic: the client threads (gone
        # by now, so each read its own), then the live threads by name
        # (the routers, the raylets, the worker-pipe readers, the burst)
        cpu1, workers_cpu1 = host_cpu(cluster)
        traffic_host = {
            "driver_cpu_per_wall_s":
                (_cpu_s("/proc/self/stat") - driver_cpu0) / http_s,
            "client_threads_cpu_s": sum(client_cpu),
            "driver_threads_cpu_s": dict(sorted(
                ((k, round(v - cpu0.get(k, 0.0), 2))
                 for k, v in cpu1.items()), key=lambda kv: -kv[1])[:8]),
            "workers_cpu_s": workers_cpu1 - workers_cpu0}
        half.set()
        for t in (r_thread, b_thread):
            t.join(900)
        if any(t.is_alive() for t in
               threads + h_threads + [r_thread, b_thread]):
            raise AssertionError("serve: a client, the rollout or the "
                                 "burst did not finish")
        launches = {"waterfill_scan": hk.waterfill_scan.launches,
                    "localized": hk.waterfill_scan.localized_launches,
                    "beat_rows": hk.beat_rows.launches,
                    "beat_tail": hk.beat_tail.launches}
        device_rounds, delta_rounds, host_rounds = \
            (int(x) for x in rounds() - rounds0)
        # --- end of the main path ---

        after = [rt.get(handle.remote(i), timeout=120)
                 for i in range(SERVE_BATCH)]
        summary = rollout_out.get("summary") or {}
        if wrong or failures:
            raise AssertionError(f"serve: {len(wrong)} wrong responses "
                                 f"{wrong[:3]}, {len(failures)} failed "
                                 f"{failures[:3]}")
        if len(handle_lat) != SERVE_HANDLE_REQUESTS or \
                len(http_lat) != SERVE_HTTP_REQUESTS:
            raise AssertionError("serve: responses missing")
        if summary.get("phase") != "SEALED" or \
                summary.get("flipped") != SERVE_REPLICAS or \
                summary.get("replicas") != SERVE_REPLICAS or \
                rollout_out["t"] >= traffic_end:
            raise AssertionError(f"serve: rollout {rollout_out}, latency "
                                 f"EWMA readings {ewma_ms}")
        if after != [["v2", 2 * i + 1] for i in range(SERVE_BATCH)]:
            raise AssertionError(f"serve: after the rollout {after[:4]}")
        if not burst.get("ok"):
            raise AssertionError("serve: the burst returned wrong results")
        if delta_rounds < 1 or min(launches[k] for k in (
                "waterfill_scan", "beat_rows", "beat_tail")) < 1:
            raise AssertionError(
                f"serve: {device_rounds} device rounds, {delta_rounds} "
                f"through the delta beat, launches {launches}")

        # /metrics against serve.status(), once the plane is quiet
        deadline = time.monotonic() + 60
        while True:
            plane = serve.status()["request_plane"]
            if plane["inflight"] == 0 and plane["queued"] == 0:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"serve: the plane stays busy {plane}")
            time.sleep(0.1)
        scraped = _scrape(metrics_port)
        plane = serve.status()["request_plane"]
        lbl = f'{{deployment="{plane["deployment"]}"}}'
        metrics_vs_status = {
            key: [scraped.get(f"ray_tpu_{name}{lbl}"), plane.get(key)]
            for key, name in SERVE_GAUGES.items()}
        bad = {k: v for k, v in metrics_vs_status.items()
               if v[0] is None or v[1] is None or float(v[0]) != v[1]}
        if bad:
            raise AssertionError(f"serve: /metrics vs serve.status(): "
                                 f"{bad}")
        version_gauge = scraped.get(f"ray_tpu_serve_model_version{lbl}")
        apis = {}
        for name in DASHBOARD_APIS:
            status, _, body = _http_get(
                f"http://127.0.0.1:{dash_port}/api/{name}")
            json.loads(body)
            apis[name] = status
        if any(code != 200 for code in apis.values()):
            raise AssertionError(f"serve: dashboard APIs {apis}")

        # replicas are CPU worker processes: none maps libcuda
        worker_pids = []
        for r in raylets:
            with r.pool._lock:
                worker_pids += [h.proc.pid for h in r.pool._workers
                                if h.proc is not None]
        with_cuda = [pid for pid in worker_pids if _holds_cuda(pid)]
        if with_cuda:
            raise AssertionError(f"serve: workers with libcuda {with_cuda}")
        serve.shutdown()
    finally:
        rt.shutdown()
    result = {
        "phase": "serve", "entry": "ray_tpu_torch.serve.run/handle/HTTP",
        "nodes": SERVE_NODES, "replicas": SERVE_REPLICAS,
        "max_batch_size": SERVE_BATCH,
        "max_ongoing_requests": SERVE_ONGOING,
        "handle_requests": SERVE_HANDLE_REQUESTS,
        "handle_clients": SERVE_CLIENTS,
        "handle_requests_per_s": SERVE_HANDLE_REQUESTS / handle_s,
        "handle_p50_ms": _quantile(handle_lat, 0.5) * 1e3,
        "handle_p99_ms": _quantile(handle_lat, 0.99) * 1e3,
        "http_requests": SERVE_HTTP_REQUESTS,
        "http_clients": SERVE_HTTP_CLIENTS,
        "http_requests_per_s": SERVE_HTTP_REQUESTS / http_s,
        "http_p50_ms": _quantile(http_lat, 0.5) * 1e3,
        "http_p99_ms": _quantile(http_lat, 0.99) * 1e3,
        "shed": plane["shed"], "batches": plane.get("batches"),
        "batch_size_mean": plane.get("batch_size_mean"),
        "batch_size_buckets": plane.get("batch_size_buckets"),
        "rollout": {k: summary.get(k) for k in
                    ("from", "to", "phase", "flipped", "replicas",
                     "max_flip_downtime_s", "seconds")},
        "rollout_started_after_s": rollout_out["t"] - t0,
        # the EWMA the SLO guard reads, every 0.1 s while the rollout ran
        "rollout_latency_ewma": {
            "alpha": SERVE_EWMA_ALPHA, "slo_factor": SERVE_SLO_FACTOR,
            "max_over_first": max(ewma_ms) / ewma_ms[0] if ewma_ms[0] else
            None, "readings_ms": ewma_ms},
        "model_version_gauge": version_gauge,
        "burst_tasks": SERVE_BURST_TASKS, "burst_s": burst["s"],
        "burst_tasks_per_s": SERVE_BURST_TASKS / burst["s"],
        "runtime_phase_tasks_per_s": runtime_tasks_per_s,
        "device_rounds": device_rounds, "delta_rounds": delta_rounds,
        "host_rounds": host_rounds, "launches": launches,
        "traffic_host": traffic_host,
        "metrics_vs_status": metrics_vs_status, "dashboard_apis": apis,
        "workers_checked_for_libcuda": len(worker_pids),
        "seconds": time.perf_counter() - t_start}
    emit(result)
    return result


# -- phase: dataplane (bundle, pull and broadcast programs) ------------------

def kernel_launches(fn):
    """CUDA kernels one call of ``fn`` launches (torch.profiler), or None
    where the trace holds no device events (as it often does for a call
    that launches only a ctypes-loaded kernel: the wrappers' launch
    counters are the count there)."""
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


# the data-plane programs' shapes: the dataplane cell's, the contract's
# MAX_NODES, and the runtime thresholds' own sizes (pg_device_batch_min
# groups of 8 bundles; pull_device_batch_min pulls), timed beside the
# numpy oracles so the thresholds can be set from data
DP_NODES, DP_GROUPS, DP_BUNDLES, DP_PULLS = 1000, 64, 8, 4096
DP_LIMIT_NODES = 8192
DP_THRESHOLD_GROUPS, DP_THRESHOLD_PULLS = 2, 128


def dataplane_problem(n=DP_NODES, groups=DP_GROUPS, bundles=DP_BUNDLES,
                      pulls=DP_PULLS, seed=0):
    """Seeded inputs of the three programs (at the defaults, the
    dataplane cell's draws): (N, 8) totals, a quarter of the cells 0,
    avail below them, 2% of rows masked out; P groups of B bundles (half
    the cells 0, 85% of slots valid, the four strategies in turn); an
    (N, N) bandwidth matrix (5% dead links), in-flight KB, R pulls of
    objects held by 1% of the rows; broadcast members (90%, the root 0
    among them)."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 6400, size=(n, 8)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.25] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.02
    reqs = rng.integers(0, 800, size=(groups, bundles, 8)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    valid = rng.random((groups, bundles)) < 0.85
    strat = (np.arange(groups) % 4).astype(np.int32)
    bw = rng.integers(0, 50_000, size=(n, n)).astype(np.int32)
    bw[rng.random((n, n)) < 0.05] = 0
    np.fill_diagonal(bw, 0)
    infl = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    loc = rng.random((pulls, n)) < 0.01
    dest = rng.integers(0, n, size=pulls).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=pulls).astype(np.int32)
    member = rng.random(n) < 0.9
    member[0] = True
    return {"bundles": (totals, avail, mask, reqs, valid, strat),
            "pulls": (loc, bw, dest, sizes, infl),
            "broadcast": (member, bw, infl)}


def bundle_key_passes(totals, avail, mask, reqs, valid, strat):
    """The positive-column counts of the key passes that gang placement
    needs on these inputs, replayed on the numpy oracle: one pass per
    STRICT_PACK group (its summed demand), and in a soft group one per
    valid bundle (both argmins read the same keys) up to its first that
    fails, since a failed group's result is discarded whole."""
    from ray_tpu_torch.scheduling.bundles import (PlacementStrategy,
                                                  schedule_bundles)
    from ray_tpu_torch.scheduling.oracle import ClusterState
    st = ClusterState(totals.copy(), avail.copy(), mask.copy())
    passes = []
    for p in range(valid.shape[0]):
        breqs = reqs[p, np.flatnonzero(valid[p])]
        s = PlacementStrategy(int(strat[p]))
        if s is PlacementStrategy.STRICT_PACK:
            passes.append(int((breqs.sum(0, dtype=np.int64) > 0).sum()))
            schedule_bundles(st, breqs, s)
            continue
        m = len(breqs)
        if schedule_bundles(st, breqs, s, commit=False) is None:
            m = next(j for j in range(1, m + 1) if schedule_bundles(
                st, breqs[:j], s, commit=False) is None)
        else:
            schedule_bundles(st, breqs, s)
        passes += [int((q > 0).sum()) for q in breqs[:m]]
    return passes


def dataplane_work(name, arrays):
    """(bytes, int32 operations) the program needs for these inputs:
    every input read once (of bw, the columns the pulls' destinations
    name), every output written once; the operations these inputs need
    (per bundle key pass ~16 per (node, positive column) and ~4 per node
    for the two minimums, ``bundle_key_passes``; per pull 1 per node to
    test its holder bit and ~6 per holder for eff and the maximum)."""
    if name == "bundles":
        totals, avail, mask, reqs, valid, strat = arrays
        (n, r_w), (p, b) = totals.shape, valid.shape
        passes = bundle_key_passes(*arrays)
        return (2 * n * r_w * 4 + n + reqs.size * 4 + valid.size + p * 4
                + p * b * 4 + p + n * r_w * 4,
                sum(n * (16 * c + 4) for c in passes))
    loc, bw, dest, sizes, infl = arrays
    r, n = loc.shape
    return (loc.size + len(np.unique(dest)) * n * 4 + r * 8 + n * 4
            + r * 8, r * n + int(loc.sum()) * 6)


DP_FANOUT = 4


def broadcast_uniform(n=DP_NODES):
    """Every member, every link at 1000 MB/s, nothing in flight: every
    parent's best child is the same node, the broadcast kernel's worst
    case (each attach takes every row's best)."""
    bw = np.full((n, n), 1000, np.int32)
    np.fill_diagonal(bw, 0)
    return np.ones(n, bool), bw, np.zeros(n, np.int32)


def broadcast_bounds(bw, parent):
    """Two bounds of one plan: the JAX program's work as the earlier
    rows counted it (N steps over all N^2 pairs, 8 int32 operations a
    pair: comparable with them, and no floor for a kernel that does not
    rescan every pair), and the work the function needs on these inputs
    (bw read once, member and in-flight KB read, parent and order
    written; eff once a pair and an N-way argmax a step for each attach
    and the last, empty step)."""
    n = bw.shape[0]
    io = n + n * 4 + n * 8
    steps = int((parent >= 0).sum()) + 1
    jax = bound(io + bw.size * 4, n * n * n * 8, PEAK_I32)
    need = bound(io + bw.size * 4, 8 * n * n + steps * n, PEAK_I32)
    return {"jax_program_bound_ms": jax[0], "jax_program_bound_by": jax[1],
            "bound_ms": need[0], "bound_by": need[1]}


def dataplane_kernel(name, arrays, dev, plain=True, oracle=True):
    """One program at one shape (the broadcast plan: root 0, fan-out
    DP_FANOUT): the hand-written kernel on device tensors (one call,
    counted) == its numpy oracle (and == its plain PyTorch version on the
    card), exact; kernel ms (CUDA events), plain ms, oracle ms (host
    clock), CUDA kernels a call, bound (the broadcast's two,
    ``broadcast_bounds``); ns a bundle step and the bundle kernel's
    layout, ns a pull."""
    import torch

    from ray_tpu_torch.ops import broadcast_kernel as bc
    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import pull_kernel as pk
    from ray_tpu_torch.scheduling.contract import threshold_fp
    if name == "bundles":
        totals, avail, mask, reqs, valid, strat = arrays
        t = [torch.tensor(a, device=dev) for a in (totals, avail, mask,
                                                   reqs, valid, strat)]
        thr = threshold_fp(None)
        fn = bk.schedule_bundle_groups

        def kernel():
            return fn(*t, thr)

        def plain_fn():
            return bk.schedule_bundle_groups_plain(*t[:4], valid, strat,
                                                   thr)

        def oracle_fn():
            return bk.schedule_bundle_groups_oracle(*arrays)
    elif name == "broadcast":
        member, bw, infl = arrays
        t = [torch.tensor(a, device=dev) for a in arrays]
        fn = bc.plan_fanout

        def kernel():
            return fn(t[0], t[1], 0, DP_FANOUT, t[2])

        def plain_fn():
            return bc.plan_fanout_plain(t[0], t[1], 0, DP_FANOUT, t[2])

        def oracle_fn():
            with np.errstate(divide="ignore", over="ignore"):
                return bc.plan_fanout_oracle(member, bw, 0, DP_FANOUT, infl)
    else:
        t = [torch.tensor(a, device=dev) for a in arrays]
        fn = pk.choose_sources

        def kernel():
            return fn(*t)

        def plain_fn():
            return pk.choose_sources_plain(*t)

        def oracle_fn():
            with np.errstate(over="ignore", divide="ignore"):
                return pk.choose_sources_oracle(*arrays)
    fn.launches = 0
    got = kernel()
    torch.cuda.synchronize()
    launches = fn.launches              # before the timed launches
    if launches != 1:
        raise AssertionError(f"{name}: {launches} kernel launches in one "
                             "call")
    out = {"kernel_ms": cuda_ms(kernel), "launches": launches}
    # the chain's unit: ns a bundle step (a key pass, in the layout the
    # shape took) or a pull
    if name == "bundles":
        steps = len(bundle_key_passes(*arrays))
        out.update(layout=fn.last_layout, cluster=fn.last_cluster,
                   steps=steps, ns_a_step=out["kernel_ms"] * 1e6 / steps)
    elif name == "pulls":
        out["ns_a_pull"] = out["kernel_ms"] * 1e6 / arrays[0].shape[0]
    if oracle:
        t0 = time.perf_counter()
        want = oracle_fn()
        out["oracle_ms"] = (time.perf_counter() - t0) * 1e3
        if not all(np.array_equal(g.cpu().numpy(), w)
                   for g, w in zip(got, want)):
            raise AssertionError(f"dataplane {name}: the kernel disagrees "
                                 "with the numpy oracle")
        out["equals_oracle"] = True
    if plain:
        pl = plain_fn()
        if not all(torch.equal(g, w) for g, w in zip(got, pl)):
            raise AssertionError(f"dataplane {name}: the kernel disagrees "
                                 "with its plain version on the card")
        out["plain_ms"] = cuda_ms(plain_fn, reps=1, warmup=0)
        out["equals_plain"] = True
        out["kernels_per_call"] = kernel_launches(kernel)
        if name == "broadcast":
            parent = got[0].cpu().numpy()
            attached = int((parent >= 0).sum())
            out.update(broadcast_bounds(arrays[1], parent),
                       cluster=fn.last_cluster, layout=fn.last_layout,
                       attached=attached, members=int(arrays[0].sum()),
                       ns_an_attach=out["kernel_ms"] * 1e6
                       / max(attached, 1))
        else:
            out["bound_ms"], out["bound_by"] = bound(
                *dataplane_work(name, arrays), PEAK_I32)
        if name == "bundles":
            out["placed_groups"] = int(got[1].sum())
    return out


def phase_dataplane(dev):
    """The bundle, pull and broadcast programs' kernels
    (``csrc/bundle.cu``, ``csrc/pull.cu``, ``csrc/broadcast.cu``) on the
    card against their plain versions there and their numpy oracles,
    exact, at 1000 nodes x 64 placement groups x 8 bundles of every
    strategy, 4096 pulls over 1000 nodes and a broadcast to 1000 members
    at fan-out 4, and again at 8192 nodes (the broadcast without its
    oracle); the broadcast with uniform bandwidth at 1000; kernel and
    oracle ms at the runtime thresholds' sizes."""
    today = dataplane_problem()
    limit = dataplane_problem(n=DP_LIMIT_NODES, seed=1)
    small = dataplane_problem(groups=DP_THRESHOLD_GROUPS,
                              pulls=DP_THRESHOLD_PULLS, seed=2)
    out = {}
    for name in ("bundles", "pulls"):
        out[name] = dataplane_kernel(name, today[name], dev)
        out[f"{name}_{DP_LIMIT_NODES}"] = dataplane_kernel(
            name, limit[name], dev)
    thresholds = {
        f"bundles {DP_THRESHOLD_GROUPS}x{DP_BUNDLES}": dataplane_kernel(
            "bundles", small["bundles"], dev, plain=False),
        f"pulls {DP_THRESHOLD_PULLS}": dataplane_kernel(
            "pulls", small["pulls"], dev, plain=False)}
    # the broadcast plan (csrc/broadcast.cu): the cell's problem, the
    # contract's 8192 nodes (no oracle: ~an hour), uniform bandwidth
    out["broadcast"] = dataplane_kernel("broadcast", today["broadcast"], dev)
    out[f"broadcast_{DP_LIMIT_NODES}"] = dataplane_kernel(
        "broadcast", limit["broadcast"], dev, oracle=False)
    del limit
    out["broadcast_uniform"] = dataplane_kernel(
        "broadcast", broadcast_uniform(), dev)
    result = {"phase": "dataplane", "problems": {
        "bundles": [DP_NODES, DP_GROUPS, DP_BUNDLES],
        f"bundles_{DP_LIMIT_NODES}": [DP_LIMIT_NODES, DP_GROUPS,
                                      DP_BUNDLES],
        "pulls": [DP_PULLS, DP_NODES],
        f"pulls_{DP_LIMIT_NODES}": [DP_PULLS, DP_LIMIT_NODES],
        "broadcast": [DP_NODES, DP_FANOUT],
        f"broadcast_{DP_LIMIT_NODES}": [DP_LIMIT_NODES, DP_FANOUT],
        "broadcast_uniform": [DP_NODES, DP_FANOUT]},
        **out, "thresholds": thresholds}
    emit(result)
    return result


# -- phase: broadcast (BroadcastManager.broadcast on a port Cluster) ---------

BCAST_ROWS = 72                  # the root and 71 members: one CTA a plan
BCAST_PAYLOAD = 8 << 20          # 8 chunks of broadcast_chunk_mb
BCAST_CHUNK_MB = 1
BCAST_ARENA_MB = 32
BCAST_LINKS_MBPS = (1_000, 10_000, 25_000, 40_000)


def phase_broadcast(dev):
    """The broadcast through its entry point: a port ``Cluster`` whose 72
    rows serve standalone object-plane endpoints (the shape of
    ``tests/test_broadcast.py``'s ``mgr_cluster``, the NodeAgent's
    without worker processes), a seeded link rate from
    ``BCAST_LINKS_MBPS`` on every pair of them (ties and deratings both
    shape the tree), ``broadcast_device_batch_min`` set to the member
    count so the plan runs on the card, and
    ``cluster.broadcasts.broadcast(oid, node_rows=...)`` of an 8 MiB
    object in 1 MB chunks: every member holds the bytes, bit-exact,
    ``reached`` == members with no fallback, and the plan launched the
    broadcast kernel exactly once (its count set to 0 just before, read
    just after) in the layout the kernel's rule gives N: one CTA (the
    rule takes a cluster only past kRowsPerCta = 1024 rows, which this
    phase's endpoint planes cannot reach; the dataplane phase runs the
    cluster at 8192).  The plan's inputs and
    the tree the manager used are captured at the call; after it the
    kernel, its plain version on the card and the numpy oracle run on
    those inputs, and all four trees must be equal, exact."""
    import os
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.common.config import Config
    from ray_tpu_torch.common.ids import ObjectID
    from ray_tpu_torch.native import Arena
    from ray_tpu_torch.ops import broadcast_kernel as bc
    from ray_tpu_torch.rpc import RpcServer
    from ray_tpu_torch.runtime.object_plane import ObjectPlane
    from ray_tpu_torch.runtime.object_store import MemoryStore
    from ray_tpu_torch.runtime.serialization import serialize

    members = BCAST_ROWS - 1
    Config.reset({"broadcast_chunk_mb": BCAST_CHUNK_MB,
                  "broadcast_device_batch_min": members})
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, size=BCAST_PAYLOAD,
                           dtype=np.uint8).tobytes()
    plans = []                  # (the plan's inputs, the tree it returned)
    plan_np = bc.plan_fanout_np

    def capture(member, bw, root, fanout, inflight_kb=None, device=None):
        tree = plan_np(member, bw, root, fanout, inflight_kb, device=device)
        plans.append(((np.array(member, bool), np.array(bw, np.int32),
                       int(root), int(fanout),
                       np.zeros(len(member), np.int32) if inflight_kb is None
                       else np.array(inflight_kb, np.int32)), tree))
        return tree

    tmp = tempfile.mkdtemp(prefix="rt_broadcast_")
    cluster = server = None
    ends = []                                   # (arena, store, plane, rpc)
    try:
        cluster = Cluster()
        if cluster.scheduler_device.type != dev.type:
            raise AssertionError(f"the cluster's device resolved to "
                                 f"{cluster.scheduler_device}")
        server = RpcServer({}).start()
        cluster.plane.attach(server)
        for i in range(BCAST_ROWS):
            arena = Arena(os.path.join(tmp, f"arena_{i}"),
                          BCAST_ARENA_MB << 20, create=True)
            store = MemoryStore(arena=arena,
                                spill_dir=os.path.join(tmp, f"spill_{i}"))
            plane = ObjectPlane(store)
            rpc = RpcServer({}).start()
            plane.attach(rpc)
            ends.append((arena, store, plane, rpc))
            cluster.add_node(resources={"CPU": 1}, num_workers=0,
                             plane_address=rpc.address)
        row_of = {addr: row for row, addr in cluster.planes.items()}
        rows = [row_of[e[3].address] for e in ends]
        for src in rows:
            for dst in rows:
                if src != dst:
                    cluster.set_node_bandwidth(
                        src, dst, int(rng.choice(BCAST_LINKS_MBPS)),
                        symmetric=False)
        oid = ObjectID.from_random()
        ends[0][1].put_serialized(oid, serialize(payload))
        kind, sealed = ends[0][1].plasma_info(oid)
        if kind != "shm":
            raise AssertionError(f"the root sealed the object as {kind}")
        cluster.directory.add_location(oid, rows[0])
        bc.plan_fanout_np = capture
        try:
            # --- the main path: the count starts at 0 here, is read after -
            bc.plan_fanout.launches = 0
            t0 = time.perf_counter()
            res = cluster.broadcasts.broadcast(oid, node_rows=rows[1:])
            seconds = time.perf_counter() - t0
            launches = bc.plan_fanout.launches
            ctas = bc.plan_fanout.last_cluster
            layout = bc.plan_fanout.last_layout
            # --- end of the main path ---
        finally:
            bc.plan_fanout_np = plan_np
        exact = sum(e[1].peek(oid) == payload for e in ends[1:])
        if not (res["ok"] and res["members"] == members
                and res["reached"] == members and res["fallbacks"] == 0
                and exact == members and launches == 1
                and len(plans) == 1):
            raise AssertionError(f"broadcast: {res}, {exact} of {members} "
                                 f"members bit-exact, {launches} kernel "
                                 f"launches, {len(plans)} plans")
        if dev.type == "cuda" and not (
                (layout, ctas) == ("cta", 1)
                == bc.fanout_plan(plans[0][0][1].shape[0])):
            raise AssertionError(f"broadcast: the plan ran as {layout} "
                                 f"over {ctas} CTA(s); the rule gives one "
                                 "CTA at this N")
        stats = cluster.broadcasts.stats()
    finally:
        if cluster is not None:
            cluster.stop()
        if server is not None:
            server.stop()
        for arena, _store, plane, rpc in ends:
            plane.shutdown()
            rpc.stop()
            arena.close()
        shutil.rmtree(tmp, ignore_errors=True)
        Config.reset()
    # the plan's own inputs, again: kernel == plain on the card == oracle
    # == the tree the manager used (these launches are not the path's)
    (member, bw, root, fanout, infl), used = plans[0]
    t = [torch.tensor(a, device=dev) for a in (member, bw, infl)]
    trees = {"kernel": bc.plan_fanout(t[0], t[1], root, fanout, t[2]),
             "plain": bc.plan_fanout_plain(t[0], t[1], root, fanout, t[2])}
    trees = {k: tuple(x.cpu().numpy() for x in v) for k, v in trees.items()}
    with np.errstate(divide="ignore", over="ignore"):
        trees["oracle"] = bc.plan_fanout_oracle(member, bw, root, fanout,
                                                infl)
    for name, tree in trees.items():
        if not all(np.array_equal(g, w) for g, w in zip(tree, used)):
            raise AssertionError(f"broadcast: the {name} tree on the plan's "
                                 "inputs differs from the tree the manager "
                                 "used")
    result = {"phase": "broadcast",
              "entry": "Cluster.broadcasts.broadcast",
              "rows": BCAST_ROWS, "members": members,
              "plan_nodes": int(bw.shape[0]), "plan_fanout": fanout,
              "payload_bytes": BCAST_PAYLOAD, "sealed_bytes": sealed,
              "chunks": -(-sealed // (BCAST_CHUNK_MB << 20)),
              "reached": res["reached"], "fallbacks": res["fallbacks"],
              "bit_exact_members": exact, "depth": res["depth"],
              "relay_fanout": res["relay_fanout"], "seconds": seconds,
              "launches": launches, "cluster": ctas, "layout": layout,
              "plan_equals": sorted(trees), "plan_device": str(dev),
              "trees_completed": stats.get("bcast_trees_completed")}
    emit(result)
    return result


# -- phase: autoscaler (binpack: the water-fill, then the launch loop) -------

AUTOSCALE_NODES, AUTOSCALE_RES, AUTOSCALE_CLASSES = 1000, 64, 64
AUTOSCALE_TYPES, AUTOSCALE_DEMAND = 16, 1_000_000


def autoscale_problem(seed=0, n_nodes=AUTOSCALE_NODES, n_res=AUTOSCALE_RES,
                      n_groups=AUTOSCALE_CLASSES, n_types=AUTOSCALE_TYPES,
                      n_demand=AUTOSCALE_DEMAND):
    """tests/test_autoscaler.py's random_autoscale_problem at full width:
    its value ranges and its zero densities of totals and caps; each
    class asks for 3 of the 64 kinds (the test's classes ask for half of
    4: at half of 64 no node type could hold any class, and the loop
    would stop after one iteration); counts a multinomial summing to
    ``n_demand``; launch quotas (max_workers) scaled to that demand
    (0-2000 nodes a type, where the test draws 0-8 for 0-50 demands a
    class)."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 2000, size=(n_nodes, n_res)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.3] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n_nodes) > 0.2
    reqs = np.zeros((n_groups, n_res), np.int32)
    for row in reqs:
        kinds = rng.choice(n_res, size=min(3, n_res), replace=False)
        row[kinds] = rng.integers(1, 500, size=kinds.size)
    counts = rng.multinomial(n_demand, np.full(n_groups, 1 / n_groups))
    caps = rng.integers(0, 3000, size=(n_types, n_res)).astype(np.int32)
    caps[rng.random(caps.shape) < 0.2] = 0
    quotas = rng.integers(0, 2000, size=n_types).astype(np.int32)
    return (totals, avail, mask, reqs, counts.astype(np.int32), caps,
            quotas)


def oracle_autoscale(totals, avail, mask, reqs, counts, caps, quotas):
    """The port's numpy oracle (autoscaler.demand): (launches, fit
    counts, unmet, new avail)."""
    from ray_tpu_torch.autoscaler.demand import get_nodes_to_launch
    from ray_tpu_torch.scheduling.oracle import ClusterState
    st = ClusterState(totals.copy(), avail.copy(), mask.copy())
    launches, fit, unmet = get_nodes_to_launch(st, reqs, counts, caps,
                                               quotas)
    return launches, fit, unmet, st.avail


def phase_autoscaler(dev):
    """``autoscale`` on the card (one first-fit water-fill launch, then
    one ``binpack_launch_loop`` launch) at 1000 nodes x 64 resources x 64
    demand classes x 1,000,000 pending demands x 16 node types, and the
    1M-demand single-class case: bit-exact against the numpy oracle; the
    launch loop against its plain version on the card; then the user's
    path, a ``StandardAutoscaler`` round on a port Cluster on the card
    (``autoscaler_round``)."""
    import torch

    from ray_tpu_torch.ops import binpack_kernel as bp
    from ray_tpu_torch.ops import hybrid_kernel as hk

    problems = {
        "full": autoscale_problem(),
        # tests/test_autoscaler.py:121-130: 1M demands, an empty cluster
        "1M one class": (np.zeros((1, 1), np.int32),
                         np.zeros((1, 1), np.int32), np.zeros(1, bool),
                         np.array([[100]], np.int32),
                         np.array([1_000_000], np.int32),
                         np.array([[12800]], np.int32),
                         np.array([10_000], np.int32))}
    out = {}
    for name, p in problems.items():
        got = bp.autoscale_np(*p, device=dev)
        t0 = time.perf_counter()
        want = oracle_autoscale(*p)
        oracle_ms = (time.perf_counter() - t0) * 1e3
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"autoscaler {name}: the card disagrees "
                                 "with the numpy oracle")
        out[name] = {"launches_by_type": got[0].tolist(),
                     "nodes_launched": int(got[0].sum()),
                     "fit_on_existing": int(got[1][:, :-1].sum()),
                     "unmet": int(got[2].sum()), "oracle_ms": oracle_ms,
                     "bit_exact": True}
    if out["1M one class"]["launches_by_type"] != [7813]:
        raise AssertionError(f"1M demands: {out['1M one class']}")

    # the two launches of the full problem, each timed alone
    totals, avail, mask, reqs, counts, caps, quotas = (
        torch.tensor(np.ascontiguousarray(a), device=dev)
        for a in problems["full"])
    g, n = reqs.shape[0], totals.shape[0]
    k, r = caps.shape
    max_iters = g * k + g + k + 2

    def scan():
        return hk.waterfill_scan(totals, avail, mask, reqs, counts, None,
                                 bp.FIRST_FIT_THR_FP, True)

    fit, _ = scan()
    zero = ~(reqs > 0).any(dim=1)
    remaining = torch.where(zero, 0, fit[:, -1]).to(torch.int32).contiguous()
    loop_args = (caps, quotas, reqs, remaining, max_iters)
    kern = bp.binpack_launch_loop(*loop_args)
    plain = bp.launch_loop_plain(*loop_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError("binpack_launch_loop disagrees with "
                             "launch_loop_plain on the card")
    iters = int(kern[2])
    kernel_ms = cuda_ms(lambda: bp.binpack_launch_loop(*loop_args))
    kernel_layout = bp.binpack_launch_loop.last_layout   # the launch timed
    # the class steps of one launch (the same in every timed launch),
    # and how many ran one after another: fewer steps and cheaper steps
    # are the kernel's two levers
    class_steps = int(bp.binpack_launch_loop.last_class_steps)
    chain_steps = int(bp.binpack_launch_loop.last_chain_steps)
    if not 0 < chain_steps <= class_steps <= iters * k * g:
        raise AssertionError(f"launch loop: {class_steps} class steps, "
                             f"{chain_steps} in a chain, in {iters} "
                             f"iterations of {k} x {g}")
    plain_ms = cuda_ms(lambda: bp.launch_loop_plain(*loop_args), reps=3,
                       warmup=1)
    scan_ms = cuda_ms(scan)
    spill = spilled_launch_loop(dev)
    # the launch loop's work for this run's iterations
    bound_ms, bound_by = bound(*loop_work(k, g, r, iters), PEAK_I32)
    scan_bytes = (2 * n * r * 4 + n + g * r * 4 + g * 4
                  + g * (n + 1) * 4 + n * r * 4)
    scan_bound_ms, scan_bound_by = bound(
        scan_bytes, waterfill_ops(problems["full"][3], n), PEAK_I32)

    main = autoscaler_round(dev)
    result = {"phase": "autoscaler", "entry": "StandardAutoscaler.update",
              "problem": [n, r, g, int(problems["full"][4].sum()), k],
              "problems": out, "iterations": iters, "max_iters": max_iters,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "class_steps": class_steps,
              "dense_class_steps": iters * k * g,
              "ns_per_class_step": kernel_ms * 1e6 / class_steps,
              "chain_steps": chain_steps, "dense_chain_steps": iters * g,
              "ns_per_chain_step": kernel_ms * 1e6 / chain_steps,
              "kernel_layout": kernel_layout, "spilled": spill,
              "scan_ms": scan_ms, "scan_bound_ms": scan_bound_ms,
              "scan_bound_by": scan_bound_by, "main_path": main,
              "main_path_launches": main["kernel_launches"]}
    emit(result)
    return result


def spilled_launch_loop(dev, k=16, g=1024, r=64, max_iters=8):
    """The launch loop past one CTA's shared memory (at K=16, R=64 a
    dense table of more than ~225 classes' rows does not fit, so the
    compact rows are streamed through the ring): the first ``max_iters``
    iterations, bit-exact against the plain version on the card, with
    the kernel's ms, its class steps and the arrays it kept in global
    memory."""
    import torch

    from ray_tpu_torch.ops import binpack_kernel as bp
    problem = autoscale_problem(seed=1, n_nodes=1, n_res=r, n_groups=g,
                                n_types=k)
    reqs, counts, caps, quotas = (
        torch.tensor(np.ascontiguousarray(a), device=dev)
        for a in problem[3:])
    args = (caps, quotas, reqs, counts, max_iters)
    kern = bp.binpack_launch_loop(*args)
    layout = bp.binpack_launch_loop.last_layout
    steps = int(bp.binpack_launch_loop.last_class_steps)
    chain = int(bp.binpack_launch_loop.last_chain_steps)
    plain = bp.launch_loop_plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)) or \
            not layout["global"] or not layout["ring_slots"] or \
            not 0 < chain <= steps <= int(kern[2]) * k * g:
        raise AssertionError(f"spilled launch loop ({k}, {g}, {r}): "
                             f"layout {layout}, {steps} class steps, kernel "
                             f"== plain {[torch.equal(a, b) for a, b in zip(kern, plain)]}")
    ms = cuda_ms(lambda: bp.binpack_launch_loop(*args))
    return {"shape": [k, g, r], "iterations": int(kern[2]),
            "layout": layout, "ms": ms, "class_steps": steps,
            "ns_per_class_step": ms * 1e6 / steps, "chain_steps": chain,
            "ns_per_chain_step": ms * 1e6 / chain, "bit_exact": True}


# the main path's node types and demand: cpu8's quota binds, cpu1024's
# and gpu4's do not (the oracle launches 2, 4 and 10 of 2, 10 and 40),
# so a wrong type pick or repeat factor shows in the launches, and the
# "accel" class no type holds stays unmet
ROUND_TYPES = (("cpu8", {"CPU": 8}, 2), ("cpu1024", {"CPU": 1024}, 10),
               ("gpu4", {"CPU": 16, "GPU": 4}, 40))
ROUND_BUNDLES = ([{"GPU": 1, "CPU": 2}] * 40 + [{"CPU": 1}] * 4150
                 + [{"accel": 1}] * 5)


def autoscaler_round(dev):
    """The user's path: one ``StandardAutoscaler.update`` on a port
    Cluster whose ``scheduler_device`` is ``dev``, with the demand
    (4,195 bundles) above ``autoscaler_device_batch_min``.  The round's
    ``autoscale`` call is recorded (inputs and outputs, on the card) and
    held, after the kernel counts are read, to the numpy oracle on the
    same inputs (launches, fit counts, unmet, new avail), and the launch
    loop is rerun on the round's own card tensors, kernel against plain,
    bit for bit.  Raises on any mismatch; returns the round's report."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import NodeTypeSpec
    from ray_tpu_torch.autoscaler.autoscaler import (NODE_TYPE_LABEL,
                                                     StandardAutoscaler)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.common.config import Config
    from ray_tpu_torch.common.resources import ResourceRequest
    from ray_tpu_torch.ops import binpack_kernel as bp
    from ray_tpu_torch.ops import hybrid_kernel as hk

    types = [NodeTypeSpec(name, res, max_workers=m)
             for name, res, m in ROUND_TYPES]
    quotas = np.array([t.max_workers for t in types], np.int32)
    Config.reset({"scheduler_device": str(dev)})
    cluster = Cluster()
    rounds, real = [], bp.autoscale

    def recording(*args):
        out = real(*args)
        rounds.append((args, out))
        return out

    try:
        cluster.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        rt.init(cluster=cluster)
        asc = StandardAutoscaler(cluster, types, workers_per_node=0)
        reqs_o = [ResourceRequest(b) for b in ROUND_BUNDLES]
        for q in reqs_o + [ResourceRequest(t.resources) for t in types]:
            cluster.crm.intern_request(q)
        snap = cluster.crm.snapshot()
        width = snap.totals.shape[1]
        classes = {}
        for q in reqs_o:
            classes.setdefault(q.key(), [q, 0])[1] += 1
        want = oracle_autoscale(
            snap.totals, snap.avail, snap.node_mask,
            np.stack([v[0].dense(cluster.crm.resource_index, width)
                      for v in classes.values()]),
            np.array([v[1] for v in classes.values()], np.int32),
            np.stack([ResourceRequest(t.resources).dense(
                cluster.crm.resource_index, width) for t in types]),
            quotas)
        bp.autoscale = recording
        bp.binpack_launch_loop.launches = 0
        hk.waterfill_scan.launches = 0
        asc.request_resources(ROUND_BUNDLES)
        summary = asc.update()
        launches = {"binpack_launch_loop": bp.binpack_launch_loop.launches,
                    "waterfill_scan": hk.waterfill_scan.launches}
        # --- end of the main path ---
        bp.autoscale = real
        expect = {t.name: int(m) for t, m in zip(types, want[0]) if m}
        labels = sorted(cluster.crm.labels_of(row).get(NODE_TYPE_LABEL, "")
                        for row in cluster.raylets)
        if asc.device_rounds != 1 or len(rounds) != 1 or \
                summary["launches"] != expect or \
                summary["unmet"] != int(want[2].sum()) or \
                launches["binpack_launch_loop"] < 1 or \
                launches["waterfill_scan"] < 1:
            raise AssertionError(
                f"StandardAutoscaler: {asc.device_rounds} device rounds, "
                f"launched {summary['launches']} (oracle {expect}), unmet "
                f"{summary['unmet']} (oracle {int(want[2].sum())}), kernel "
                f"launches {launches}")
        if not (want[0] < quotas).any() or not want[2].any():
            raise AssertionError(f"the round's demand no longer tells type "
                                 f"picks apart: oracle {want}")
        # the round's own device call: its four outputs against the
        # oracle on the inputs it was given
        (args, outs), = rounds
        host = [a.cpu().numpy() for a in args[:7]]
        if args[7] is not None:
            host[2] = host[2] & args[7].cpu().numpy()
        ref = oracle_autoscale(*host)
        if not all(np.array_equal(o.cpu().numpy(), w)
                   for o, w in zip(outs, ref)):
            raise AssertionError("the round's autoscale disagrees with "
                                 "the oracle on its own inputs")
        # the launch loop on the round's card tensors: kernel == plain ==
        # what the round returned
        caps, quotas_t, reqs = args[5], args[6], args[3]
        g, k = reqs.shape[0], caps.shape[0]
        remaining = torch.where(~(reqs > 0).any(dim=1), 0,
                                outs[1][:, -1]).to(torch.int32).contiguous()
        loop_args = (caps, quotas_t, reqs, remaining, g * k + g + k + 2)
        kern = bp.binpack_launch_loop(*loop_args)
        plain = bp.launch_loop_plain(*loop_args)
        if not all(torch.equal(a, b) for a, b in zip(kern, plain)) or \
                not torch.equal(kern[0], outs[0]) or \
                not torch.equal(kern[1], outs[2]):
            raise AssertionError("binpack_launch_loop disagrees with "
                                 "launch_loop_plain on the round's tensors")
        asc.shutdown()
    finally:
        bp.autoscale = real
        rt.shutdown()
        cluster.stop()
        Config.reset()
    return {"launched": summary["launches"], "oracle": expect,
            "quotas": quotas.tolist(), "unmet": summary["unmet"],
            "oracle_unmet": int(want[2].sum()),
            "fit_on_existing": int(outs[1][:, :-1].sum()),
            "loop_iterations": int(kern[2]), "loop_shape": list(caps.shape[:1]) + [g, caps.shape[1]],
            "device_rounds": asc.device_rounds, "node_types": labels,
            "kernel_launches": launches, "loop_vs_plain": "bit-exact",
            "outputs_vs_oracle": "bit-exact"}


# -- phase: topk (the contention-spread rounds) ------------------------------

def topk_check(totals, avail, mask, reqs, counts, counts_out, new_avail,
               k_abs, k_frac):
    """Hold a top-k round to its properties class by class, in numpy:
    each class's allocation lies on its k best keys (a numpy stable sort
    of the host twin's keys on the running avail), in {base, base + 1}
    there; an infeasible class overflows whole; consumption is capped at
    availability; the final avail is the card's."""
    from fractions import Fraction

    from ray_tpu_torch.ops.hybrid_kernel import (_INF_KEY,
                                                 _keys_one_req_host)
    from ray_tpu_torch.scheduling.contract import threshold_fp
    frac = Fraction(k_frac).limit_denominator(1 << 16)
    thr = threshold_fp(None)
    av = avail.astype(np.int64)
    n = totals.shape[0]
    for g in range(reqs.shape[0]):
        keys = _keys_one_req_host(totals, av, reqs[g], thr, mask)
        nf = int((keys != _INF_KEY).sum())
        k = min(max(k_abs, -((-nf * frac.numerator) // frac.denominator),
                    1), max(nf, 1))
        alloc, c = counts_out[g, :n].astype(np.int64), int(counts[g])
        if nf == 0:
            if alloc.any() or counts_out[g, n] != c:
                raise AssertionError(f"top-k class {g}: infeasible but "
                                     "placed")
            continue
        top = np.argsort(keys, kind="stable")[:k]
        base = c // k
        off = np.ones(n, bool)
        off[top] = False
        spread = np.isin(alloc[top], (base, base + 1)).all()
        if alloc[off].any() or not spread or alloc.sum() != c or \
                counts_out[g, n] != 0:
            raise AssertionError(f"top-k class {g}: not an even spread "
                                 f"over its {k} best keys")
        req = reqs[g].astype(np.int64)
        cap = np.where(req[None, :] > 0, av // np.maximum(req, 1)[None, :],
                       1 << 30).min(axis=1).clip(0, 1 << 30)
        av = av - np.minimum(alloc, cap)[:, None] * req[None, :]
    if not np.array_equal(av, new_avail):
        raise AssertionError("top-k: consumption past availability")


# (seed, round, group, k) -> the rotation offset the JAX function draws,
# randint(fold_in(fold_in(PRNGKey(seed), round), group), (), 0, k), read
# from JAX 0.9.0 (jax_threefry_partitionable) when this table was written
TOPK_JAX_OFFSETS = [
    (0, 1, 0, 1, 0), (0, 1, 0, 7, 2), (3, 1, 5, 48, 5), (7, 1, 63, 250, 50),
    (7, 2, 0, 1000, 120), (11, 977, 3, 3, 0), (123456789, 42, 17, 65535,
    31143), (2147483647, 10000, 9, 65536, 12237), (5, 4294967295, 2, 65537,
    46878), (4294967301, 3, 1, 100003, 19032), (-1, 7, 4, 2147483647,
    714088930), (8, 99, 31, 997, 250)]


def topk_offsets(dev):
    """The rotation offsets of TOPK_JAX_OFFSETS as ``device`` computes
    them: the host's threefry words, randint's span arithmetic there."""
    import torch

    from ray_tpu_torch.ops import locality_kernel as lk
    out = []
    for seed, rnd, g, k, _ in TOPK_JAX_OFFSETS:
        words = torch.tensor(lk.topk_draws(seed, rnd, g + 1)[g], device=dev)
        out.append(int(lk._randint_offset(
            words, torch.tensor(k, dtype=torch.int32, device=dev))))
    return out


def topk_kernel_case(arrays, dev, k_abs=1, k_frac=0.25, seed=7, rnd=1):
    """``schedule_grouped_topk`` (the kernel, one counted launch) on device
    tensors == ``schedule_grouped_topk_plain`` on the card, bit for bit;
    kernel ms, plain ms, CUDA kernels a call, bound."""
    from fractions import Fraction

    import torch

    from ray_tpu_torch.ops import locality_kernel as lk
    from ray_tpu_torch.scheduling.contract import threshold_fp
    totals, avail, mask, reqs, counts, *masks = arrays
    g = reqs.shape[0]
    frac = Fraction(k_frac).limit_denominator(1 << 16)
    t = [torch.tensor(a, device=dev) for a in (totals, avail, mask, reqs,
                                               counts)]
    args = (*t, torch.tensor(masks[0], device=dev) if masks else None,
            threshold_fp(None), k_abs, frac.numerator, frac.denominator,
            torch.tensor(lk.topk_draws(seed, rnd, g), device=dev))
    lk.schedule_grouped_topk.launches = 0
    got = lk.schedule_grouped_topk(*args)
    torch.cuda.synchronize()
    launches = lk.schedule_grouped_topk.launches   # before the timed ones
    if launches != 1:
        raise AssertionError("top-k: the call did not launch the kernel "
                             "once")
    want = lk.schedule_grouped_topk_plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("top-k: the kernel disagrees with its plain "
                             "version on the card")
    bound_ms, bound_by = bound(*topk_work(totals.shape[0], reqs),
                               PEAK_I32)
    kernel_ms = cuda_ms(lambda: lk.schedule_grouped_topk(*args))
    return {"kernel_equals_plain": True, "launches": launches,
            "layout": lk.schedule_grouped_topk.last_layout,
            "kernel_ms": kernel_ms, "classes": g,
            "ns_a_class": kernel_ms * 1e6 / g,
            "plain_ms": cuda_ms(lambda: lk.schedule_grouped_topk_plain(
                *args), reps=2, warmup=0),
            "kernels_per_call": kernel_launches(
                lambda: lk.schedule_grouped_topk(*args)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_topk(dev):
    """Top-k rounds: the kernel (``csrc/topk.cu``) against its plain
    version on the card, bit for bit, at the beat width (1000 nodes x 8
    resources x 64 classes x 1,000,000 tasks) and at the contract's limit
    (8192 x 16 x 128, per-class masks, negative avail); the card's
    result equals the CPU run bit for bit (the draws are made on the
    host) and holds the top-k properties; the rotation offsets equal the
    JAX function's; kernel, plain-on-card and CPU ms, launches, bound.
    Then a runtime burst with ``scheduler_top_k_fraction`` = 0.5 places
    through the raylet's top-k rounds, which launch the kernel."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.api import _get_runtime
    from ray_tpu_torch.ops import locality_kernel as lk

    totals, avail, mask, reqs, counts = build_problem(seed=3)
    k_abs, k_frac = 1, 0.25
    kw = dict(k_abs=k_abs, k_frac=k_frac)
    cases = {
        "beat 1000x8x64": topk_kernel_case(
            (totals, avail, mask, reqs, counts), dev, **kw),
        "limit 8192x16x128": topk_kernel_case(limit_problem(), dev, **kw)}
    got = lk.schedule_grouped_topk_np(totals, avail, mask, reqs, counts, 7,
                                      1, device=dev, **kw)
    want = lk.schedule_grouped_topk_np(totals, avail, mask, reqs, counts,
                                       7, 1, device="cpu", **kw)
    t0 = time.perf_counter()
    lk.schedule_grouped_topk_np(totals, avail, mask, reqs, counts, 7, 1,
                                device="cpu", **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("top-k: the card disagrees with the CPU")
    jax_offsets = [row[-1] for row in TOPK_JAX_OFFSETS]
    card_offsets, cpu_offsets = topk_offsets(dev), topk_offsets("cpu")
    if not card_offsets == cpu_offsets == jax_offsets:
        raise AssertionError(f"top-k offsets: card {card_offsets}, cpu "
                             f"{cpu_offsets}, JAX {jax_offsets}")
    topk_check(totals, avail, mask, reqs, counts, *got, **kw)
    n, r = totals.shape
    g = reqs.shape[0]

    # --- the main path: a burst through init/remote/get with top-k on ---
    rt.init(resources={"CPU": 8, "memory": 8}, num_workers=2,
            system_config={"scheduler_top_k_fraction": 0.5,
                           "scheduler_device_batch_min": 64})
    try:
        cluster = _get_runtime().cluster
        for _ in range(3):
            cluster.add_node(num_workers=2)
        raylets = list(cluster.raylets.values())
        before = sum(x.topk_rounds for x in raylets)
        noop = rt.remote(_noop)
        lk.schedule_grouped_topk.launches = 0
        t0 = time.perf_counter()
        res = rt.get([noop.remote(i) for i in range(2000)], timeout=300)
        burst_s = time.perf_counter() - t0
        burst_launches = lk.schedule_grouped_topk.launches
        topk_rounds = sum(x.topk_rounds for x in raylets) - before
        # --- end of the main path ---
        if res != list(range(2000)) or topk_rounds < 1 or \
                burst_launches < 1:
            raise AssertionError(f"top-k burst: {topk_rounds} top-k rounds, "
                                 f"{burst_launches} kernel launches")
    finally:
        rt.shutdown()
    beat = cases["beat 1000x8x64"]
    result = {"phase": "topk", "entry": "schedule_grouped_topk_np",
              "problem": [n, r, g, int(counts.sum())], "k_abs": k_abs,
              "k_frac": k_frac, "card_equals_cpu": True,
              "offsets_equal_jax": len(jax_offsets),
              "properties_hold": True, "cases": cases,
              "ms": beat["kernel_ms"], "plain_ms": beat["plain_ms"],
              "ns_a_class": beat["ns_a_class"], "layout": beat["layout"],
              "cpu_ms": cpu_ms, "launches": beat["launches"],
              "bound_ms": beat["bound_ms"], "bound_by": beat["bound_by"],
              "burst_tasks": 2000, "burst_s": burst_s,
              "topk_rounds": topk_rounds, "burst_launches": burst_launches}
    emit(result)
    return result


# -- phase: daemon (head, agents, client, CLI) -------------------------------

def _children(pid):
    """Pids whose parent is ``pid`` (from /proc)."""
    kids = []
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            try:
                stat = (entry / "stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(entry.name))
    return kids


def _alive(pid):
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _holds_cuda(pid):
    try:
        maps = Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return None
    return "libcuda" in maps


DAEMON_TASKS = 3000
# the head daemon's environment on top of this script's (RT_* knobs are
# the port's Config overrides): a client submits one task per RPC, so
# the head's rounds hold one or two tasks each, far below the default
# device batch floor of 4096; with the floor at 1 every round of
# all-default tasks runs on the card
DAEMON_HEAD_ENV = {"RT_SCHEDULER_DEVICE_BATCH_MIN": "1"}

DAEMON_DRIVER = """
import json, os, sys, ray_tpu_torch as rt
rt.init(address=os.environ["ADDR"])
N = int(os.environ["TASKS"])

@rt.remote
def where(i):
    return i, os.getppid()

shapes = [{"resources": {"CPU": 0.01, "agent_a": 1}},
          {"resources": {"CPU": 0.01, "agent_b": 1}}, {"num_cpus": 0.01}]
refs = [where.options(**shapes[i % 3]).remote(i) for i in range(N)]
out = rt.get(refs, timeout=300)
assert [i for i, _ in out] == list(range(N)), "wrong results"
hosts = {}
for i, ppid in out:
    hosts.setdefault(str(i % 3), set()).add(ppid)
print("RESULT " + json.dumps({
    "hosts": {k: sorted(v) for k, v in hosts.items()},
    "libcuda": "libcuda" in open("/proc/self/maps").read(),
    "torch": "torch" in sys.modules}))
rt.shutdown()
"""


def phase_daemon(dev):
    """The daemon half on the card: ``python -m ray_tpu_torch start
    --head`` (its raylet on the GPU), two ``agent`` subprocesses, a
    driver subprocess with ``init(address=...)`` whose burst lands on
    both agents, ``job submit --wait``, ``status``, ``stop``.  Only the
    head holds a CUDA context.  The head runs with DAEMON_HEAD_ENV in its
    environment (``RT_SCHEDULER_DEVICE_BATCH_MIN=1``: the client path's
    rounds hold a task or two, the default floor is 4096)."""
    import os
    import signal
    import tempfile

    from ray_tpu_torch.rpc import transport

    state = tempfile.mkdtemp(prefix="chip_smoke_daemon_")
    env = {k: v for k, v in os.environ.items()
           if k != "RAY_TPU_TORCH_ADDRESS" and not k.startswith("RT_")}
    repo = str(Path(__file__).resolve().parent)
    env.update(RAY_TPU_TORCH_STATE_DIR=state,
               PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""))
    metrics_port, dash_port = _free_port(), _free_port()
    head_env = dict(env, **DAEMON_HEAD_ENV,
                    RT_METRICS_EXPORT_PORT=str(metrics_port),
                    RT_DASHBOARD_PORT=str(dash_port))
    py = [sys.executable, "-m", "ray_tpu_torch"]

    def cli(*args, timeout=120, env=env):
        r = subprocess.run(py + list(args), capture_output=True, text=True,
                           env=env, cwd=repo, timeout=timeout)
        if r.returncode != 0:
            raise AssertionError(f"ray_tpu_torch {' '.join(args)}: rc "
                                 f"{r.returncode}\n{r.stdout[-2000:]}\n"
                                 f"{r.stderr[-2000:]}")
        return r.stdout

    t_start = time.perf_counter()
    agents, head_pid, stopped = [], None, False
    try:
        started = cli("start", "--head", "--resources",
                      '{"CPU": 4, "memory": 4}', "--num-workers", "2",
                      env=head_env)
        head_pid = int(started.split("(pid ")[1].split(")")[0])
        addr = (Path(state) / "ray_current_cluster").read_text().strip()
        for name in ("agent_a", "agent_b"):
            agents.append(subprocess.Popen(
                py + ["agent", "--address", addr, "--resources",
                      json.dumps({"CPU": 2, "memory": 2, name: 1000}),
                      "--num-workers", "2"],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                env=env, cwd=repo))
        client = transport.connect(addr)
        try:
            deadline = time.monotonic() + 90
            while len(client.call("nodes", timeout=30)) < 3:
                if time.monotonic() > deadline:
                    raise AssertionError("the agents did not join")
                time.sleep(0.2)
            sched0 = client.call("status", timeout=60)["scheduler"]
            t0 = time.perf_counter()
            drv = subprocess.run(
                [sys.executable, "-c", DAEMON_DRIVER], capture_output=True,
                text=True, cwd=repo, timeout=600,
                env=dict(env, ADDR=addr, TASKS=str(DAEMON_TASKS)))
            burst_s = time.perf_counter() - t0
            if drv.returncode != 0 or "RESULT" not in drv.stdout:
                raise AssertionError(f"driver: rc {drv.returncode}\n"
                                     f"{drv.stderr[-3000:]}")
            drv_out = json.loads(drv.stdout.split("RESULT ", 1)[1]
                                 .splitlines()[0])
            hosts = drv_out["hosts"]
            agent_pids = [a.pid for a in agents]
            if hosts["0"] != [agent_pids[0]] or \
                    hosts["1"] != [agent_pids[1]] or drv_out["libcuda"]:
                raise AssertionError(f"burst: tasks ran under {hosts}, "
                                     f"agents {agent_pids}; driver "
                                     f"libcuda {drv_out['libcuda']}")
            sched = client.call("status", timeout=60)["scheduler"]
            rounds = {key: sched[key] - sched0[key]
                      for key in ("device_rounds", "delta_rounds",
                                  "host_rounds", "topk_rounds")}
            launches = {key: n - sched0["launches"].get(key, 0)
                        for key, n in sched["launches"].items()}
            # delta rounds run the beat's three kernels
            need = ("waterfill_scan",) + (("beat_rows", "beat_tail")
                                          if rounds["delta_rounds"] else ())
            if rounds["device_rounds"] < 1 or \
                    min(launches.get(k, 0) for k in need) < 1:
                raise AssertionError(f"the head's raylet: {rounds}, "
                                     f"launches {launches}")
            # the head's exporter and dashboard, scraped over HTTP and
            # held against its status RPC
            scraped = _scrape(metrics_port)
            head_status = client.call("status", timeout=60)
            alive = sum(1 for n in head_status["nodes"] if n["Alive"])
            summary = json.loads(_http_get(
                f"http://127.0.0.1:{dash_port}/api/summary")[2])
            observed = {
                "num_nodes": [scraped.get("ray_tpu_num_nodes"), alive],
                "dashboard_nodes": [summary["nodes"], alive],
                "dashboard_url": [head_status["dashboard_url"],
                                  f"http://127.0.0.1:{dash_port}"]}
            if any(a != b for a, b in observed.values()) or alive != 3:
                raise AssertionError(f"the head's /metrics and dashboard "
                                     f"against its status: {observed}")
            # who holds the card: the head, and this script (earlier
            # phases); no agent or agent worker (the driver checked
            # itself).  nvidia-smi may print pids of another pid
            # namespace: its list is judged only where it shows the head
            smi = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.split()
            smi_pids = sorted(int(p) for p in smi if p.strip().isdigit())
            others = agent_pids + [w for a in agent_pids
                                   for w in _children(a)]
            maps = {pid: _holds_cuda(pid) for pid in others}
            head_in_smi = head_pid in smi_pids
            if any(maps.values()) or not _holds_cuda(head_pid) or \
                    set(others) & set(smi_pids) or \
                    (head_in_smi and
                     set(smi_pids) - {head_pid, os.getpid()}):
                raise AssertionError(f"CUDA contexts: nvidia-smi "
                                     f"{smi_pids}, libcuda maps {maps}")
        finally:
            client.close()
        script = Path(state) / "job.py"
        script.write_text(
            "import os, ray_tpu_torch as rt\n"
            "rt.init(address='auto')\n"
            "f = rt.remote(lambda x: x + 1)\n"
            "assert rt.get([f.remote(i) for i in range(50)], timeout=120)"
            " == list(range(1, 51))\n"
            "print('job-ok')\n"
            "rt.shutdown()\n")
        job = cli("job", "submit", "--wait", "--", sys.executable,
                  str(script), timeout=300)
        if "job-ok" not in job or "SUCCEEDED" not in job:
            raise AssertionError(f"job submit: {job[-2000:]}")
        rollout = json.loads(cli("rollout"))    # the version journal
        status = cli("status")
        if "nodes (3)" not in status or \
                f"scheduler: device={dev.type}" not in status:
            raise AssertionError(f"status: {status[-2000:]}")
        cli("stop")
        stopped = True
    finally:
        for a in agents:
            if a.poll() is None:
                a.send_signal(signal.SIGINT)        # agent.stop(): reaps
        for a in agents:
            try:
                a.wait(timeout=30)
            except subprocess.TimeoutExpired:
                a.kill()
                a.wait()
        if head_pid is not None:
            deadline = time.monotonic() + 30
            while _alive(head_pid) and time.monotonic() < deadline:
                try:                # reap if it is our child; else poll
                    os.waitpid(head_pid, os.WNOHANG)
                except ChildProcessError:
                    pass
                if not stopped:
                    os.kill(head_pid, signal.SIGTERM)
                time.sleep(0.2)
            if _alive(head_pid):
                os.kill(head_pid, signal.SIGKILL)
    result = {"phase": "daemon", "entry": "python -m ray_tpu_torch",
              "head_env": DAEMON_HEAD_ENV,
              "agents": 2, "tasks": DAEMON_TASKS, "burst_s": burst_s,
              "tasks_per_s": DAEMON_TASKS / burst_s,
              "task_parents": {"agent_a": hosts["0"], "agent_b": hosts["1"],
                               "unpinned": hosts["2"]},
              "head_rounds": rounds, "head_launches": launches,
              "nvidia_smi_pids": smi_pids, "head_pid": head_pid,
              "nvidia_smi_gate": ("passed" if head_in_smi else
                                  "skipped (pid namespace: nvidia-smi "
                                  "does not list the head's pid)"),
              "agent_processes_with_libcuda": sum(bool(v) for v in
                                                  maps.values()),
              "driver_imported_torch": drv_out["torch"],
              "job": "SUCCEEDED",
              "head_metrics_vs_status": observed,
              "rollout_cli": {"rc": 0, "deployments": len(rollout)},
              "seconds": time.perf_counter() - t_start}
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


def flash_limit(q, k, v, causal):
    """The plain version's output (f32) on these inputs and the
    elementwise limit of FLASH_TOL around it."""
    from ray_tpu_torch import ops
    atol, rtol, p_u = FLASH_TOL[str(q.dtype).replace("torch.", "")]
    want = ops.flash_attention_plain(q, k, v, causal=causal).float()
    pv_abs = ops.flash_attention_plain(q.float(), k.float(),
                                       v.float().abs(), causal=causal)
    return want, atol + rtol * want.abs() + p_u * pv_abs


def flash_bound(q, causal):
    """(bound_ms, bound_by, operations) of flash attention on (B, T, H,
    D) inputs like q: q, k, v read and the output written once, the two
    products' 4*B*H*T^2*D operations (half of them causal).  f32 runs
    each product as three TF32 products on the tensor cores (split
    TF32): its bound is 3 x operations at the TF32 peak."""
    b, t, h, d = q.shape
    ops = 4.0 * b * h * t * t * d * (0.5 if causal else 1.0)
    n_bytes = 4.0 * q.numel() * q.element_size()
    if q.element_size() == 4:
        return (*bound(n_bytes, 3 * ops, PEAK_TC_TF32), ops)
    return (*bound(n_bytes, ops, PEAK_TC_16BIT), ops)


def flash_fma_bound_ms(q, causal):
    """The f32 bound of PRs 3-12 (the operations at the f32 FMA peak),
    printed beside the split-TF32 bound so earlier shares stay
    readable; None for 16-bit inputs."""
    if q.element_size() != 4:
        return None
    b, t, h, d = q.shape
    ops = 4.0 * b * h * t * t * d * (0.5 if causal else 1.0)
    return bound(4.0 * q.numel() * 4, ops, PEAK_F32)[0]


def phase_flash(dev):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch import ops
    from ray_tpu_torch.ops.flash_attention import kernel_key_tile

    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, t, h, d, dtype):
        return [torch.randn((b, t, h, d), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
                for _ in range(3)]

    def drive(b, t, h, d, dtype, route):
        """One causal call through the entry point with the launch count
        set to 0 just before it; the launches it counted (the route it
        reported must be ``route``)."""
        q, k, v = qkv(b, t, h, d, dtype)
        ops.flash_attention.launches = 0
        out = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = ops.flash_attention.launches
        if launches < 1 or ops.flash_attention.last_route != route:
            raise AssertionError(
                f"ops.flash_attention {dtype} D={d}: {launches} launches "
                f"on {ops.flash_attention.last_route}, not {route}")
        if out.shape != q.shape or out.dtype != q.dtype or \
                not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"flash attention output {dtype} D={d}: "
                                 "wrong shape/dtype or not finite")
        return launches

    # --- the main path: the ops entry point at the headline shape ---
    main_launches = drive(2, 4096, 16, 128, torch.bfloat16,
                          "flash_wgmma_kernel")
    # --- flash_big16_kernel past 128, each width's path driven alone ---
    wide_launches = {d: drive(b, t, h, d, torch.bfloat16,
                              "flash_big16_kernel")
                     for b, t, h, d in FLASH_WIDE_PATHS if d <= FLASH_REACH}
    # --- f32 on the split-TF32 kernel (flash_tf32_kernel) at the headline
    # shape ---
    f32_launches = drive(2, 4096, 16, 128, torch.float32,
                         "flash_tf32_kernel")
    # --- past 512 on the two-pass routes (FLASH_TWOPASS_PATHS), beside
    # each call the kernel launches it made, as the library counted them
    # where each launch succeeded (two a chunk) ---
    twopass_launches, twopass_kernel_launches = {}, {}
    for name, (dtype_name, shape) in FLASH_TWOPASS_PATHS.items():
        twopass_launches[name] = drive(
            *shape, getattr(torch, dtype_name),
            flash_route_of(shape[3], dtype_name))
        twopass_kernel_launches[name] = \
            ops.flash_attention.last_kernel_launches
    print(f"flash attention two-pass kernel launches a call (2 a chunk): "
          f"{twopass_kernel_launches}", flush=True)

    cases = [("bfloat16", True, 2, 4096, 16, 128),
             ("bfloat16", False, 2, 4096, 16, 128),
             ("float16", False, 2, 4096, 16, 128),
             ("float32", True, 2, 4096, 16, 128),
             ("float32", False, 2, 4096, 16, 128),
             ("bfloat16", True, 2, 4096, 16, 64),
             ("float32", False, 2, 1024, 16, 64)]
    cases += [(dtype, causal, b, t, h, d)
              for dtype in ("bfloat16", "float32")
              for b, t, h, d in FLASH_WIDE_PATHS for causal in (True, False)]
    cases += [("float32", causal, *FLASH_TWOPASS_PATHS["f32_d2048"][1])
              for causal in (True, False)]
    rows = []
    for dtype_name, causal, b, t, h, d in cases:
        dtype = getattr(torch, dtype_name)
        q, k, v = qkv(b, t, h, d, dtype)
        got = ops.flash_attention(q, k, v, causal=causal)
        scratch_bytes = ops.flash_attention.last_scratch_bytes
        atol, rtol, p_u = FLASH_TOL[dtype_name]
        want, limit = flash_limit(q, k, v, causal)
        err = (got.float() - want).abs()
        max_err, ratio = float(err.max()), float((err / limit).max())
        if not ratio <= 1.0:
            raise AssertionError(f"flash attention {dtype_name} causal="
                                 f"{causal}: error {ratio} x its limit "
                                 f"(max abs err {max_err})")
        # the limit must be tight enough to fail a kernel that skips its
        # last key tile: 64 keys, and the f32 and cluster kernels' own
        tiles = sorted({FLASH_KEY_TILE} | (
            {kernel_key_tile(d, dtype)} if dtype == torch.float32 or d > 512
            else set()))
        fault_ratio = {}
        for tile in tiles:
            faulty = drop_last_key_tile(q, k, v, causal, tile).float()
            fault_ratio[tile] = float(((faulty - want).abs() / limit).max())
            del faulty
        del err, limit
        if not min(fault_ratio.values()) > 1.0:
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
        backend = sdpa_backend(qt, kt, vt, causal)
        bound_ms, bound_by, flops = flash_bound(q, causal)
        fma_ms = flash_fma_bound_ms(q, causal)
        rows.append({"dtype": dtype_name, "causal": causal,
                     "shape": [b, t, h, d], "max_abs_err": max_err,
                     "scratch_bytes": scratch_bytes,
                     "atol": atol, "rtol": rtol, "p_u": p_u,
                     "route": ops.flash_attention.last_route,
                     "max_err_over_limit": ratio,
                     "dropped_tile_err_over_limit": fault_ratio,
                     "kernel_ms": kernel_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_backend": backend,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / kernel_ms,
                     **({} if fma_ms is None else {
                         "bound_of": "3 TF32 products",
                         "fma_bound_ms": fma_ms,
                         "fma_bound_share": fma_ms / kernel_ms}),
                     "vs_library": kernel_ms / library_ms,
                     "tflops": flops / (kernel_ms / 1e3) / 1e12})
    result = {"phase": "flash_attention", "entry": "ops.flash_attention",
              "main_path_launches": main_launches,
              "wide_path_launches": wide_launches,
              "f32_path_launches": f32_launches,
              "twopass_path_launches": twopass_launches,
              "twopass_kernel_launches": twopass_kernel_launches,
              "cases": rows,
              "head_dims": flash_head_dims(qkv)}
    emit(result)
    return result


# head dims the kernel reaches by zero padding (to 64, 128, 256, 320), at
# 256 and at 512, and past 512 on the two-pass routes (576, 1024, 1088 and
# 1600: even and uneven slices of O's columns in both dtypes)
FLASH_HEAD_DIMS = (16, 32, 80, 96, 160, 256, 320, 512, 576, 1024, 1088,
                   1600)
# the widest D of the one-pass routes (the route table at the head of
# flash_attention.cu); past it each dtype's pair of two-pass kernels
FLASH_REACH = 512
FLASH_TWOPASS32 = "flash_scores32_kernel+flash_values32_kernel"
FLASH_TWOPASS16 = "flash_scores16_kernel+flash_values16_kernel"
# the two-pass routes' paths: both dtypes at DeepSeek-V3's absorbed MLA
# width at the full card (FLASH_WIDE_PATHS' last; five chunks of
# scratch), f32 at FLASH_HEAD_DIMS' shape past 1536 and at the full card
# at 2048, bf16 past 1024 at FLASH_HEAD_DIMS' shape
FLASH_TWOPASS_PATHS = {"f32_d576": ("float32", (2, 4096, 8, 576)),
                       "f32_d1600": ("float32", (2, 1024, 4, 1600)),
                       "f32_d2048": ("float32", (2, 4096, 8, 2048)),
                       "bf16_d576": ("bfloat16", (2, 4096, 8, 576)),
                       "bf16_d1088": ("bfloat16", (2, 1024, 4, 1088))}


def flash_route_of(d, dtype_name):
    """The kernel ``ops.flash_attention`` must report for head dim ``d``
    and dtype: by the route table at the head of flash_attention.cu, not
    read from the library."""
    if dtype_name == "float32":
        return "flash_tf32_kernel" if d <= FLASH_REACH else FLASH_TWOPASS32
    return ("flash_wgmma_kernel" if d <= 128 else
            "flash_big16_kernel" if d <= FLASH_REACH else FLASH_TWOPASS16)
# (b, t, h, d) of the wgmma kernels' full-card rows past D = 128: Gemma
# 7B's head dim (256, 16 heads; its config.json), the widest width of a
# CTA (16 (b, h) pairs x 64 query tiles of 64 = 1,024 CTAs), and the
# two-pass routes' at DeepSeek-V3's absorbed MLA width (576: its
# kv_lora_rank 512 + qk_rope_head_dim 64, config.json)
FLASH_WIDE_PATHS = ((2, 4096, 16, 256), (2, 4096, 8, 512),
                    (2, 4096, 8, 576))


def sdpa_backend(q, k, v, causal):
    """The backend ``scaled_dot_product_attention`` dispatches these
    (B, H, T, D) inputs to (``torch._fused_sdp_choice``, the choice the
    call itself makes), as a ``SDPBackend`` name."""
    import torch
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0,
                                              causal)).name


def flash_head_dims(qkv, b=2, t=1024, h=4):
    """Every head dim of FLASH_HEAD_DIMS, causal and not, bf16 and f32,
    at (b, t, h, d): the route the entry point reports as
    ``flash_route_of`` gives it, the kernel
    within FLASH_TOL of the plain version, and the limit still rejecting
    the plain version with its last key tile dropped (64 keys, and for
    f32 and past D = 512 the route's own tile); beside each kernel time
    the plain version's, its bound (the function's work at the original
    d; f32 with the FMA bound beside it), the library call's time
    (``scaled_dot_product_attention``, timed here and used nowhere in the
    port) and the backend it ran on."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch import ops
    from ray_tpu_torch.ops.flash_attention import kernel_key_tile
    rows = []
    for d in FLASH_HEAD_DIMS:
        for dtype_name in ("bfloat16", "float32"):
            tiles = {FLASH_KEY_TILE} | (
                {kernel_key_tile(d, getattr(torch, dtype_name))}
                if dtype_name == "float32" or d > 512 else set())
            for causal in (False, True):
                q, k, v = qkv(b, t, h, d, getattr(torch, dtype_name))
                got = ops.flash_attention(q, k, v, causal=causal).float()
                route = ops.flash_attention.last_route
                scratch_bytes = ops.flash_attention.last_scratch_bytes
                if route != flash_route_of(d, dtype_name):
                    raise AssertionError(
                        f"flash attention D={d} {dtype_name}: route {route}"
                        f", not {flash_route_of(d, dtype_name)}")
                want, limit = flash_limit(q, k, v, causal)
                ratio = float(((got - want).abs() / limit).max())
                fault = min(float(((drop_last_key_tile(
                    q, k, v, causal, tile).float() - want).abs() / limit)
                    .max()) for tile in tiles)
                if not (ratio <= 1.0 < fault):
                    raise AssertionError(
                        f"flash attention D={d} {dtype_name} causal={causal}"
                        f": error {ratio} x its limit, dropped tile {fault} x")
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal)
                kernel_ms = cuda_ms(lambda: ops.flash_attention(
                    q, k, v, causal=causal), reps=5, warmup=1)
                library_ms = cuda_ms(sdpa, reps=5, warmup=1)
                plain_ms = cuda_ms(lambda: ops.flash_attention_plain(
                    q, k, v, causal=causal), reps=5, warmup=1)
                bound_ms, bound_by, _ = flash_bound(q, causal)
                fma_ms = flash_fma_bound_ms(q, causal)
                rows.append({"d": d, "dtype": dtype_name, "causal": causal,
                             "route": route,
                             "scratch_bytes": scratch_bytes,
                             **({} if fma_ms is None else
                                {"bound_of": "3 TF32 products",
                                 "fma_bound_ms": fma_ms}),
                             "max_abs_err": float((got - want).abs().max()),
                             "max_err_over_limit": ratio,
                             "dropped_tile_err_over_limit": fault,
                             "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                             "library_ms": library_ms,
                             "library_backend": sdpa_backend(qt, kt, vt,
                                                             causal),
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "bound_share": bound_ms / kernel_ms,
                             "vs_library": kernel_ms / library_ms})
    return {"shape": [b, t, h], "cases": rows}


# -- phase: data (ingest onto the card) --------------------------------------

DATA_ROWS = 1 << 20              # one epoch's shard for a card: 512 MiB
DATA_COLS = 128                  # float32 features
DATA_BLOCKS = 64                 # 8 MiB blocks
DATA_BATCH = 8192
DATA_STORE_MB = 4096             # the default 512 spills past 0.8 of it
DATA_SCALE, DATA_SHIFT = np.float32(0.5), np.float32(3.0)


def _scale_shift(block):
    return block * DATA_SCALE + DATA_SHIFT


def data_source(rows=DATA_ROWS):
    """Features on a grid of 2**-8 below 8 in magnitude: after the
    scale and shift every value is a multiple of 2**-9 below 2**3, so a
    float64 sum over 2**20 rows needs at most 32 bits and is exact in
    any order; the column sums are held with a tolerance of 0."""
    rng = np.random.default_rng(0)
    return (rng.integers(-2048, 2048, size=(rows, DATA_COLS), dtype=np.int32)
            .astype(np.float32) / np.float32(256))


def phase_data(dev, rows=DATA_ROWS):
    """``ray_tpu_torch.data`` feeding the card through the entry points
    a user calls: ``from_numpy`` of a seeded epoch shard, a
    ``map_batches`` in the workers, ``iter_torch_batches`` with no
    device (the batches land on the GPU), column sums and the row count
    on the card == numpy's over the same transform; then a ``.rtb``
    round trip through ``write_blocks`` and ``stream_block_files``.
    Splits the ingest's seconds between the driver's gets, its row
    pivot (``Dataset.iter_batches``) and the rest (tensor, copy, sum),
    with the device's busy time and idle share from the profiler."""
    import os
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.api import _get_runtime

    t_start = time.perf_counter()
    src = data_source(rows)
    want = _scale_shift(src).astype(np.float64).sum(axis=0)
    src_sums = src.astype(np.float64).sum(axis=0)
    nbytes = src.nbytes
    rt.init(resources={"CPU": 8, "memory": 8}, num_workers=8,
            system_config={"object_store_memory_mb": DATA_STORE_MB})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rtb_")
    try:
        store = _get_runtime().cluster.store
        t0 = time.perf_counter()
        ds = data.from_numpy(src, parallelism=DATA_BLOCKS)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mapped = ds.map_batches(_scale_shift)
        rt.wait(list(mapped._blocks), num_returns=len(mapped._blocks),
                timeout=600)
        map_s = time.perf_counter() - t0

        spent = {"get": 0.0, "iter_batches": 0.0}
        materialize, iter_batches = mapped._materialize, mapped.iter_batches

        def timed_materialize():
            t = time.perf_counter()
            out = materialize()
            spent["get"] += time.perf_counter() - t
            return out

        def timed_iter_batches(**kw):
            it = iter_batches(**kw)
            while True:
                t = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                finally:
                    spent["iter_batches"] += time.perf_counter() - t
                yield b

        mapped._materialize = timed_materialize
        mapped.iter_batches = timed_iter_batches
        acc = torch.zeros(DATA_COLS, dtype=torch.float64, device=dev)
        n_rows = n_batches = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in mapped.iter_torch_batches(batch_size=DATA_BATCH):
                if b.device.type != dev.type or b.dtype != torch.float32:
                    raise AssertionError(f"a batch landed on {b.device} "
                                         f"as {b.dtype}")
                acc += b.sum(dim=0, dtype=torch.float64)
                n_rows += b.shape[0]
                n_batches += 1
            got = acc.cpu().numpy()
            ingest_s = time.perf_counter() - t0
        busy = {"h2d": 0.0, "kernels": 0.0}
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            key = "h2d" if "HtoD" in evt.name else "kernels"
            busy[key] += evt.time_range.elapsed_us() / 1e3
        busy_ms = busy["h2d"] + busy["kernels"]
        if n_rows != rows or not np.array_equal(got, want):
            raise AssertionError(
                f"ingest: {n_rows} rows (want {rows}), column sums off "
                f"by up to {float(np.abs(got - want).max())} (tolerance "
                f"0: the sums are exact in float64)")
        spilled = store.stats()["spilled_bytes"]

        # the .rtb round trip of the source, one file a block
        cblocks = [data.ColumnBlock({"x": c})
                   for c in np.array_split(src, DATA_BLOCKS)]
        t0 = time.perf_counter()
        paths = data.write_blocks(cblocks, tmp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rtb_rows, rtb_sums = 0, np.zeros(DATA_COLS, np.float64)
        for cb in data.stream_block_files(tmp).iter_blocks():
            x = cb.column("x")
            rtb_rows += x.shape[0]
            rtb_sums += x.astype(np.float64).sum(axis=0)
        stream_s = time.perf_counter() - t0
        if len(paths) != DATA_BLOCKS or rtb_rows != rows or \
                not np.array_equal(rtb_sums, src_sums):
            raise AssertionError(
                f".rtb round trip: {len(paths)} files, {rtb_rows} rows, "
                f"column sums off by up to "
                f"{float(np.abs(rtb_sums - src_sums).max())}")
        file_bytes = sum(os.path.getsize(p) for p in paths)
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    if spilled:
        raise AssertionError(f"the object store spilled {spilled} bytes "
                             f"at {DATA_STORE_MB} MB")
    pivot_s = spent["iter_batches"] - spent["get"]
    result = {"phase": "data", "entry": "ray_tpu_torch.data.from_numpy/"
              "map_batches/iter_torch_batches",
              "rows": rows, "cols": DATA_COLS, "blocks": DATA_BLOCKS,
              "batch_size": DATA_BATCH, "batches": n_batches, "bytes": nbytes,
              "object_store_mb": DATA_STORE_MB, "spilled_bytes": spilled,
              "put_s": put_s, "map_s": map_s,
              "ingest_s": ingest_s, "rows_per_s": rows / ingest_s,
              "gb_per_s": nbytes / ingest_s / 1e9,
              # the ingest's host seconds: the driver's gets of the
              # mapped blocks, its row pivot, and the rest (tensor from
              # numpy, the host-to-device copy, the column sums)
              "driver_get_s": spent["get"], "pivot_s": pivot_s,
              "copy_and_sum_s": ingest_s - spent["iter_batches"],
              "device_busy_ms": busy_ms, "h2d_device_ms": busy["h2d"],
              "kernel_device_ms": busy["kernels"],
              "idle_share": (1.0 - busy_ms / (ingest_s * 1e3)
                             if busy_ms else None),
              "sums_check": "exact (tolerance 0; float64 over a 2**-9 "
                            "grid)",
              "rtb": {"files": len(paths), "file_bytes": file_bytes,
                      "write_s": write_s, "stream_s": stream_s,
                      "write_gb_per_s": file_bytes / write_s / 1e9,
                      "stream_gb_per_s": file_bytes / stream_s / 1e9},
              "seconds": time.perf_counter() - t_start}
    emit(result)
    return result


# -- phase: sim (the simulator reproduces the reference's traces) -------------

SIM_NODES, SIM_SEED, SIM_FAULTS = 1000, 7, 50
# the reference's trace hashes (``ray_tpu.sim.run_campaign`` at 1000 nodes,
# seed 7, faults=50, default duration and autoscale), pinned here since
# this script imports nothing of the JAX package
SIM_PINNED = {
    "serve_diurnal":
        "9b3d469124a15dcd29f17ddf4601bb6bcff72b21ceaf857eab1e422be9381f19",
    "train_diurnal":
        "3bb2db6f16a9c61f0cbadd68866c28f36fed4d16bd2bc63ed8a7c3c379c651c5",
    "mixed":
        "6d571aec4560072e29a0fdc9b9f371eae44f3b95ec15afffc8f5fc8e5a0c0c51",
}


def phase_sim():
    """``python -m ray_tpu_torch simulate`` for three campaigns, one
    after the other, each in its own process: every run exits 0 and its
    trace hash equals the reference's; ``mixed`` runs twice
    (``--verify-replay``) and must replay to the same hash."""
    import os
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    t_start = time.perf_counter()
    runs = {}
    for campaign, want in SIM_PINNED.items():
        cmd = [sys.executable, "-m", "ray_tpu_torch", "simulate",
               "--nodes", str(SIM_NODES), "--seed", str(SIM_SEED),
               "--faults", str(SIM_FAULTS), "--campaign", campaign]
        if campaign == "mixed":
            cmd.append("--verify-replay")
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=repo,
                           env=env, timeout=600)
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"simulate {campaign} exited "
                                 f"{p.returncode}: {p.stderr[-2000:]}")
        out = json.loads(p.stdout)
        if out["trace_hash"] != want:
            raise AssertionError(f"simulate {campaign}: trace hash "
                                 f"{out['trace_hash']}, the reference's "
                                 f"{want}")
        if campaign == "mixed" and out.get("replay_matches") is not True:
            raise AssertionError(f"simulate mixed: the replay's hash "
                                 f"{out.get('replay_hash')} differs")
        runs[campaign] = {
            "events": out["events_fired"], "seconds": out["wall_s"],
            "events_per_s": out["events_fired"] / out["wall_s"],
            "process_s": wall, "trace_hash": out["trace_hash"],
            "hash_equals_reference": True, "ok": out["ok"],
            "invariant_checks": out["invariant_checks"],
            "faults_injected": out["faults_injected"],
            "replay_matches": out.get("replay_matches")}
    result = {"phase": "sim", "entry": "python -m ray_tpu_torch simulate",
              "nodes": SIM_NODES, "seed": SIM_SEED, "faults": SIM_FAULTS,
              "campaigns": runs,
              "seconds": time.perf_counter() - t_start}
    emit(result)
    return result


# -- phase: train (the training libraries on the card) ------------------------

# collectives: one rank's slice, 2**26 float32 (256 MiB)
COLL_ELEMS = 1 << 26
# a float32 sum or product of W values in another order: each adds at
# most (W - 1) roundings of 2**-24 (the values are in [0.5, 1.5))
COLL_RTOL_PER_RANK = 2.0 ** -23
# MeshTrainer: the data phase's epoch shard, an MLP of 34.1 M parameters
TRAIN_ROWS = 1 << 20
TRAIN_WIDTHS = (DATA_COLS, 4096, 4096, 4096, 1)
TRAIN_BATCH = 8192
TRAIN_LR = 1e-3
TRAIN_CHECK_ROWS = 1024
# the first step on the card against the CPU, per parameter tensor in the
# norm.  Adam's first update is lr * g / (|g| + eps), a step of lr in the
# sign of each gradient larger than eps: a gradient element whose sign
# the order of the products decides moves by up to 2 lr, far in relative
# terms, while the tensor moves by a few float32 roundings (7.6e-6 at
# full width on an NVIDIA H100 80GB HBM3 at 700 W).  The activation is
# tanh: under ReLU a pre-activation within rounding of 0 switches a whole
# sample's contribution to a unit on or off, and that moved w1 by 1.9e-3
# in the norm between the card and the CPU (same card)
TRAIN_STEP_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PROFILE_STEPS = 16
# bench_train.py's live elastic stage
LIVE_EPOCHS, LIVE_EPOCH_S = 3, 0.8
# the rllib scenarios of tests/test_rllib.py, each at its bar
RL_CPU_ITERS = 3
RL_UPDATE_TOL = 1e-6


def collective_ms(fn, devices, reps=10, warmup=2):
    """p50 over ``reps`` calls of ``fn``, each timed with CUDA events on
    every rank's device (the slowest rank's time)."""
    import torch
    for _ in range(warmup):
        fn()
    for d in devices:
        torch.cuda.synchronize(d)
    times = []
    for _ in range(reps):
        starts = []
        for d in devices:
            with torch.cuda.device(d):
                starts.append(torch.cuda.Event(enable_timing=True))
                starts[-1].record()
        fn()
        elapsed = []
        for d, start in zip(devices, starts):
            with torch.cuda.device(d):
                stop = torch.cuda.Event(enable_timing=True)
                stop.record()
                stop.synchronize()
                elapsed.append(start.elapsed_time(stop))
        times.append(max(elapsed))
    return float(np.percentile(times, 50))


def train_collectives(devices, elems=COLL_ELEMS):
    """Every ``DeviceCollectiveGroup`` op on every visible card (one
    256 MiB slice a rank) against the plain stack-and-reduce on CPU
    ranks: exact, except float sum and product past one card."""
    import torch

    from ray_tpu_torch.util.collective import DeviceCollectiveGroup
    grp = DeviceCollectiveGroup(devices)
    w = grp.world_size
    plain = DeviceCollectiveGroup(["cpu"] * w)
    parts = [torch.rand(elems, device=d,
                        generator=torch.Generator(device=d).manual_seed(r))
             + 0.5 for r, d in enumerate(grp.devices)]
    host = [p.cpu() for p in parts]
    ops = [("allreduce_sum", "allreduce", ("sum",)),
           ("allreduce_max", "allreduce", ("max",)),
           ("allreduce_min", "allreduce", ("min",)),
           ("allreduce_prod", "allreduce", ("prod",)),
           ("allgather", "allgather", ()),
           ("reducescatter_sum", "reducescatter", ("sum",)),
           ("reducescatter_max", "reducescatter", ("max",)),
           ("broadcast", "broadcast", (0,)),
           ("ring_shift", "ring_shift", (1,))]
    out = {}
    for label, name, args in ops:
        if name == "reducescatter":
            ins = [p.view(w, elems // w) for p in parts]
            hins = [h.view(w, elems // w) for h in host]
        else:
            ins, hins = parts, host
        got = getattr(grp, name)(ins, *args)
        on_ranks = [g.device for g in got] == grp.devices
        got = [g.cpu() for g in got]
        t0 = time.perf_counter()
        want = getattr(plain, name)(hins, *args)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(float((g - h).abs().max()) for g, h in zip(got, want))
        inexact = w > 1 and args and args[0] in ("sum", "prod")
        rtol = COLL_RTOL_PER_RANK * w if inexact else 0.0
        ok = all(torch.allclose(g, h, rtol=rtol, atol=0.0) if inexact
                 else torch.equal(g, h) for g, h in zip(got, want))
        if not ok or not on_ranks:
            raise AssertionError(f"collective {label} on {w} card(s): "
                                 f"max |card - plain| {err}, rtol {rtol}, "
                                 f"results on their ranks: {on_ranks}")
        # a rank reads its slice once and writes its result once
        moved = elems * 4 + got[0].numel() * 4
        del got, want
        ms = collective_ms(lambda: getattr(grp, name)(ins, *args),
                           grp.devices)
        out[label] = {"ms": ms, "max_abs_err": err,
                      "tolerance": f"rtol {rtol}" if inexact else "exact",
                      "alg_gb_per_s": elems * 4 / ms / 1e6,
                      "bound_ms": moved / PEAK_BYTES * 1e3,
                      "bound_by": "bytes", "plain_ms": plain_ms,
                      "plain_on": f"{w} CPU rank(s), one call"}
    return {"world": w, "route": "torch.cuda.nccl", "bytes_per_rank":
            elems * 4, "ops": out,
            "multi_card": "exercised" if w > 1 else
            "not exercised: one card (W = 1)"}


def teacher_rows(rows=TRAIN_ROWS):
    """The data phase's features (``default_rng(0)``, a 2**-8 grid) and a
    target column from a seeded teacher, tanh(x A) b."""
    x = data_source(rows)
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((DATA_COLS, 64)) / np.sqrt(DATA_COLS)
         ).astype(np.float32)
    b = (rng.standard_normal(64) / 8).astype(np.float32)
    y = np.tanh(x @ a) @ b
    return np.concatenate([x, y[:, None]], axis=1)


def mlp_init(widths=TRAIN_WIDTHS, seed=2):
    """LeCun-uniform weights and biases from a seed (numpy)."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
        lim = 1.0 / np.sqrt(fan_in)
        params[f"w{i}"] = rng.uniform(-lim, lim, (fan_in, fan_out)
                                      ).astype(np.float32)
        params[f"b{i}"] = rng.uniform(-lim, lim, fan_out).astype(np.float32)
    return params


def mlp_loss(params, batch):
    """Mean squared error of a tanh MLP; the batch's last column is the
    target."""
    import torch
    n = len(params) // 2
    h = batch[:, :-1]
    for i in range(n):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            h = torch.tanh(h)
    return torch.mean((h[:, 0] - batch[:, -1]) ** 2)


def _adam(ps):
    import torch
    return torch.optim.Adam(ps, lr=TRAIN_LR)


def train_mesh(dev, devices, rows=TRAIN_ROWS, widths=TRAIN_WIDTHS):
    """``MeshTrainer`` at full width: the first step on the card against
    the same step on the CPU, then one epoch through ``fit`` over a
    ``from_numpy`` dataset; per-step times, host seconds by part, the
    device's idle share and peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import data
    from ray_tpu_torch.train import MeshTrainer

    t_start = time.perf_counter()
    src = teacher_rows(rows)
    init = mlp_init(widths)
    n_params = sum(v.size for v in init.values())

    # the first step: card == CPU
    check = src[:TRAIN_CHECK_ROWS]
    card = MeshTrainer(mlp_loss, init, optimizer=_adam, devices=devices)
    cpu = MeshTrainer(mlp_loss, init, optimizer=_adam, devices=["cpu"])
    t0 = time.perf_counter()
    loss_card = card.step(check)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_cpu = cpu.step(check)
    cpu_s = time.perf_counter() - t0
    rel = {k: float((card.params[k].cpu() - cpu.params[k]).norm()
                    / cpu.params[k].norm()) for k in init}
    max_abs = max(float((card.params[k].cpu() - cpu.params[k]).abs().max())
                  for k in init)
    # elements whose first update differs by more than lr (a sign flip)
    flipped = sum(int(((card.params[k].cpu() - cpu.params[k]).abs()
                       > TRAIN_LR).sum()) for k in init)
    if max(rel.values()) > TRAIN_STEP_RTOL or \
            abs(loss_card - loss_cpu) > TRAIN_LOSS_RTOL * abs(loss_cpu):
        raise AssertionError(
            f"first step: card loss {loss_card} against the CPU's "
            f"{loss_cpu}; params off by {rel} (tolerance "
            f"{TRAIN_STEP_RTOL} in the norm)")
    del card, cpu

    # one epoch through fit(), from the same init
    ds = data.from_numpy(src, parallelism=DATA_BLOCKS)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = MeshTrainer(mlp_loss, init, optimizer=_adam, devices=devices)
    spent = {"pivot": 0.0, "h2d": 0.0, "step": 0.0}
    events, losses = [], []
    iter_batches, shards, step = ds.iter_batches, trainer._shards, \
        trainer.step

    def timed_iter_batches(**kw):
        it = iter_batches(**kw)
        while True:
            t = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            finally:
                spent["pivot"] += time.perf_counter() - t
            yield b

    def timed_shards(batch):
        t = time.perf_counter()
        out = shards(batch)
        spent["h2d"] += time.perf_counter() - t
        return out

    def timed_step(batch):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        loss = step(batch)
        stop.record()
        spent["step"] += time.perf_counter() - t
        events.append((start, stop))
        losses.append(loss)
        return loss

    ds.iter_batches = timed_iter_batches
    trainer._shards = timed_shards
    trainer.step = timed_step
    t0 = time.perf_counter()
    result = trainer.fit(ds, epochs=1, global_batch_size=TRAIN_BATCH)
    fit_s = time.perf_counter() - t0
    host_s = {"pivot": spent["pivot"], "h2d": spent["h2d"],
              "step_without_h2d": spent["step"] - spent["h2d"],
              "epoch": fit_s}
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [s.elapsed_time(e) for s, e in events]
    steps = len(losses)
    if steps != rows // TRAIN_BATCH or not np.all(np.isfinite(losses)):
        raise AssertionError(f"fit: {steps} steps, losses {losses[:4]}..")
    late = float(np.mean(losses[-16:]))
    if not late < losses[0]:
        raise AssertionError(f"fit: the last 16 losses average {late}, "
                             f"not below the first step's {losses[0]}")
    ckpt = result.checkpoint.to_dict()
    if sorted(ckpt["params"]) != sorted(init) or not all(
            v.device.type == "cpu" and bool(torch.isfinite(v).all())
            for v in ckpt["params"].values()):
        raise AssertionError("fit: the checkpoint's params are not "
                             "finite CPU tensors of every parameter")

    # the device's idle share over steady steps (each step, then the
    # pivot of the next batch, as in fit)
    it = trainer._batches(ds, TRAIN_BATCH)
    batch = next(it)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            step(batch)
            batch = next(it)
        torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    busy_ms = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    flops = 6 * n_params * TRAIN_BATCH
    ms = float(np.median(step_ms[7:]))
    return {
        "entry": "ray_tpu_torch.train.MeshTrainer.fit",
        "ranks": trainer.n_devices, "rows": rows,
        "widths": list(widths), "params": int(n_params),
        "batch": TRAIN_BATCH, "steps": steps, "optimizer": "Adam(lr=1e-3)",
        "first_step": {"rows": TRAIN_CHECK_ROWS, "loss_card": loss_card,
                       "loss_cpu": loss_cpu,
                       "max_rel_norm_err": max(rel.values()),
                       "max_abs_err": max_abs,
                       "elements_off_by_more_than_lr": flipped,
                       "tolerance": f"||card - cpu|| <= {TRAIN_STEP_RTOL}"
                                    f" ||cpu|| per parameter; loss rtol "
                                    f"{TRAIN_LOSS_RTOL}",
                       "card_s": card_s, "cpu_s": cpu_s},
        "loss_first": losses[0], "loss_last16_mean": late,
        "ms_per_step": ms, "ms_per_step_p90": float(
            np.percentile(step_ms[7:], 90)),
        "samples_per_s": TRAIN_BATCH / ms * 1e3,
        "epoch_s": fit_s, "epoch_samples_per_s": rows / fit_s,
        "flops_per_step": flops,
        "bound_ms": flops / PEAK_F32 * 1e3, "bound_by": "operations",
        "share_of_bound": flops / PEAK_F32 * 1e3 / ms,
        "host_s": host_s,
        "profile_steps": TRAIN_PROFILE_STEPS,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (window_s * 1e3),
        "peak_memory_bytes": peak,
        "seconds": time.perf_counter() - t_start}


def _sgd_loop(config):
    """``tests/test_train.py::_sgd_loop`` (a copy: this script imports no
    test file): each worker's grads on its shard, allreduced."""
    import numpy as np

    from ray_tpu_torch import train as rtrain
    ctx = rtrain.get_context()
    rows = np.asarray(ctx.get_dataset_shard(), dtype=np.float64)
    x, y = rows[:, :-1], rows[:, -1]
    w = np.zeros(x.shape[1])
    lr = config["lr"]
    for _ in range(config["steps"]):
        grad = 2.0 * x.T @ (x @ w - y) / max(len(x), 1)
        grad = ctx.allreduce(grad, op="mean")
        w = w - lr * grad
        loss = float(np.mean((x @ w - y) ** 2))
        rtrain.report({"loss": loss, "rank": ctx.get_world_rank()})
    rtrain.report({"loss": loss, "final": True},
                  checkpoint=rtrain.Checkpoint({"w": w}))


def _live_epoch_loop(config):
    """bench_train.py's live stage loop: an allreduce and a sleep an
    epoch, a checkpoint a report."""
    import time as _time

    import numpy as np

    from ray_tpu_torch import train as rtrain
    ctx = rtrain.get_context()
    ck = rtrain.get_checkpoint()
    start = ck.to_dict()["epoch"] + 1 if ck is not None else 0
    for epoch in range(start, config["last_epoch"] + 1):
        ctx.allreduce({"g": np.ones(64)})
        _time.sleep(config["epoch_s"])
        rtrain.report({"epoch": epoch},
                      checkpoint=rtrain.Checkpoint({"epoch": epoch}))


def _live_fit(head, metrics_port, run_name, kill):
    """One ElasticTrainer run of the live stage; with ``kill`` a gang
    member is SIGKILLed mid-epoch.  While the run is in progress its
    gauges are read from the head's status and from /metrics."""
    import os
    import signal
    import threading

    from ray_tpu_torch.api import _get_runtime
    from ray_tpu_torch.train import (ElasticTrainer, FailureConfig,
                                     ScalingConfig)
    killed = threading.Event()
    seen = {"status": False, "metrics": False}
    done = threading.Event()

    def killer():
        pool = _get_runtime().raylet.pool
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with pool._lock:
                busy = [h for h in pool._workers
                        if not h.dead and h.dedicated]
            if len(busy) >= 2:
                time.sleep(1.0)     # let the gang get into an epoch
                try:
                    os.kill(busy[0].proc.pid, signal.SIGKILL)
                    killed.set()
                except OSError:     # won the race with completion
                    pass
                return
            time.sleep(0.1)

    def watch():
        key = f'ray_tpu_train_epoch{{run="{run_name}"}}'
        while not done.is_set() and not all(seen.values()):
            runs = head._status()["train"].get("runs", [])
            seen["status"] |= any(r.get("run") == run_name and
                                  r.get("state") == "running"
                                  for r in runs)
            seen["metrics"] |= key in _scrape(metrics_port)
            time.sleep(0.05)

    threads = [threading.Thread(target=watch, daemon=True)]
    if kill:
        threads.append(threading.Thread(target=killer, daemon=True))
    for th in threads:
        th.start()
    t = ElasticTrainer(
        _live_epoch_loop,
        train_loop_config={"last_epoch": LIVE_EPOCHS,
                           "epoch_s": LIVE_EPOCH_S},
        scaling_config=ScalingConfig(num_workers=2, min_workers=1),
        failure_config=FailureConfig(max_failures=0), run_name=run_name)
    t0 = time.perf_counter()
    try:
        res = t.fit(timeout=180)
    finally:
        done.set()
        for th in threads:
            th.join(timeout=30)
    wall = time.perf_counter() - t0
    st = t.stats()
    epochs = [r["epoch"] for r in res.history]
    return {"wall_s": wall, "final_epoch": res.metrics["epoch"],
            "gang_losses": st["gang_losses"], "failures": st["failures"],
            "attempts": st["attempts"],
            "epochs_monotone": epochs == sorted(epochs),
            "kill_landed": killed.is_set(),
            "gauges_in_status": seen["status"],
            "gauges_on_metrics": seen["metrics"]}


def train_gangs(head, metrics_port):
    """A 2-worker gang trainer against the serial fit, then the live
    elastic stage: a run with a member SIGKILLed mid-allreduce beside an
    unkilled control."""
    from ray_tpu_torch import data, train
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3))
    y = x @ np.array([2.0, -3.0, 0.5])
    ds = data.from_numpy(np.concatenate([x, y[:, None]], axis=1),
                         parallelism=4)
    t0 = time.perf_counter()
    res = train.TorchTrainer(
        _sgd_loop, train_loop_config={"lr": 0.1, "steps": 40},
        scaling_config=train.ScalingConfig(num_workers=2),
        datasets={"train": ds}).fit()
    gang_s = time.perf_counter() - t0
    w_serial = np.zeros(3)
    for _ in range(40):
        w_serial -= 0.1 * 2.0 * x.T @ (x @ w_serial - y) / len(x)
    err = float(np.abs(res.checkpoint.to_dict()["w"] - w_serial).max())
    if err > 1e-6 or len(res.history) != 41:
        raise AssertionError(f"gang trainer: weights off the serial fit "
                             f"by {err} (tolerance 1e-6), "
                             f"{len(res.history)} reports")
    control = _live_fit(head, metrics_port, "chip-train-control",
                        kill=False)
    chaos = _live_fit(head, metrics_port, "chip-train-sigkill", kill=True)
    gates = {
        "kill_landed": chaos["kill_landed"],
        "completed": chaos["final_epoch"] == LIVE_EPOCHS
        and control["final_epoch"] == LIVE_EPOCHS,
        "gang_loss_typed": chaos["gang_losses"] >= 1,
        "zero_failure_burn": chaos["failures"] == 0,
        "epochs_monotone": chaos["epochs_monotone"],
        "gauges_in_status": chaos["gauges_in_status"]
        and control["gauges_in_status"],
        "gauges_on_metrics": chaos["gauges_on_metrics"]
        and control["gauges_on_metrics"],
    }
    if not all(gates.values()):
        raise AssertionError(f"live elastic stage: {gates}, "
                             f"control {control}, sigkill {chaos}")
    return {"gang": {"workers": 2, "max_abs_err_vs_serial": err,
                     "seconds": gang_s},
            "elastic": {"epochs": LIVE_EPOCHS, "epoch_s": LIVE_EPOCH_S,
                        "control": control, "sigkill": chaos,
                        "reform_s": chaos["wall_s"] - control["wall_s"],
                        "gates": gates}}


def _asha_trainable(config):
    """``tests/test_tune.py::_iterative`` (a copy): SGD on x**2,
    resumable from a checkpoint."""
    from ray_tpu_torch import tune
    ckpt = tune.get_checkpoint()
    state = ckpt.to_dict() if ckpt is not None else {"x": 10.0, "iter": 0}
    x, start = state["x"], state["iter"]
    for i in range(start, config["tune_iterations"]):
        x = x - config["lr"] * 2.0 * x
        tune.report({"loss": x * x, "iteration": i + 1})
    tune.report({"loss": x * x, "iteration": config["tune_iterations"]},
                checkpoint=tune.Checkpoint(
                    {"x": x, "iter": config["tune_iterations"]}))


def train_tune():
    """The reference test's ASHA scenario over 16 trials (its four
    learning rates, four samples each): the best is lr 0.4, run to
    max_t."""
    from ray_tpu_torch import tune
    t0 = time.perf_counter()
    grid = tune.Tuner(
        _asha_trainable,
        param_space={"lr": tune.grid_search([0.001, 0.01, 0.1, 0.4])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=4,
            scheduler=tune.ASHAScheduler(max_t=16, grace_period=2,
                                         reduction_factor=4))).fit()
    wall = time.perf_counter() - t0
    best = grid.get_best_result()
    budgets = sorted(r.metrics.get("iteration", 0) for r in grid)
    if len(grid) != 16 or best.config["lr"] != 0.4 or \
            best.metrics["iteration"] != 16:
        raise AssertionError(f"ASHA: {len(grid)} trials, best "
                             f"{best.config} at {best.metrics}")
    return {"trials": len(grid), "best_lr": best.config["lr"],
            "iterations_by_trial": budgets, "seconds": wall,
            "trials_per_s": len(grid) / wall}


class TwoArmBandit:
    """``tests/test_rllib.py``'s bandit (a copy): arm 1 pays 1.0, arm 0
    pays 0.1; one-step episodes."""

    def reset(self):
        return np.array([1.0], dtype=np.float32)

    def step(self, action):
        reward = 1.0 if action == 1 else 0.1
        return np.array([1.0], dtype=np.float32), reward, True


class Corridor:
    """``tests/test_rllib.py``'s corridor (a copy): walk right to the goal
    at x=4; -0.05 a step, +1 at the goal."""

    def reset(self):
        self.x = 0
        return self._obs()

    def _obs(self):
        return np.array([self.x / 4.0, 1.0], dtype=np.float32)

    def step(self, action):
        self.x += 1 if action == 1 else -1
        self.x = max(self.x, 0)
        if self.x >= 4:
            return self._obs(), 1.0, True
        return self._obs(), -0.05, False


def _bar_bandit(rewards, algo):
    picks = [algo.compute_single_action(np.array([1.0]),
                                        np.random.default_rng(i))
             for i in range(20)]
    return rewards[-1] > 0.9 and sum(picks) >= 18


# (algorithm, config, its keywords, iterations, the reference test's bar)
RL_CASES = {
    "pg_bandit": ("Algorithm", "PGConfig", dict(
        env_creator=TwoArmBandit, obs_dim=1, num_actions=2, num_workers=2,
        episodes_per_worker=16, horizon=1, lr=0.5, seed=0), 15,
        _bar_bandit),
    "pg_corridor": ("Algorithm", "PGConfig", dict(
        env_creator=Corridor, obs_dim=2, num_actions=2, num_workers=2,
        episodes_per_worker=8, horizon=30, lr=0.2, gamma=0.95, seed=1), 20,
        lambda r, a: np.mean(r[-5:]) > np.mean(r[:5])
        and np.mean(r[-5:]) > 0.5),
    "ppo_bandit": ("PPO", "PPOConfig", dict(
        env_creator=TwoArmBandit, obs_dim=1, num_actions=2, num_workers=2,
        episodes_per_worker=16, horizon=1, lr=0.05, minibatch_size=16,
        num_epochs=4, seed=3), 15,
        lambda r, a: r[-1] > 0.9 and a.compute_single_action([1.0]) == 1),
    "ppo_corridor": ("PPO", "PPOConfig", dict(
        env_creator=Corridor, obs_dim=2, num_actions=2, num_workers=2,
        episodes_per_worker=8, horizon=16, lr=0.03, minibatch_size=64,
        num_epochs=4, gae_lambda=0.9, seed=0), 18,
        lambda r, a: np.mean(r[-3:]) > np.mean(r[:3])),
}


def _rl_run(cls, cfg, iters, device):
    """(the params after the first update, rewards, ms an iteration past
    the first, the algorithm's device, the algorithm) of ``iters``
    iterations; the caller stops the algorithm."""
    algo = cls(cfg, device=device)
    rewards, times = [], []
    first = None
    for _ in range(iters):
        t = time.perf_counter()
        rewards.append(algo.train()["episode_reward_mean"])
        times.append(time.perf_counter() - t)
        if first is None:
            first = algo.get_policy_params()
    return first, rewards, float(np.mean(times[1:])) * 1e3, algo


def train_rllib(device):
    """PG and PPO on the reference test's bandit and corridor with the
    driver's update on the card, each to its bar; the first update on
    the card against the CPU's; ms an iteration on each."""
    from ray_tpu_torch import rllib
    out = {}
    for name, (cls, cfg_cls, kw, iters, bar) in RL_CASES.items():
        cls, cfg = getattr(rllib, cls), getattr(rllib, cfg_cls)(**kw)
        first, rewards, ms, algo = _rl_run(cls, cfg, iters, device)
        try:
            on = algo.device.type
            learned = bool(bar(rewards, algo))
        finally:
            algo.stop()
        first_cpu, _r, ms_cpu, algo = _rl_run(cls, cfg, RL_CPU_ITERS,
                                              "cpu")
        algo.stop()
        err = max(float(np.abs(first[k] - first_cpu[k]).max())
                  for k in first)
        if not learned or err > RL_UPDATE_TOL:
            raise AssertionError(f"rllib {name}: rewards {rewards}, first "
                                 f"update off the CPU's by {err} "
                                 f"(tolerance {RL_UPDATE_TOL})")
        out[name] = {"device": on, "iterations": iters,
                     "reward_first": rewards[0], "reward_last": rewards[-1],
                     "first_update_max_abs_err": err,
                     "ms_per_iteration": ms, "cpu_ms_per_iteration": ms_cpu}
    return out


def phase_train(dev, devices=None, rows=TRAIN_ROWS, widths=TRAIN_WIDTHS,
                coll_elems=COLL_ELEMS):
    """The training libraries through the entry points a user calls:
    collectives on every visible card, ``MeshTrainer`` at full width,
    the gang and elastic trainers, tune and rllib, all on one head node
    started in this process (``devices``: the trainer's and the
    collectives' ranks, every card by default)."""
    from ray_tpu_torch.runtime.head import HeadNode
    t_start = time.perf_counter()
    coll = train_collectives(devices, coll_elems)
    metrics_port = _free_port()
    head = HeadNode(resources={"CPU": 8, "memory": 8}, num_workers=8,
                    system_config={
                        "object_store_memory_mb": DATA_STORE_MB,
                        "train_collective_timeout_s": 4.0,
                        "metrics_export_port": metrics_port},
                    xlang_port=None)
    try:
        mesh = train_mesh(dev, devices, rows, widths)
        gangs = train_gangs(head, metrics_port)
        tune_out = train_tune()
        rl = train_rllib(None if devices is None else devices[0])
    finally:
        head.stop()
    result = {"phase": "train", "collectives": coll, "mesh": mesh,
              "gangs": gangs, "tune": tune_out, "rllib": rl,
              "seconds": time.perf_counter() - t_start}
    emit(result)
    return result


# -- phase: shard (the sharded paths on the card's ranks) --------------------

SHARD_BEATS = ((2, "flat"), (4, "two_level"), (8, "flat"))
# the parent's route (the rest of the beat as eager PyTorch around the
# shard_scan kernel; ~8-17 ms a beat): (warm-up, timed) beats of it beside
# the kernels'
SHARD_PLAIN_BEATS = (2, 8)
SHARD_WRAPPER_RANKS = 4
# shard_scan's global route: the contract's 8192 x 16 x 128 on 4 ranks of
# the card (32 CTAs: past one thread-block cluster)
SCAN_GLOBAL_RANKS = 4
RING_SHAPE = (2, 4096, 16, 128)         # the flash cell's headline shape
RING_RANKS = (4, 8)
# tests/test_ring_attention.py's bar, elementwise against full_attention
RING_ATOL = 2e-5


def device_busy(step, n):
    """``torch.profiler`` (CUDA activity only) over ``n`` calls of
    ``step``, read from the raw trace events (a sharded beat launches tens
    of thousands of kernels; ``device_profile``'s per-event objects would
    take minutes): per call, the wall time, the device busy time (the sum
    of kernel and copy durations), the idle share (an upper bound: the
    profiler's overhead is in the wall time), the kernels, and the
    commonest kernels and copies by name (the first 100 characters of a
    name; count and device ms a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ns = kernels = 0
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        busy_ns += e.duration_ns()
        if "Memcpy" not in e.name() and "Memset" not in e.name():
            kernels += 1
        tally = by_name.setdefault(e.name()[:100], [0, 0])
        tally[0] += 1
        tally[1] += e.duration_ns()
    if not busy_ns:
        return {"wall_ms": wall_ms / n, "device_busy_ms": None,
                "idle_share": None, "kernels_per_call": None,
                "top_kernels": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_ms / n, "device_busy_ms": busy_ns / 1e6 / n,
            "idle_share": 1.0 - busy_ns / 1e6 / wall_ms,
            "kernels_per_call": kernels / n,
            "top_kernels": [{"name": k, "per_call": c / n,
                             "ms_per_call": ns / 1e6 / n}
                            for k, (c, ns) in top]}


def scan_kernel_vs_plain(plane, args):
    """``shard_scan`` held to ``shard_scan_plain`` (the scan rank by rank
    over the plane's transport) on one ``_scan`` call's inputs ``args``,
    bit for bit; the kernel's ms (CUDA events around the wrapper: the
    exchange area's memset and the launch; the table of pointers is built
    once), the plain
    version's (host clock around a synchronised call), the bound of the
    water-fill's work at these inputs and the launch.  The comparison's
    launches are taken off ``shard_scan.launches`` again."""
    import torch

    from ray_tpu_torch.ops import shard_reduce as sr

    n0 = sr.shard_scan.launches
    ka, ki, kv = sr.shard_scan(*args)
    pa, pi, pv = sr.shard_scan_plain(plane.transport, *args)
    if not (all(torch.equal(x, y) for x, y in zip(ka, pa))
            and torch.equal(ki, pi)
            and all(torch.equal(x, y) for x, y in zip(kv, pv))):
        raise AssertionError(f"shard_scan disagrees with shard_scan_plain "
                             f"on {len(ka)} ranks")
    layout = dict(sr.shard_scan.last_layout)
    ms = cuda_ms(lambda: sr.shard_scan(*args))
    dev_ms = kernel_device_ms(lambda: sr.shard_scan(*args),
                              "shard_scan_kernel")
    plain = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr.shard_scan_plain(plane.transport, *args)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    sr.shard_scan.launches = n0
    reqs = args[3][0].cpu().numpy()
    n = len(args[0]) * args[0][0].shape[0]
    bound_ms, bound_by = bound(*scan_work(reqs, n,
                                          masks=args[5] is not None),
                               PEAK_I32)
    return {"ranks": len(ka), "rows": n, "classes": int(reqs.shape[0]),
            "group_masks": args[5] is not None, "equal": True, "ms": ms,
            "device_ms": dev_ms, "plain_ms": float(np.median(plain)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "route": layout["route"], "layout": layout}


def kernel_device_ms(fn, name, n=10):
    """Device ms a call of the kernels whose name holds ``name``
    (``device_busy``'s kineto events over ``n`` calls of ``fn``), or None
    where the trace held none."""
    rows = [k for k in device_busy(fn, n)["top_kernels"] or ()
            if name in k["name"]]
    return sum(k["ms_per_call"] for k in rows) if rows else None


def scan_global_route(card, s=SCAN_GLOBAL_RANKS):
    """``shard_scan`` on the global route: the contract's 8192 x 16 x
    128 (group masks, dead and overcommitted rows) on ``s`` ranks of the
    card, held to ``shard_scan_plain`` bit for bit as on the beat's
    inputs; the route must be "global"."""
    import torch

    from ray_tpu_torch.ops import shard_reduce as sr
    from ray_tpu_torch.scheduling.contract import threshold_fp
    totals, avail, mask, reqs, counts, masks = limit_problem()

    def rows(a, axis=0):
        return [torch.as_tensor(np.ascontiguousarray(b), device=card)
                for b in np.split(a, s, axis=axis)]

    args = (rows(totals), rows(avail), rows(mask),
            [torch.as_tensor(reqs, device=card)] * s,
            [torch.as_tensor(counts, device=card)] * s, rows(masks, 1),
            int(threshold_fp(None)), False)
    plane = sr.plane_for(s, "flat", [card] * s)
    out = scan_kernel_vs_plain(plane, args)
    if out["route"] != "global":
        raise AssertionError(f"shard_scan at 8192 x 16 x 128 on {s} ranks "
                             f"took route {out['route']}, not global")
    return out


def waterfill_beside(args):
    """Device ms of the single-device water-fill (``waterfill_scan``) on
    the same scan as ``shard_scan``'s arguments ``args``: every rank's
    rows in rank order on the first rank's device.  Its launches are
    taken off the counter again."""
    import torch

    from ray_tpu_torch.ops import hybrid_kernel as hk
    totals, avail, mask, greqs, gcounts, gmasks, thr, req_av = args
    cat = [torch.cat(list(x)) for x in (totals, avail, mask)]
    gm = None if gmasks is None else torch.cat(list(gmasks), dim=1)
    n0 = hk.waterfill_scan.launches
    try:
        return kernel_device_ms(
            lambda: hk.waterfill_scan(*cat, greqs[0], gcounts[0], gm, thr,
                                      req_av), "waterfill")
    finally:
        hk.waterfill_scan.launches = n0


def shard_beat(ranks, mode, warmup=2, beats=8, churn=12,
               plain_beats=SHARD_PLAIN_BEATS):
    """``make_delta_scheduler(crm, n_shards=S, reduce_mode=mode,
    devices=ranks)`` beside the single-device engine on the same CRM
    journal (the beat cell): every beat's counts and lease budgets equal
    to the single-device engine's and the host twin's, bit for bit.  On
    ranks of one card a delta beat is three kernels (checked): one
    ``beat_rows``, one ``shard_scan`` and one ``beat_tail`` launch, and no
    transport call; ``shard_scan`` and the two beat kernels are held to
    their plain versions on one beat's inputs, and ``plain_beats`` more
    beats run with the rest of the beat on its plain versions (the
    parent's route: eager PyTorch around the ``shard_scan`` kernel),
    timed the same way."""
    import torch

    from ray_tpu_torch.common.resources import ResourceRequest
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import shard_reduce as sr
    from ray_tpu_torch.scheduling import (ShardedDeltaScheduler,
                                          make_delta_scheduler)
    from ray_tpu_torch.scheduling.contract import (compute_budgets,
                                                   threshold_fp)

    s = len(ranks)
    rng, crm, vecs, counts = build_cluster()
    thr = threshold_fp(None)
    churn_req = ResourceRequest({"CPU": 1})
    debts: list[int] = []

    def mutate():
        for _ in range(churn):
            if debts and rng.random() < 0.5:
                crm.add_back(debts.pop(), churn_req)
            else:
                row = int(rng.integers(0, N_NODES))
                crm.force_subtract(row, churn_req)
                debts.append(row)

    kind = torch.device(ranks[0]).type
    eng = make_delta_scheduler(crm, n_shards=s, reduce_mode=mode,
                               devices=ranks)
    single = make_delta_scheduler(crm, device=kind)
    if not isinstance(eng, ShardedDeltaScheduler) or \
            eng.stats["shards"] != s or eng.device.type != kind:
        raise AssertionError(f"make_delta_scheduler gave {type(eng)} on "
                             f"{eng.device} for {s} ranks")
    plane = eng._plane
    tp = plane.transport
    one_card = len(set(plane.ranks)) == 1

    def counters():
        return (tp.calls, sr.shard_scan.launches, hk.beat_rows.launches,
                hk.beat_tail.launches)

    def run(n_warm, n_timed, label):
        times, per_beat = [], []
        for i in range(n_warm + n_timed):
            mutate()
            c0 = counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = eng.beat(vecs, counts)
            dt = (time.perf_counter() - t0) * 1e3
            if i >= n_warm:
                times.append(dt)
                per_beat.append([b - a for a, b in zip(c0, counters())])
            one = single.beat(vecs, counts)
            st = crm.snapshot()
            want, post = host_twin(st.totals, st.avail, st.node_mask, vecs,
                                   counts, None, thr)
            budgets = np.stack([eng.budget_row_host(v) for v in vecs])
            want_b = compute_budgets(st.totals, post, vecs, st.node_mask)
            if not (np.array_equal(got, one) and np.array_equal(got, want)
                    and np.array_equal(eng.last_budgets(),
                                       single.last_budgets())
                    and np.array_equal(budgets, want_b)):
                raise AssertionError(
                    f"sharded beat {i} ({s} ranks, {mode}, {label}) "
                    "disagrees with the single-device engine or the host "
                    "twin")
        per_beat = np.asarray(per_beat, float).mean(axis=0)
        return {"beat_p50_ms": float(np.percentile(times, 50)),
                "beat_p80_ms": float(np.percentile(times, 80)),
                "beat_p99_ms": float(np.percentile(times, 99)),
                "transport_calls_per_beat": float(per_beat[0]),
                "shard_scan_launches_per_beat": float(per_beat[1]),
                "beat_rows_launches_per_beat": float(per_beat[2]),
                "beat_tail_launches_per_beat": float(per_beat[3]),
                "timed_beats": n_timed, "bit_exact_beats": n_warm + n_timed}

    def step():
        mutate()
        eng.beat(vecs, counts)

    # --- the main path: the launch counts are 0 just before, read after
    # (the beat kernels' as the sharded engine counts its own: the
    # single-device engine beside it launches them too)
    sr.shard_scan.launches = 0
    hk.beat_rows.launches = hk.beat_tail.launches = 0
    st0 = dict(eng.scan_stats)
    main = run(warmup, beats, "main path")
    launches = sr.shard_scan.launches
    beat_launches = {k: eng.scan_stats[f"{k}_launches"] - st0[f"{k}_launches"]
                     for k in ("beat_rows", "beat_tail")}
    # --- end of the main path ---
    want_route = "shard_scan" if one_card else "nccl"
    n_main = warmup + beats
    if eng.scan_stats["route"] != want_route or \
            launches != (n_main if one_card else 0):
        raise AssertionError(f"{s} ranks ({mode}): the scan took route "
                             f"{eng.scan_stats['route']} with {launches} "
                             f"shard_scan launches in {n_main} beats")
    trace = device_busy(step, 2)
    main.update({"kernels_per_beat": trace["kernels_per_call"],
                 "idle_share": trace["idle_share"],
                 "device_busy_ms_per_beat": trace["device_busy_ms"],
                 "top_kernels": trace["top_kernels"]})
    if one_card and not (
            main["transport_calls_per_beat"] == 0
            and main["beat_rows_launches_per_beat"] == 1
            and main["beat_tail_launches_per_beat"] == 1
            and beat_launches["beat_tail"] == n_main
            and trace["kernels_per_call"] is not None
            and trace["kernels_per_call"] <= 3):
        raise AssertionError(f"{s} ranks of one card ({mode}): a delta beat "
                             f"is not three kernels and no transport call: "
                             f"{main}, {beat_launches}")
    out = {"ranks": [str(d) for d in ranks], "reduce_mode": mode,
           "grid": list(plane.mesh.devices.shape),
           "transport": "nccl" if tp.nccl else "one device",
           "scan_route": eng.scan_stats["route"],
           "shard_scan_launches": launches,
           "beat_kernel_launches": beat_launches, "shard_scan": main}
    if one_card:
        captured = {}

        def capture(*args):
            captured["args"] = args[:8]
            return type(plane)._scan(plane, *args)

        plane._scan = capture
        try:
            step()
        finally:
            del plane._scan
        out["kernel_vs_plain"] = scan_kernel_vs_plain(plane,
                                                      captured["args"])
        if out["kernel_vs_plain"]["route"] != "cluster":
            raise AssertionError(f"{s} ranks ({mode}): shard_scan took route "
                                 f"{out['kernel_vs_plain']['route']} on the "
                                 f"beat cell, not cluster")
        out["beat_kernels"] = beat_kernels_vs_plain(
            step, lambda: make_delta_scheduler(crm, n_shards=s,
                                               reduce_mode=mode,
                                               devices=ranks),
            vecs, counts, fresh_classes(crm))
        out["device_ms"] = {
            "shard_scan": out["kernel_vs_plain"]["device_ms"],
            "beat_tail": out["beat_kernels"]["beat_tail"]["device_ms"],
            "waterfill_scan": waterfill_beside(captured["args"])}
        # the parent's route: the same beats with the rest of the beat on
        # its plain versions around the shard_scan kernel
        real = hk.beat_rows, hk.beat_tail
        hk.beat_rows, hk.beat_tail = _plain_beat_kernels()
        try:
            parent = run(*plain_beats, "the parent's route")
            ptrace = device_busy(step, 2)
        finally:
            hk.beat_rows, hk.beat_tail = real
        parent.update({"kernels_per_beat": ptrace["kernels_per_call"],
                       "idle_share": ptrace["idle_share"],
                       "device_busy_ms_per_beat": ptrace["device_busy_ms"]})
        out["parent_route"] = parent
    # the beat's work at these inputs, as the single-device beat does it:
    # the water-fill over the classes and the rest of a delta beat
    scan_b, scan_o = scan_work(vecs, N_NODES, masks=False)
    rest_b, rest_o = beat_rest_work(*vecs.shape, N_NODES, churn)
    bound_ms, bound_by = bound(scan_b + rest_b, scan_o + rest_o, PEAK_I32)
    # every beat above: the main path's, the two traced, and on one card
    # the two captured ones, the parent's and its two traced
    n_beats = n_main + 2 + (4 + sum(plain_beats) if one_card else 0)
    if eng.readbacks != n_beats:
        raise AssertionError(f"{eng.readbacks} readbacks in {n_beats} "
                             "sharded beats")
    out.update({"beats": n_beats, "bound_ms": bound_ms, "bound_by": bound_by,
                "stats": eng.stats, "scan_stats": eng.scan_stats})
    return out


def autoscale_work(problem, fit_counts):
    """(bytes, int32 operations) of ``autoscale`` on ``problem``: the
    first-fit water-fill and the launch loop for the iterations its
    plain version runs on the CPU over the first fit's leftovers."""
    import torch

    from ray_tpu_torch.ops import binpack_kernel as bk
    totals, _, _, reqs, _, caps, quotas = problem
    g, r = reqs.shape
    k = caps.shape[0]
    remaining = np.where((reqs > 0).any(axis=1), fit_counts[:, -1], 0)
    _, _, iters = bk.launch_loop_plain(
        *(torch.as_tensor(np.ascontiguousarray(a, np.int32))
          for a in (caps, quotas, reqs, remaining)), g * k + g + k + 2)
    scan_b, scan_o = scan_work(reqs, totals.shape[0], masks=False)
    loop_b, loop_o = loop_work(k, g, r, int(iters))
    return scan_b + loop_b, scan_o + loop_o


def shard_wrappers(dev, ranks):
    """The four ``*_sharded_np`` wrappers at the beat width on ``ranks``,
    each equal to the single-device call bit for bit; ms (host clock
    around a synchronised call), kernel launches a call, and the bound
    of the single-device function's work at these inputs."""
    import torch

    from ray_tpu_torch.ops import binpack_kernel as bk
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import locality_kernel as lk
    from ray_tpu_torch.ops import shard_reduce as sr

    s = len(ranks)
    totals, avail, mask, reqs, counts = build_problem()
    # per-class group masks: the kernel's column blocks of them per rank
    gmasks = np.random.default_rng(9).random(
        (reqs.shape[0], totals.shape[0])) > 0.1
    ltotals, lavail, lmask, lmasks, prefs = with_prefs(
        5, totals, avail, mask, reqs, None)
    ttotals, tavail, tmask, treqs, tcounts = build_problem(seed=3)
    auto = autoscale_problem()
    work = {
        "schedule_grouped_sharded_np": scan_work(reqs, totals.shape[0]),
        "schedule_grouped_localized_sharded_np": scan_work(
            reqs, ltotals.shape[0], prefs=True),
        "schedule_grouped_topk_sharded_np": topk_work(
            ttotals.shape[0], treqs)}
    cases = {
        "schedule_grouped_sharded_np": (
            lambda: hk.schedule_grouped_np(totals, avail, mask, reqs,
                                           counts, gmasks, device=dev),
            lambda: hk.schedule_grouped_sharded_np(
                totals, avail, mask, reqs, counts, gmasks, n_shards=s,
                devices=ranks)),
        "schedule_grouped_localized_sharded_np": (
            lambda: lk.schedule_grouped_localized_np(
                ltotals, lavail, lmask, reqs, counts, prefs, lmasks,
                device=dev),
            lambda: lk.schedule_grouped_localized_sharded_np(
                ltotals, lavail, lmask, reqs, counts, prefs, lmasks,
                n_shards=s, devices=ranks)),
        "schedule_grouped_topk_sharded_np": (
            lambda: lk.schedule_grouped_topk_np(
                ttotals, tavail, tmask, treqs, tcounts, 7, 1, k_frac=0.25,
                device=dev),
            lambda: lk.schedule_grouped_topk_sharded_np(
                ttotals, tavail, tmask, treqs, tcounts, 7, 1, k_frac=0.25,
                n_shards=s, devices=ranks)),
        "autoscale_sharded_np": (
            lambda: bk.autoscale_np(*auto, device=dev),
            lambda: bk.autoscale_sharded_np(*auto, n_shards=s,
                                            devices=ranks)),
    }
    out = {}
    for name, (single, sharded) in cases.items():
        want = single()
        # the sharded call: counts set to 0 just before, read just after
        hk.waterfill_scan.launches = hk.waterfill_scan.localized_launches = 0
        bk.binpack_launch_loop.launches = 0
        lk.schedule_grouped_topk.launches = 0
        sr.shard_scan.launches = 0
        got = sharded()
        wf = hk.waterfill_scan.launches + hk.waterfill_scan.localized_launches
        bp = bk.binpack_launch_loop.launches
        tk = lk.schedule_grouped_topk.launches
        ss = sr.shard_scan.launches
        if len(got) != len(want) or \
                not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} on {s} ranks disagrees with the "
                                 "single-device call")
        check = None
        if name == "schedule_grouped_sharded_np":
            if ss != 1:
                raise AssertionError(f"{name}: {ss} shard_scan launches")
            # the kernel against the plain version on this call's scan
            # inputs (the group masks' column blocks among them)
            plane = sr.gspmd_plane(s, "auto", ranks)
            captured = {}

            def capture(*args):
                captured["args"] = args
                return type(plane)._scan(plane, *args)

            plane._scan = capture
            try:
                sharded()
            finally:
                del plane._scan
            check = scan_kernel_vs_plain(plane, captured["args"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        single()
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        if name == "autoscale_sharded_np":
            work[name] = autoscale_work(auto, want[1])
        bound_ms, bound_by = bound(*work[name], PEAK_I32)
        out[name] = {"ms": ms, "single_device_ms": single_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "kernels_per_call": kernel_launches(sharded),
                     "waterfill_scan_launches": wf,
                     "binpack_launch_loop_launches": bp,
                     "schedule_grouped_topk_launches": tk,
                     "shard_scan_launches": ss}
        if check is not None:
            out[name]["kernel_vs_plain"] = check
    return out


def ring_skip_last_fold(q, k, v, ranks, causal):
    """``ring_attention`` with its last fold left out: what a ring that
    stopped one block short would return."""
    import importlib
    ra = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    fold = ra._fold
    world = len(ranks)

    def short(s, my, w, q_, k_, v_, acc, denom, m, c):
        if s == world - 1:
            return acc, denom, m
        return fold(s, my, w, q_, k_, v_, acc, denom, m, c)

    ra._fold = short
    try:
        return ra.ring_attention(q, k, v, mesh=ranks, causal=causal,
                                 precision="highest")
    finally:
        ra._fold = fold


def shard_attention(dev, rank_sets):
    """Ring and Ulysses attention at B=2 T=4096 H=16 D=128 float32 on
    each rank set, causal and not: within RING_ATOL of ``full_attention``
    on the card, a limit that must reject the ring missing its last
    fold; ms beside ``ops.flash_attention``'s f32 time and SDPA's."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch import ops

    b, t, h, d = RING_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev)
               for _ in range(3))
    out = {}
    for causal in (False, True):
        want = ops.full_attention(q, k, v, causal=causal, precision="highest")
        full_ms = cuda_ms(lambda: ops.full_attention(
            q, k, v, causal=causal, precision="highest"), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=3, warmup=1)
        flash_ms = cuda_ms(lambda: ops.flash_attention(q, k, v,
                                                       causal=causal),
                           reps=3, warmup=1)
        # operations: QK^T and PV, 2 flops a multiply-add, half causal
        n_ops = 4.0 * b * h * t * t * d * (0.5 if causal else 1.0)
        bound_ms, bound_by = bound(4 * b * t * h * d * 4, n_ops, PEAK_F32)
        case = {"full_attention_ms": full_ms, "sdpa_ms": sdpa_ms,
                "sdpa_backend": sdpa_backend(qt, kt, vt, causal),
                "flash_attention_f32_ms": flash_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
        for ranks in rank_sets:
            tag = f"{len(ranks)}x{ranks[0]}" if len(set(ranks)) == 1 \
                else f"{len(ranks)} cards"
            for name in ("ring_attention", "ulysses_attention"):
                fn = getattr(ops, name)
                got = fn(q, k, v, mesh=ranks, causal=causal,
                         precision="highest")
                err = float((got - want).abs().max())
                if not err <= RING_ATOL:
                    raise AssertionError(f"{name} on {tag}, causal={causal}"
                                         f": max |err| {err} > {RING_ATOL}")
                ms = cuda_ms(lambda: fn(q, k, v, mesh=ranks, causal=causal,
                                        precision="highest"),
                             reps=3, warmup=1)
                case[f"{name} {tag}"] = {"max_abs_err": err, "ms": ms}
            short = ring_skip_last_fold(q, k, v, ranks, causal)
            short_err = float((short - want).abs().max())
            if short_err <= RING_ATOL:
                raise AssertionError(f"the limit {RING_ATOL} does not reject "
                                     f"a ring missing its last fold "
                                     f"({short_err})")
            case[f"ring missing its last fold {tag}"] = short_err
        out["causal" if causal else "full"] = case
        del want
    return out


def shard_key(s, mode):
    return f"{s} ranks of one card {mode}"


# the sharded beat whose numbers head the kernels line
SHARD_HEAD = shard_key(4, "two_level")


def phase_shard(dev, smi):
    """The sharded paths on ranks of the card (``["cuda:0"] * S``): the
    sharded beat at the beat cell's width, the four sharded wrappers,
    ring and Ulysses attention, ``entry()`` and ``dryrun_multichip``; over
    distinct cards through NCCL when there are two or more."""
    import torch

    from ray_tpu_torch import entry
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling.contract import threshold_fp

    t_start = time.perf_counter()
    card = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" \
        else str(dev)
    beats = {shard_key(s, mode): shard_beat([card] * s, mode)
             for s, mode in SHARD_BEATS}
    wrappers = shard_wrappers(dev, [card] * SHARD_WRAPPER_RANKS)
    scan_global = scan_global_route(card) if dev.type == "cuda" else None
    rank_sets = [[card] * s for s in RING_RANKS]
    n_cards = torch.cuda.device_count()
    cards = [f"cuda:{i}" for i in range(4 if n_cards >= 4 else 2)] \
        if n_cards >= 2 else None
    if cards:
        beats[f"{len(cards)} cards"] = shard_beat(
            cards, "two_level" if len(cards) == 4 else "flat")
        rank_sets.append(cards)
    attention = shard_attention(dev, rank_sets)

    fn, args = entry.entry(dev)
    # --- the entry point's step: counts start at 0 here and are read after
    hk.waterfill_scan.launches = hk.waterfill_scan.localized_launches = 0
    counts, new_avail = fn(*args)
    torch.cuda.synchronize()
    entry_launches = hk.waterfill_scan.launches
    # --- end of the step ---
    if entry_launches != 1:
        raise AssertionError(f"entry()'s step launched waterfill_scan "
                             f"{entry_launches} times")
    host = [a.cpu().numpy() for a in args[:-1]]
    want, post = host_twin(*host, thr=threshold_fp(0.5))
    if not (np.array_equal(counts.cpu().numpy(), want)
            and np.array_equal(new_avail.cpu().numpy(), post)):
        raise AssertionError("entry(): the step disagrees with the host "
                             "twin")
    dryruns = {n: entry.dryrun_multichip(n, device=card) for n in (4, 8)}
    result = {"phase": "shard", "nvidia_smi": smi, "beats": beats,
              "wrappers": wrappers, "attention": attention,
              # shard_scan's route and layout on each of its calls here
              "scan_routes": {
                  **{k: b["kernel_vs_plain"]["layout"]
                     for k, b in beats.items() if "kernel_vs_plain" in b},
                  "schedule_grouped_sharded_np": wrappers[
                      "schedule_grouped_sharded_np"]["kernel_vs_plain"][
                      "layout"],
                  "limit 8192x16x128 global": scan_global and
                  scan_global["layout"]},
              "scan_global_route": scan_global,
              "entry": {"counts_equal_host_twin": True,
                        "shape": list(counts.shape)},
              "dryrun_multichip": dryruns,
              "nccl_route": "ran over " + ", ".join(cards) if cards else
              "not run: one card (ranks on one card only)",
              # launches of the sharded calls and the entry step (not of
              # the single-device calls they are compared with)
              "waterfill_scan_launches": entry_launches + sum(
                  w["waterfill_scan_launches"] for w in wrappers.values()),
              "binpack_launch_loop_launches": sum(
                  w["binpack_launch_loop_launches"]
                  for w in wrappers.values()),
              "schedule_grouped_topk_launches": sum(
                  w["schedule_grouped_topk_launches"]
                  for w in wrappers.values()),
              # the main path's shard_scan launches: the sharded beats' and
              # the wrapper's (not the comparisons with the plain version)
              "shard_scan_launches": {
                  **{k: b["shard_scan_launches"] for k, b in beats.items()},
                  "schedule_grouped_sharded_np": sum(
                      w["shard_scan_launches"] for w in wrappers.values())},
              # the sharded beats' main-path launches of the beat's two
              # other kernels
              "beat_kernel_launches": {k: b["beat_kernel_launches"]
                                       for k, b in beats.items()},
              "seconds": time.perf_counter() - t_start}
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
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    lint = start_lint()
    try:
        timed("build", phase_build)
    except BaseException:
        lint.kill()
        lint.wait()
        raise
    timed("lint", phase_lint, lint)
    wf = timed("waterfill", phase_waterfill, dev)
    beat = timed("beat", phase_beat, dev)
    # the sharded beats right after the single-device one: late in a run,
    # after the runtime's phases, the profiler's sessions around beats of
    # ctypes-launched kernels alone have come back without device events
    shd = timed("shard", phase_shard, dev, smi)
    loc = timed("locality", phase_locality, dev)
    run = timed("runtime", phase_runtime, dev)
    srv = timed("serve", phase_serve, dev, run["tasks_per_s"])
    dp = timed("dataplane", phase_dataplane, dev)
    bcast = timed("broadcast", phase_broadcast, dev)
    asc = timed("autoscaler", phase_autoscaler, dev)
    tk = timed("topk", phase_topk, dev)
    dmn = timed("daemon", phase_daemon, dev)
    fl = timed("flash_attention", phase_flash, dev)
    timed("data", phase_data, dev)
    timed("sim", phase_sim)
    timed("train", phase_train, dev)
    head = fl["cases"][0]
    wide = next(r for r in fl["cases"] if r["dtype"] == "bfloat16" and
                r["causal"] and r["shape"] == list(FLASH_WIDE_PATHS[0]))
    f32 = next(r for r in fl["cases"] if r["dtype"] == "float32" and
               r["causal"] and r["shape"] == [2, 4096, 16, 128])
    # the two-pass pairs' numbers: the full-card D=576 rows, causal; the
    # other rows of each beside them
    pair16, pair32 = (next(r for r in fl["cases"] if r["dtype"] == dtype and
                           r["causal"] and
                           r["shape"] == list(FLASH_WIDE_PATHS[-1]))
                      for dtype in ("bfloat16", "float32"))
    pair_rows = {dtype: [{k: r[k] for k in (
        "shape", "causal", "kernel_ms", "plain_ms", "library_ms",
        "library_backend", "bound_ms", "bound_share", "max_abs_err",
        "max_err_over_limit", "scratch_bytes")} for r in fl["cases"]
        if r["dtype"] == dtype and r["shape"][3] > FLASH_REACH]
        for dtype in ("bfloat16", "float32")}
    pair_head_dims = {dtype: [{k: r[k] for k in (
        "d", "causal", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_share", "max_abs_err", "max_err_over_limit")}
        for r in fl["head_dims"]["cases"]
        if r["dtype"] == dtype and r["d"] > FLASH_REACH]
        for dtype in ("bfloat16", "float32")}
    lw = loc["problems"]["beat 1000x8x64"]
    shard_launches = shd["shard_scan_launches"]
    shard_checks = {k: b["kernel_vs_plain"] for k, b in shd["beats"].items()
                    if "kernel_vs_plain" in b}
    shard_checks["schedule_grouped_sharded_np"] = \
        shd["wrappers"]["schedule_grouped_sharded_np"]["kernel_vs_plain"]
    shard_head = shard_checks[SHARD_HEAD]
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
                              "serve": srv["launches"]["waterfill_scan"],
                              "beat": beat["waterfill_launches"],
                              "autoscaler": asc["main_path_launches"][
                                  "waterfill_scan"],
                              "daemon_head": dmn["head_launches"].get(
                                  "waterfill_scan", 0),
                              "shard": shd["waterfill_scan_launches"]},
         # the autoscaler's phase 1: the same kernel in first-fit mode
         "first_fit_ms": asc["scan_ms"],
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
        {"name": "binpack_launch_loop", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/binpack.cu",
         "replaces": "ray_tpu/ops/binpack_kernel.py:53 (_launch_loop "
                     "lax.while_loop; _pack_all_types lax.scan :33)",
         # launches on the autoscaler's path (StandardAutoscaler.update)
         "launches": asc["main_path_launches"]["binpack_launch_loop"],
         "launches_by_path": {
             "autoscaler": asc["main_path_launches"]["binpack_launch_loop"],
             "shard": shd["binpack_launch_loop_launches"]},
         "max_abs_err": 0, "ms": asc["kernel_ms"],
         "plain_ms": asc["plain_ms"], "bound_ms": asc["bound_ms"],
         "bound_by": asc["bound_by"], "library_ms": None,
         "iterations": asc["iterations"], "class_steps": asc["class_steps"],
         "ns_per_class_step": asc["ns_per_class_step"],
         "chain_steps": asc["chain_steps"],
         "ns_per_chain_step": asc["ns_per_chain_step"], "checked": True,
         # and against the plain version on the main path's own tensors
         "checked_on_main_path": asc["main_path"]["loop_vs_plain"]},
        {"name": "schedule_grouped_topk", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/topk.cu",
         "replaces": "ray_tpu/ops/locality_kernel.py:79 "
                     "(schedule_grouped_topk lax.scan :131)",
         # launches on the top-k burst's path (the raylet's top-k rounds)
         "launches": tk["burst_launches"],
         "launches_by_path": {"topk_burst": tk["burst_launches"],
                              "shard": shd["schedule_grouped_topk_launches"]},
         "max_abs_err": 0, "ms": tk["ms"], "plain_ms": tk["plain_ms"],
         "cpu_ms": tk["cpu_ms"], "bound_ms": tk["bound_ms"],
         "bound_by": tk["bound_by"], "library_ms": None,
         "limit_ms": tk["cases"]["limit 8192x16x128"]["kernel_ms"],
         "ns_a_class": tk["ns_a_class"], "layout": tk["layout"],
         "limit_ns_a_class": tk["cases"]["limit 8192x16x128"]["ns_a_class"],
         "limit_layout": tk["cases"]["limit 8192x16x128"]["layout"],
         "checked": True},
        {"name": "schedule_bundle_groups", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/bundle.cu",
         "replaces": "ray_tpu/ops/bundle_kernel.py:89 "
                     "(schedule_bundle_groups lax.scan :117; _place_soft "
                     ":47, _place_strict_pack :77)",
         # launches on the runtime path's placement-group batch
         "launches": run["launches"]["schedule_bundle_groups"],
         "launches_by_path": {
             "runtime": run["launches"]["schedule_bundle_groups"]},
         "max_abs_err": 0, "ms": dp["bundles"]["kernel_ms"],
         "plain_ms": dp["bundles"]["plain_ms"],
         "oracle_ms": dp["bundles"]["oracle_ms"],
         "bound_ms": dp["bundles"]["bound_ms"],
         "bound_by": dp["bundles"]["bound_by"], "library_ms": None,
         "checked": True},
        {"name": "choose_sources", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/pull.cu",
         "replaces": "ray_tpu/ops/pull_kernel.py:45 "
                     "(choose_sources lax.fori_loop :79)",
         # launches on the runtime path's pull activation batch
         "launches": run["launches"]["choose_sources"],
         "launches_by_path": {"runtime": run["launches"]["choose_sources"]},
         "max_abs_err": 0, "ms": dp["pulls"]["kernel_ms"],
         "plain_ms": dp["pulls"]["plain_ms"],
         "oracle_ms": dp["pulls"]["oracle_ms"],
         "bound_ms": dp["pulls"]["bound_ms"],
         "bound_by": dp["pulls"]["bound_by"], "library_ms": None,
         "checked": True},
        {"name": "plan_fanout (broadcast)", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/broadcast.cu",
         "replaces": "ray_tpu/ops/broadcast_kernel.py:48 "
                     "(plan_fanout lax.fori_loop :87)",
         # launches on the broadcast path (BroadcastManager.broadcast)
         "launches": bcast["launches"],
         "launches_by_path": {"broadcast": bcast["launches"]},
         "max_abs_err": 0, "ms": dp["broadcast"]["kernel_ms"],
         "plain_ms": dp["broadcast"]["plain_ms"],
         "oracle_ms": dp["broadcast"]["oracle_ms"],
         # the least time for what the function needs on these inputs;
         # beside it the JAX program's N^3 work, as earlier rows counted
         "bound_ms": dp["broadcast"]["bound_ms"],
         "bound_by": dp["broadcast"]["bound_by"],
         "jax_program_bound_ms": dp["broadcast"]["jax_program_bound_ms"],
         "library_ms": None,
         "limit_ms": dp[f"broadcast_{DP_LIMIT_NODES}"]["kernel_ms"],
         "uniform_ms": dp["broadcast_uniform"]["kernel_ms"],
         "ns_an_attach": dp["broadcast"]["ns_an_attach"],
         "layout": dp["broadcast"]["layout"],
         "limit_ns_an_attach":
             dp[f"broadcast_{DP_LIMIT_NODES}"]["ns_an_attach"],
         "uniform_ns_an_attach": dp["broadcast_uniform"]["ns_an_attach"],
         "entry_path_layout": bcast["layout"],
         "checked": True},
        {"name": "shard_scan", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/shard_scan.cu",
         "replaces": "ray_tpu/ops/shard_reduce.py:180-252 "
                     "(_schedule_group_sharded) and :410-419 (fused_beat's "
                     "class scan; _psum2/_pmin2 :98-110)",
         # launches on the sharded beat's path (S=4 two-level ranks of the
         # card), the other paths beside it; the numbers are that beat's
         # scan inputs', the other meshes' and the wrapper's beside them.
         # max_abs_err 0: the phase raises unless bit-exact
         "launches": shard_launches[SHARD_HEAD],
         "launches_by_path": shard_launches,
         "max_abs_err": 0, "ms": shard_head["ms"],
         "plain_ms": shard_head["plain_ms"],
         "bound_ms": shard_head["bound_ms"],
         "bound_by": shard_head["bound_by"], "library_ms": None,
         "layout": shard_head["layout"], "route": shard_head["route"],
         "device_ms": shard_head["device_ms"],
         "by_path": {k: {f: v[f] for f in ("ms", "device_ms", "plain_ms",
                                           "bound_ms", "route", "layout")}
                     for k, v in shard_checks.items()},
         # the global route (past one cluster), on its own check
         "global_route": {f: shd["scan_global_route"][f] for f in (
             "ranks", "rows", "ms", "device_ms", "plain_ms", "bound_ms",
             "route", "layout")},
         "waterfill_device_ms_beside": {
             k: b["device_ms"] for k, b in shd["beats"].items()
             if "device_ms" in b},
         "checked": True},
        *[{"name": name, "route": "cuda",
           "source": "ray_tpu_torch/ops/csrc/beat.cu",
           "replaces": replaces,
           # launches on the beat path (make_delta_scheduler(crm).beat),
           # the other paths beside it (the sharded beats': every mesh of
           # the card's ranks); the numbers are the beat cell's, the
           # sharded beats' beside them.  max_abs_err 0: the phases raise
           # unless bit-exact
           "launches": beat["beat_kernel_launches"][name],
           "launches_by_path": {
               "beat": beat["beat_kernel_launches"][name],
               "runtime": run["launches"][name],
               "serve": srv["launches"][name],
               "daemon_head": dmn["head_launches"].get(name, 0),
               "shard": sum(b[name] for b in
                            shd["beat_kernel_launches"].values())},
           "max_abs_err": 0, "ms": beat["kernels"][name]["ms"],
           "plain_ms": beat["kernels"][name]["plain_ms"],
           "bound_ms": beat["kernels"][name]["bound_ms"],
           "bound_by": beat["kernels"][name]["bound_by"],
           "library_ms": None, "layout": beat["kernels"][name]["layout"],
           "device_ms": beat["kernels"][name].get("device_ms"),
           "host_ms": beat["kernels"][name]["host_ms"],
           # beat_rows: the beat call's numbers above; every call (the
           # beat, the class install, the full rescore) here
           "calls": beat["kernels"][name].get("beat_rows_calls"),
           "by_path": {k: {f: b["beat_kernels"][name].get(f) for f in (
               "ms", "device_ms", "plain_ms", "bound_ms", "host_ms",
               "beat_rows_calls")}
               for k, b in shd["beats"].items() if "beat_kernels" in b},
           "checked": True}
          for name, replaces in (
              ("beat_rows",
               "ray_tpu/ops/hybrid_kernel.py:348 (apply_dirty_rows), :363 "
               "(apply_dirty_classes), :318 (full_rescore), :399-401 "
               "(fused_beat's overrides, mask, gather); ray_tpu/ops/"
               "shard_reduce.py:290, :311, :350 (ShardPlane's)"),
              ("beat_tail",
               "ray_tpu/ops/hybrid_kernel.py:415-427 (fused_beat's "
               "budgets, packing, argmin); ray_tpu/ops/shard_reduce.py:"
               "378-469 (ShardPlane.fused_beat's budgets, pmin2, "
               "gathers)"))],
        {"name": "flash_attention", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:25",
         "launches": fl["main_path_launches"],
         "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
         "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "library_ms": head["library_ms"],
         "checked": True},
        {"name": "flash_attention (16-bit, D 256-512)", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:25",
         # flash_big16_kernel: launches on the D=256 path, the D=512 path
         # beside it; the numbers are the bf16 causal D=256 row's
         "launches": fl["wide_path_launches"][FLASH_WIDE_PATHS[0][3]],
         "launches_by_path": {f"d{d}": n for d, n in
                              fl["wide_path_launches"].items() if d <= 512},
         "max_abs_err": wide["max_abs_err"], "ms": wide["kernel_ms"],
         "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
         "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
         "checked": True},
        {"name": "flash_attention (f32, D 64-512)", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:25",
         # flash_tf32_kernel: launches on the f32 path; the numbers are
         # the f32 causal D=128 full-card row's; the bound is three TF32
         # products, the FMA bound of PRs 3-12 beside it
         "launches": fl["f32_path_launches"],
         "max_abs_err": f32["max_abs_err"], "ms": f32["kernel_ms"],
         "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
         "bound_by": f32["bound_by"], "bound_of": f32["bound_of"],
         "fma_bound_ms": f32["fma_bound_ms"],
         "library_ms": f32["library_ms"], "checked": True},
        {"name": "flash_attention (16-bit, D past 512)", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:25",
         # the 16-bit two-pass pair (flash_scores16_kernel, then
         # flash_values16_kernel, once a chunk of scratch): launches of the
         # entry point on the bf16 D=576 full-card path, the D=1088 path
         # beside it, and the kernel launches each call made; the numbers
         # are the bf16 causal D=576 full-card row's, the pair's other rows
         # beside them
         "kernels": FLASH_TWOPASS16.split("+"),
         "launches": fl["twopass_path_launches"]["bf16_d576"],
         "launches_by_path": {k: n for k, n in
                              fl["twopass_path_launches"].items()
                              if k.startswith("bf16")},
         "kernel_launches_a_call": {k: n for k, n in
                                    fl["twopass_kernel_launches"].items()
                                    if k.startswith("bf16")},
         "max_abs_err": pair16["max_abs_err"], "ms": pair16["kernel_ms"],
         "plain_ms": pair16["plain_ms"], "bound_ms": pair16["bound_ms"],
         "bound_by": pair16["bound_by"], "library_ms": pair16["library_ms"],
         "library_backend": pair16["library_backend"],
         "scratch_bytes": pair16["scratch_bytes"],
         "full_card": pair_rows["bfloat16"],
         "head_dims": pair_head_dims["bfloat16"],
         "checked": True},
        {"name": "flash_attention (f32, D past 512)", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:25",
         # the f32 two-pass pair (flash_scores32_kernel, then
         # flash_values32_kernel, once a chunk of scratch): launches of the
         # entry point on the f32 D=576 full-card path, the D=1600 and
         # full-card D=2048 paths beside it, and the kernel launches each
         # call made (counted by the library at each launch); the numbers
         # are the f32 causal D=576 full-card row's, the bound three TF32
         # products, the pair's other rows beside them
         "kernels": FLASH_TWOPASS32.split("+"),
         "launches": fl["twopass_path_launches"]["f32_d576"],
         "launches_by_path": {k: n for k, n in
                              fl["twopass_path_launches"].items()
                              if k.startswith("f32")},
         "kernel_launches_a_call": {k: n for k, n in
                                    fl["twopass_kernel_launches"].items()
                                    if k.startswith("f32")},
         "max_abs_err": pair32["max_abs_err"], "ms": pair32["kernel_ms"],
         "plain_ms": pair32["plain_ms"], "bound_ms": pair32["bound_ms"],
         "bound_by": pair32["bound_by"], "bound_of": pair32["bound_of"],
         "fma_bound_ms": pair32["fma_bound_ms"],
         "library_ms": pair32["library_ms"],
         "library_backend": pair32["library_backend"],
         "scratch_bytes": pair32["scratch_bytes"],
         "full_card": pair_rows["float32"],
         "head_dims": pair_head_dims["float32"],
         "checked": True},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

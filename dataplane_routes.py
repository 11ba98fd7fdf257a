"""Time the data-plane kernels on the card, against another build.

    python3 dataplane_routes.py [--against DIR] [--reps N] [--turns N]
                                [--phases] [--kernels NAME ...]
                                [--against-only]

Builds this checkout's ``ray_tpu_torch/ops/csrc/bundle.cu``, ``pull.cu``,
``topk.cu``, ``broadcast.cu``, ``shard_scan.cu`` and ``beat.cu``'s
``beat_tail`` and ``beat_rows`` (through the wrappers or their C entry
points) and, with
``--against``, the sources of an older commit in DIR (its ``csrc``
directory, unpacked from ``git archive`` into an ignored directory,
``contract.cuh`` beside them), built with the same nvcc flags and called
through the C entry points they had before the kernels' redesign
(``OLD_SIGNATURES``).  ``--kernels`` keeps the kernels named (all four
by default).  For every row it checks both builds against a reference,
bit for bit, and times them in turns (against, this, this, against;
``--turns`` times over, each turn the p50 of ``--reps`` launches, CUDA
events):

* bundle and pull: the ``dataplane`` phase's problems of
  ``chip_smoke.py`` (1000 nodes, 8192 nodes, the runtime thresholds'
  sizes) against the numpy oracle, beside ns a pull or a bundle step
  (the key passes of ``chip_smoke.bundle_key_passes``) and the bundle
  layout;
* top-k: the ``topk`` phase's two problems (1000 x 8 x 64 x 1M and the
  contract's 8192 x 16 x 128) against the CPU run, beside ns a class
  step and the layout;
* the broadcast plan: 1000 members at fan-out 4, the contract's 8192,
  uniform bandwidth at 1000 and the ``broadcast`` phase's 72 rows at
  fan-out 2, against the plain version on the card, beside ns an attach
  and the layout;
* ``shard_scan``: a steady sharded beat's scan inputs (the beat cell,
  captured from the engine at S = 2 / 4 / 8 ranks of the card) and the
  contract's 8192 x 16 x 128 at S = 2 / 4 / 8, against
  ``shard_scan_plain``, beside the plan (route, CTAs a rank), profiler
  device ms and us an exchange;
* ``beat_tail``: a steady beat's inputs at S = 1 / 2 / 4 / 8, against
  ``beat_tail_plain``, beside profiler device ms.  Both older builds
  are called through the same C entry points as this one.
* ``beat_rows``: its three calls captured from an engine's own calls at
  the beat cell (the beat with 12 dirty rows, overrides and a soft mask
  at S = 1 / 2 / 4 / 8; the class install of 4 fresh classes and the
  full rescore at S = 1 / 4) and made directly at the contract's 8192 x
  16 x 128 (install and rescore, S = 1 / 4), against
  ``beat_rows_plain``, beside profiler device ms, each build's grid and
  an empty kernel's device ms with that grid (a launch's floor, same
  stream, same call) and the call's bound; then the wrapper's host ms
  a steady beat call (this checkout's, and the older tree's in a process
  of its own where DIR lies in one: ``--wrapper-host --package-root``).
  ``--against-only`` times DIR's build alone.

Then constants of the kernels, each from builds that override it with
``-D``: bundle.cu's and broadcast.cu's rows a CTA (``RT_ROWS_PER_CTA``,
which sets their clusters) swept at each size, and pull.cu's list cap
(``RT_LIST_CAP``) on dense holders at 1000 and 8192 nodes, where every
request passes the cap of 128 and the CTA reduces it, against a cap of
8192, where one warp loops over every list.  ``--phases`` builds copies
of the sources with ``clock64`` probes inserted at anchor lines (as
``flash_phases.py`` does for flash attention) and prints cycles by phase
of thread 0 of CTA 0 at each size (``shard_scan``: by part of an
exchange, of rank 0's first CTA; ``beat_tail``: the counts copy, the
budgets and the argmin CTAs, and the launch's span; with ``--against``,
the older sources' probes too; ``beat_rows``: the older source only,
its beat call by phase and its keys' loop with and without key_of's
division, from a second copy with the division taken out).  Each row is one JSON line on stdout,
after one with the card's name and power limit.  Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
import flash_phases as fp

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points of the kernels before their redesigns: bundle and
# pull as of b84b189, top-k and the broadcast plan as of 42c25a3
OLD_SIGNATURES = {
    "bundle": ("rt_bundle_schedule",
               [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "pull": ("rt_pull_choose", [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P]),
    "topk": ("rt_topk_schedule",
             [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              _P, _P, _P]),
    "broadcast": ("rt_plan_fanout",
                  [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
}
KERNELS = ("bundle", "pull", "topk", "broadcast", "shard_scan", "beat_tail",
           "beat_rows")
BEAT_KERNELS = ("shard_scan", "beat_tail", "beat_rows")
ROWS_PER_CTA = (1024, 512, 256, 128, 64)    # the sweep; the source's is 128
FANOUT_ROWS_PER_CTA = (8192, 4096, 1024, 512, 64)  # the source's is 1024
ONE_WARP_CAP = 8192                         # a list as long as N can be
TOPK_K_ABS, TOPK_K_FRAC, TOPK_SEED, TOPK_ROUND = 1, 0.25, 7, 1
BCAST_ENTRY_ROWS, BCAST_ENTRY_FANOUT = 72, 2   # the broadcast phase's plan


def _sig(t, label, n):
    """A probe of thread 0 of CTA 0: the cycles since the last one go to
    phase ``n``."""
    return (f"  if ({t}) {{ const long long c_ = clock64(); "
            f"prof[{n}] += c_ - tc; tc = c_; }}  // {label}\n")


def _flush(t):
    return (f"  __syncthreads();\n"
            f"  if ({t}) {{\n"
            f"    const long long c_ = clock64();\n"
            f"    prof[6] += c_ - tc;\n"
            f"    prof[7] += c_ - t0;\n"
            f"    for (int k = 0; k < 8; ++k)\n"
            f"      atomicAdd(&g_phase[k], (unsigned long long)prof[k]);\n"
            f"  }}\n")


_START = ("  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
          "  const long long t0 = clock64();\n"
          "  long long tc = t0;\n")
_DECL = "__device__ unsigned long long g_phase[8];\n"
_B0 = "rank == 0 && tid == 0"
# (anchor, text before it, text after it), as flash_phases.PROBES; the
# phases in the order of BUNDLE_PHASES (slot 5 counts steps)
BUNDLE_PROBES = [
    ("constexpr unsigned kNoRow = 0xffffffffu;\n", "", _DECL),
    ("  int* mins = reinterpret_cast<int*>(smem + pl.mins);   "
     "// 3 x (v0, v1)\n", "", _START),
    ("  int parity = 0;\n", _sig(_B0, "prologue", 0), ""),
    ("  for (int p = 0; p < in.p; ++p) {\n", "", "    tc = clock64();\n"),
    ("    const int strategy = blk[0];\n", _sig(_B0, "staging", 1), ""),
    ("      if (npos < 0) continue;            // an invalid bundle\n", "",
     "      tc = clock64();\n"),
    ("      warp_first_min(k1, r1, packed);\n", "", _sig(_B0, "keys", 2)),
    ("      const bool ok1 = k0 != kInfKey, ok2 = k1 != kInfKey;\n",
     _sig(_B0, "push, barrier", 3), ""),
    ("      if (tid == 0 && !strict) placed[j] = node;\n", "",
     _sig(_B0, "join, debit", 4) + "      prof[5] += 1;\n"),
    ("  // avail out, once (every owner's last debit first)\n",
     "  tc = clock64();\n", ""),
    ("      a_out[(long long)i * r + c] = av[c * st + i];\n", "",
     _flush(_B0)),
]
BUNDLE_PHASES = ("prologue", "staging", "key_pass", "push_barrier",
                 "join_debit", "steps", "avail_out", "launch")
_P0 = "tid == 0 && blockIdx.x == 0"
PULL_PROBES = [
    ("constexpr int kMaxShared = 232448;       "
     "// an H100 block's shared memory\n", "", _DECL),
    ("  const int n = in.n, r = in.r, cap = in.cap, slots = in.slots;\n", "",
     _START),
    ("  if (warp == 1) {\n", _sig(_P0, "prologue", 0), ""),
    ("      mbar_wait(full + 8 * s, (seq / slots) & 1);\n",
     "      tc = clock64();\n", _sig(_P0, "ring wait", 1)),
    ("        const int2* lst = data + off;\n", "        tc = clock64();\n",
     ""),
    ("        __syncwarp();\n", "",
     "        if (lane == 0) {\n"
     "          prof[c <= cap ? 2 : 3] += clock64() - tc;\n"
     "          prof[c <= cap ? 4 : 5] += 1;\n"
     "        }\n"),
    ("  // the costs, off the chain\n", "  tc = clock64();\n", ""),
    ("    in.cost[i] = best > 0 ? floordiv(in.sizes[i], best) : "
     "kNoSourceCost;\n  }\n", "", _flush(_P0)),
]
PULL_PHASES = ("prologue", "ring_wait", "short_steps", "long_steps",
               "n_short", "n_long", "costs", "launch")
_T0 = "tid == 0"
TOPK_PROBES = [
    ("constexpr int kStageMax = 48 * 1024;     "
     "// three staged blocks, at most\n", "", _DECL),
    ("  int* used = in.blocks + (long long)ng * pl.group;      "
     "// zeroed on entry\n", "", _START),
    ("  for (int gi = 0; gi < ng; ++gi) {\n", _sig(_T0, "prologue", 0), ""),
    ("    if (pl.stage) cp_async_wait();       "
     "// class gi + 1's block (below)\n", _sig(_T0, "keys", 1), ""),
    ("    // the select's first scan, by the targets' warps; the class's "
     "terms\n",
     _sig(_T0, "barrier, terms", 2), ""),
    ("    const int k_last = (int)(s_prefix[0] ^ 0x80000000u);\n",
     _sig(_T0, "select", 3), ""),
    ("    if (tid == 0) crow[n] = 0;\n", "",
     _sig(_T0, "spread, debit", 4) + "    prof[5] += 1;\n"),
    ("  // avail out, once (every owner's last debit first)\n",
     "  tc = clock64();\n", ""),
    ("      in.new_avail[(long long)e * r + c] = av[c * n + e];\n  }\n", "",
     _flush(_T0)),
]
TOPK_PHASES = ("prologue", "key_pass", "barrier_terms", "select",
               "spread_debit", "classes", "avail_out", "launch")
_FLUSH_ROUNDS = (f"    if ({_B0}) {{\n"
                 f"      const long long c_ = clock64();\n"
                 f"      prof[7] += c_ - t0;\n"
                 f"      for (int k = 0; k < 8; ++k)\n"
                 f"        atomicAdd(&g_phase[k], "
                 f"(unsigned long long)prof[k]);\n"
                 f"    }}\n")
BROADCAST_PROBES = [
    ("constexpr unsigned long long kMark = 1ull;  "
     "// a key under replacement\n", "", _DECL),
    ("  const int w_lo = min(rows, warp * rpw), w_hi = min(rows, w_lo + rpw);"
     "\n", "", _START),
    ("  int par = 0, step = 0;\n", _sig(_B0, "prologue", 0), ""),
    ("    // this warp's least key, refreshed while its child is taken\n",
     _sig(_B0, "rescans", 1), ""),
    ("    // the warp's offer into every CTA's partials, then the round's "
     "barrier\n", _sig(_B0, "looks", 2), ""),
    ("    // -- the join, by warp 0: the least offer and its row's depth; "
     "the\n",
     _sig(_B0, "offer, barrier", 3), ""),
    ("      if (lane == 0) s_done = g == kNoKey;   "
     "// the same round in every CTA\n", "", _sig(_B0, "join", 4)),
    ("    if (s_done) break;\n",
     "    if (s_done) {\n" + _FLUSH_ROUNDS + "    }\n", ""),
    ("    __syncthreads();                     "
     "// the round's state, for the next\n", "",
     _sig(_B0, "fold, attach, barrier", 5) + "    prof[6] += 1;\n"),
]
BROADCAST_PHASES = ("prologue", "rescans", "looks", "offer_barrier", "join",
                    "fold_attach_barrier", "rounds", "launch")
# the broadcast plan before its redesign (42c25a3): a step's look pass,
# full rescans, warp 0's least key and its push, the barrier.cluster,
# then the join, the update and its __syncthreads
PARENT_BROADCAST_PROBES = [
    ("constexpr int kUnitShift = 15;         "
     "// _INFLIGHT_UNIT_KB = 32 * 1024\n", "", _DECL),
    ("  const int nseg = (n + kSeg - 1) / kSeg;\n", "", _START),
    ("  int parity = 0;\n", _sig(_B0, "prologue", 0), ""),
    ("    // full rescans, a 512-column segment a warp: the changed rows, "
     "then\n", _sig(_B0, "looks", 1), ""),
    ("    // this CTA's least key, pushed into every CTA's slot [rank]\n",
     _sig(_B0, "rescans", 2), ""),
    ("    cl.sync();\n", _sig(_B0, "push", 3), _sig(_B0, "barrier", 4)),
    ("    if (g == kNoKey) break;              "
     "// the same step in every CTA\n",
     "    if (g == kNoKey) {\n" + _FLUSH_ROUNDS + "    }\n", ""),
    ("    if (tid == 0) sh.want[cs_ >> 5] &= ~(1u << (cs_ & 31));\n"
     "    __syncthreads();\n", "",
     _sig(_B0, "join, update, barrier", 5) + "    prof[6] += 1;\n"),
]
PARENT_BROADCAST_PHASES = ("prologue", "looks", "rescans", "push",
                           "cluster_barrier", "join_update_barrier",
                           "steps", "launch")


# -- the delta beat's kernels: shard_scan and beat_tail -----------------------
# The sharded beat cell's meshes (chip_smoke.SHARD_BEATS), the ranks
# beat_tail runs at (1: the single-device engine) and the meshes of the
# contract's 8192 x 16 x 128 (chip_smoke.limit_problem): 2 ranks fit one
# thread-block cluster, 4 and 8 take the global route.
SCAN_MESHES = ((2, "flat"), (4, "two_level"), (8, "flat"))
TAIL_RANKS = (1, 2, 4, 8)
SCAN_LIMIT_RANKS = (2, 4, 8)
BEAT_CHURN = 12                         # dirty rows a beat, as the cell's

_SHARED_PROBE = (
    "__device__ unsigned long long g_phase[8];\n"
    "__shared__ long long p_prof[8];\n"
    "__shared__ long long p_tc;\n"
    "__shared__ int p_on;\n"
    "#define RT_PROBE(n) do { if (p_on && threadIdx.x == 0) { "
    "const long long c_ = clock64(); p_prof[n] += c_ - p_tc; p_tc = c_; } "
    "} while (0)\n")
_SCAN_START = ("  if (threadIdx.x == 0) {\n"
               "    p_on = rank == 0 && cta == 0;\n"
               "    for (int k = 0; k < 8; ++k) p_prof[k] = 0;\n"
               "    p_tc = clock64();\n"
               "  }\n")
_SCAN_FLUSH = ("  RT_PROBE(0);\n"
               "  if (p_on && threadIdx.x == 0)\n"
               "    for (int k = 0; k < 8; ++k)\n"
               "      atomicAdd(&g_phase[k], (unsigned long long)p_prof[k]);\n")
_COUNT = "  if (p_on && threadIdx.x == 0) p_prof[7] += 1;\n"
# cycles of thread 0 of rank 0's first CTA, by part of an exchange; slot 7
# counts the exchanges
SCAN_PHASES = ("compute", "cta_reduce", "cluster_push_barrier", "publish",
               "wait", "slot_reads", "closing_barrier", "exchanges")
# shard_scan.cu as of dc85228: a CTA reduction, the rank's cluster
# exchange, then the global round (a release publish by the rank's first
# CTA, every CTA's warp 0 polling the S counters, the slot reads, a
# __syncthreads).  The wait is split from the reads by a first loop that
# only waits (the reads' own waits then return at once).
PARENT_SCAN_PROBES = [
    ("constexpr long long kWaitNs = 10000000000LL;\n", "", _SHARED_PROBE),
    ("  Ctx cx{tab, s, rank, cta, 0u, 0};\n", "", _SCAN_START),
    ("  unsigned u[NV];\n#pragma unroll\n  for (int v = 0; v < NV; ++v) "
     "u[v] = warp_sum((unsigned)vals[v]);\n", "  RT_PROBE(0);\n", ""),
    ("  cross<NV, false, kCluster>(sh, cx, x, xm);\n", "  RT_PROBE(1);\n",
     ""),
    ("    slots_at<2>(lv2, m_max, cls, rw, thr_fp, m2);\n", "",
     "    RT_PROBE(0);\n"),
    ("    cross<2, true, kCluster>(sh, cx, tot, kNoKey);\n",
     "    RT_PROBE(1);\n", ""),
    ("    cx.parity ^= 1;\n  }\n", "", "  RT_PROBE(2);\n"),
    ("      st_release(own, round);\n    }\n", "", "    RT_PROBE(3);\n"),
    ("    for (int k = lane; k < cx.s; k += 32) {   "
     "// lane k reads rank k's slot\n",
     "    for (int k = lane; k < cx.s; k += 32)\n"
     "      wait_round(cx.tab[k].xchg, round);\n"
     "    __syncwarp();\n"
     "    RT_PROBE(4);\n", ""),
    ("    m = warp_min(m);\n", "", "    RT_PROBE(5);\n"),
    ("}\n\n// An exchange of one value vector a row: the CTA's sums, then "
     "cross().\n", "  RT_PROBE(6);\n" + _COUNT, ""),
    ("  if constexpr (kCluster) cg::this_cluster().sync();  "
     "// none leaves while\n", _SCAN_FLUSH, ""),
]
_TAIL_DECL = (
    "__device__ unsigned long long g_phase[8];\n"
    "__device__ __forceinline__ long long rt_gtimer() {\n"
    "  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n"
    "}\n")
_TAIL_START = ("  const long long p_t0 = clock64();\n"
               "  long long p_tc = p_t0;\n"
               "  if (threadIdx.x == 0)\n"
               "    atomicMax(&g_phase[7], (unsigned long long)"
               "((1LL << 62) - rt_gtimer()));\n")


def _tail_sig(slot):
    return ("    if (threadIdx.x == 0) {\n"
            "      const long long c_ = clock64();\n"
            f"      atomicAdd(&g_phase[{slot}], (unsigned long long)"
            "(c_ - p_tc));\n"
            "      p_tc = c_;\n"
            "    }\n")


_TAIL_ARGMIN_END = (
    "    if (threadIdx.x == 0) {\n"
    "      atomicAdd(&g_phase[3], (unsigned long long)(clock64() - p_t0));\n"
    "      atomicAdd(&g_phase[4], 1ull);\n"
    "      atomicMax(&g_phase[6], (unsigned long long)rt_gtimer());\n"
    "    }\n")
_TAIL_BUDGET_END = (
    "  if (threadIdx.x == 0) {\n"
    "    atomicAdd(&g_phase[2], 1ull);\n"
    "    atomicMax(&g_phase[5], (unsigned long long)(clock64() - p_t0));\n"
    "    atomicMax(&g_phase[6], (unsigned long long)rt_gtimer());\n"
    "  }\n")
# thread 0 of every CTA: cycles of the counts copy and of the budgets
# (summed over the budget CTAs, slot 2 counting them), of the argmin CTAs
# (summed, slot 4 counting them), the longest budget CTA, and the
# launch's span in ns (%globaltimer: the last CTA's end in slot 6, the
# first one's start as 2**62 - start in slot 7)
TAIL_PHASES = ("counts", "budgets", "budget_ctas", "argmin", "argmin_ctas",
               "longest_budget_cta", "end_ns", "start_ns_complement")
# beat_tail as of dc85228: a tile CTA's thread copies its row's G
# counts, then prices its row for every class; one CTA a class argmin
PARENT_TAIL_PROBES = [
    ("constexpr int kModeRescore = 2;          "
     "// every class against every node\n", "", _TAIL_DECL),
    ("  const long long ld = (long long)a.s * a.n_l + 1;   "
     "// packed's row length\n", "", _TAIL_START),
    ("    if (tid == 0) a.amin[cls] = packed_row(m[0]);\n", "",
     _TAIL_ARGMIN_END),
    ("      a.packed[gi * ld + col] = alloc[(long long)gi * a.alloc_row + "
     "row];\n", "", _tail_sig(0)),
    ("          budget_of(t_row, a_row, res.reqs + cls * r, r, live);\n", "",
     _tail_sig(1)),
    ("      a.packed[(a.g + cls) * ld + ld - 1] = 0;\n  }\n", "",
     _TAIL_BUDGET_END),
]


def beat_captures(s, mode="flat", beats=3, device="cuda:0"):
    """One steady delta beat of the beat cell (chip_smoke.build_cluster,
    12 dirty rows a beat) on ``s`` ranks of the card (``s`` = 1: the
    single-device engine): {"scan": shard_scan's arguments (S > 1),
    "tail": beat_tail's (state, alloc, inf, av_fin)}, copies taken from
    the engine's own calls of its last beat."""
    from ray_tpu_torch.common.resources import ResourceRequest
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling import make_delta_scheduler

    rng, crm, vecs, counts = cs.build_cluster()
    eng = make_delta_scheduler(crm, device=device) if s == 1 else \
        make_delta_scheduler(crm, n_shards=s, reduce_mode=mode,
                             devices=[device] * s)
    seen = {}
    real_tail = hk.beat_tail

    def tail(st, alloc, inf, av_fin):
        seen["tail"] = (st.clone(), hk.spaced([a.clone() for a in alloc]),
                        inf.clone(), hk.spaced([a.clone() for a in av_fin]))
        return real_tail(st, alloc, inf, av_fin)

    tail.launches = 0                    # the sharded engine reads it
    plane = getattr(eng, "_plane", None)
    if plane is not None:
        def scan(*args, **kw):
            seen["scan"] = tuple(
                [x.clone() for x in a] if isinstance(a, list) else a
                for a in args[:8])
            return type(plane)._scan(plane, *args, **kw)
        plane._scan = scan
    hk.beat_tail = tail
    try:
        for _ in range(beats):
            for _ in range(BEAT_CHURN):
                crm.force_subtract(int(rng.integers(0, cs.N_NODES)),
                                   ResourceRequest({"CPU": 1}))
            eng.beat(vecs, counts)
    finally:
        hk.beat_tail = real_tail
        if plane is not None:
            del plane._scan
    return seen


def scan_limit_args(s, device="cuda"):
    """shard_scan's arguments for the contract's 8192 x 16 x 128 (group
    masks, dead and overcommitted rows) on ``s`` ranks of the card."""
    import torch

    from ray_tpu_torch.scheduling.contract import threshold_fp
    totals, avail, mask, reqs, counts, masks = cs.limit_problem()

    def rows(a, axis=0):
        return [torch.as_tensor(np.ascontiguousarray(b), device=device)
                for b in np.split(a, s, axis=axis)]

    def repl(a):
        return [torch.as_tensor(a, device=device)] * s

    return (rows(totals), rows(avail), rows(mask), repl(reqs), repl(counts),
            rows(masks, 1), int(threshold_fp(None)), False)


def scan_caller(lib, args):
    """A function of no arguments that runs one ``shard_scan`` launch of
    the build at path ``lib`` on ``args``, as the wrapper does (outputs
    and a zeroed exchange area made once, the area zeroed again on the
    stream before each launch), returning (alloc, inf, new_avail); and
    the plan its library gives."""
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import hybrid_kernel as hk
    totals, avail, mask, greqs, gcounts, gmasks, thr, req_av = args
    s = len(totals)
    (n_l, r), g = totals[0].shape, greqs[0].shape[0]
    plan_fn = _build.entry(lib, "shard_scan", "rt_shard_scan_plan")
    launch = _build.entry(lib, "shard_scan")
    plan = (ctypes.c_int * 8)()
    assert plan_fn(s, n_l, r, int(req_av), ctypes.addressof(plan)) == 0
    dev = totals[0].device
    alloc = torch.empty((s, g, n_l), dtype=torch.int32, device=dev)
    new_avail = torch.empty((s, n_l, r), dtype=torch.int32, device=dev)
    inf = torch.empty((g,), dtype=torch.int32, device=dev)
    xchg = torch.zeros((s, plan[5]), dtype=torch.int32, device=dev)
    table = hk.rank_table(
        [[totals[i].data_ptr(), avail[i].data_ptr(), mask[i].data_ptr(),
          greqs[i].data_ptr(), gcounts[i].data_ptr(),
          0 if gmasks is None else gmasks[i].data_ptr(),
          alloc[i].data_ptr(), new_avail[i].data_ptr(),
          inf.data_ptr() if i == 0 else 0, xchg[i].data_ptr()]
         for i in range(s)], dev)
    layout = (ctypes.c_int * 8)()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        xchg.zero_()
        err = launch(table.data_ptr(), s, n_l, r, g, thr, int(req_av),
                     ctypes.addressof(layout), stream)
        assert err == 0, f"shard_scan ({lib.name}): CUDA error {err}"
        return list(alloc), inf, list(new_avail)

    return call, list(plan)


def tail_caller(lib, captured):
    """A function of no arguments that runs one ``beat_tail`` launch of
    the build at path ``lib`` on a captured beat, returning (packed,
    argmin)."""
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import hybrid_kernel as hk
    table, args, packed, amin = hk.tail_args(*captured)
    launch = _build.entry(lib, "beat", "rt_beat_tail")
    layout = (ctypes.c_int * 8)()
    stream = torch.cuda.current_stream(packed.device).cuda_stream

    def call():
        err = launch(table.data_ptr(), ctypes.addressof(args),
                     ctypes.addressof(layout), stream)
        assert err == 0, f"beat_tail ({lib.name}): CUDA error {err}"
        return packed, amin

    return call


def device_turns(fns, name, n_turns):
    """{label_device_ms: [ms, ...]}: profiler device ms a call of the
    kernels named ``name``, in turns (against, this, this, against)."""
    out = {}
    for _ in range(n_turns):
        for label in ("against", "this", "this", "against"):
            if fns.get(label) is not None:
                out.setdefault(f"{label}_device_ms", []).append(
                    cs.kernel_device_ms(fns[label], name, 20))
    return out


def read_phases(lib):
    read = ctypes.CDLL(str(lib)).rt_phases
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 8)()
    assert read(buf) == 0
    return list(buf)


def probe_row(lib, fn, labels):
    """The probes' slots after one call of ``fn`` (the warm-up's zeroed)."""
    import torch
    fn()
    torch.cuda.synchronize()
    read_phases(lib)
    out = fn()
    torch.cuda.synchronize()
    return out, dict(zip(labels, read_phases(lib)))


def scan_row(label, args, libs, reps, n_turns, probed=None):
    """One shard_scan row: each build in ``libs`` ({"this", "against"})
    equal to ``shard_scan_plain`` bit for bit, its route and layout, its
    ms in turns (CUDA events around the launch and its memset; profiler
    device ms beside), us an exchange; with ``probed`` ({tag: library}),
    cycles by part of an exchange."""
    import torch

    from ray_tpu_torch.ops import shard_reduce as sr
    s = len(args[0])
    tp = sr._Transport(sr.build_mesh(s, "flat", [args[0][0].device] * s))
    want = sr.shard_scan_plain(tp, *args)
    calls = {k: scan_caller(lib, args) for k, lib in libs.items()}
    row = {"program": "shard_scan", "problem": label, "ranks": s,
           "rows": s * args[0][0].shape[0], "classes":
           int(args[3][0].shape[0]), "group_masks": args[5] is not None}
    ok = True
    for k, (call, plan) in calls.items():
        got = call()
        torch.cuda.synchronize()
        row[f"{k}_equals_plain"] = same_scan(got, want)
        row[f"{k}_plan"] = plan
        ok &= row[f"{k}_equals_plain"]
    fns = {k: c[0] for k, c in calls.items()}
    row.update(turns(fns, n_turns, reps))
    row.update(device_turns(fns, "shard_scan_kernel", n_turns))
    exchanges = 6 * row["classes"] + 1
    row["exchanges"] = exchanges
    for k in fns:
        dms = [x for x in row[f"{k}_device_ms"] if x is not None]
        best = min(dms) if dms else min(row[k])
        row[f"{k}_us_an_exchange"] = best * 1e3 / exchanges
    if "against" in fns:
        row["speedup"] = float(np.mean(row["against"]) / np.mean(row["this"]))
    for tag, lib in (probed or {}).items():
        got, cyc = probe_row(lib, scan_caller(lib, args)[0], SCAN_PHASES)
        row[f"{tag}probed_equals_plain"] = same_scan(got, want)
        ok &= row[f"{tag}probed_equals_plain"]
        n_x = max(cyc["exchanges"], 1)
        row[f"{tag}cycles_an_exchange"] = {
            p: cyc[p] / n_x for p in SCAN_PHASES[:-1]}
        row[f"{tag}probed_exchanges"] = cyc["exchanges"]
    cs.emit(row)
    return ok


def same_scan(got, want):
    import torch
    return (all(torch.equal(x, y) for x, y in zip(got[0], want[0]))
            and torch.equal(got[1], want[1])
            and all(torch.equal(x, y) for x, y in zip(got[2], want[2])))


def tail_row(s, captured, libs, reps, n_turns, probed=None):
    """One beat_tail row: each build equal to ``beat_tail_plain`` bit for
    bit, ms in turns (CUDA events) and profiler device ms; with
    ``probed``, the probes' split of one call."""
    import torch

    from ray_tpu_torch.ops import hybrid_kernel as hk
    want = hk.beat_tail_plain(*captured)
    fns = {k: tail_caller(lib, captured) for k, lib in libs.items()}
    row = {"program": "beat_tail", "ranks": s,
           "rows": s * captured[0].n_local,
           "classes": int(captured[0].reqs[0].shape[0]),
           "groups": int(captured[1][0].shape[0])}
    ok = True
    for k, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        row[f"{k}_equals_plain"] = bool(torch.equal(got[0], want[0]) and
                                        torch.equal(got[1], want[1]))
        ok &= row[f"{k}_equals_plain"]
    row.update(turns(fns, n_turns, reps))
    row.update(device_turns(fns, "beat_tail_kernel", n_turns))
    for tag, lib in (probed or {}).items():
        fn = tail_caller(lib, captured)
        got, cyc = probe_row(lib, fn, TAIL_PHASES)
        row[f"{tag}probed_equals_plain"] = bool(
            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        ok &= row[f"{tag}probed_equals_plain"]
        nb, na = max(cyc["budget_ctas"], 1), max(cyc["argmin_ctas"], 1)
        row[f"{tag}probes"] = {
            "counts_cycles_a_cta": cyc["counts"] / nb,
            "budgets_cycles_a_cta": cyc["budgets"] / nb,
            "budget_ctas": cyc["budget_ctas"],
            "argmin_cycles_a_cta": cyc["argmin"] / na,
            "argmin_ctas": cyc["argmin_ctas"],
            "longest_budget_cta_cycles": cyc["longest_budget_cta"],
            "span_ns": cyc["end_ns"] - ((1 << 62) -
                                        cyc["start_ns_complement"])}
    cs.emit(row)
    return ok


def beat_kernel_rows(kernels, args, against) -> bool:
    """The shard_scan, beat_tail and beat_rows rows: this build against the
    older commit's ``csrc`` in DIR (same entry points), on the beat cell's
    captured inputs (shard_scan at S = 2 / 4 / 8, beat_tail at S = 1 /
    2 / 4 / 8, beat_rows as ``beat_rows_rows`` says) and, for shard_scan,
    the contract's 8192 x 16 x 128 at S = 2 / 4 / 8; with ``--phases``,
    probed copies."""
    from ray_tpu_torch.ops import _build
    lib_name = {"shard_scan": "shard_scan", "beat_tail": "beat",
                "beat_rows": "beat"}
    specs, keys = [], []
    for k in kernels:
        if not args.against_only:
            specs.append((_build._CSRC / _build.SOURCES[lib_name[k]], ()))
            keys.append((k, "this"))
        if against is not None:
            specs.append((against / _build.SOURCES[lib_name[k]], ()))
            keys.append((k, "against"))
        if args.phases:
            for tag, (probes, csrc, edit) in \
                    PHASE_SOURCES[k](against).items():
                specs.append(probed(lib_name[k], probes, csrc, tag, edit))
                keys.append((k, ("probed", tag)))
    built = dict(zip(keys, _build.build_variants(specs)))
    ok = True
    for k in kernels:
        libs = {t: built[k, t] for t in ("this", "against")
                if (k, t) in built}
        # the probed builds' rows: "" this source's, "against_" the older
        probes = {f"{t[1]}_" if t[1] else "": lib
                  for (kk, t), lib in built.items()
                  if kk == k and isinstance(t, tuple)}
        if k == "beat_rows":
            ok &= beat_rows_rows(libs, args, against, {
                t.removeprefix("rows_").rstrip("_"): lib
                for t, lib in probes.items()})
        elif k == "shard_scan":
            for s, mode in SCAN_MESHES:
                scan = beat_captures(s, mode)["scan"]
                ok &= scan_row(f"beat {s} {mode}", scan, libs, args.reps,
                               args.turns, probes)
            for s in SCAN_LIMIT_RANKS:
                ok &= scan_row(f"limit 8192x16x128 {s}", scan_limit_args(s),
                               libs, args.reps, args.turns, probes)
        else:
            for s in TAIL_RANKS:
                tail = beat_captures(s, SCAN_MESHES[0][1])["tail"]
                ok &= tail_row(s, tail, libs, args.reps, args.turns, probes)
    return ok


# -- beat_rows: the beat call, the class install and the full rescore --------
# The beat call at S = 1 / 2 / 4 / 8 of the beat cell; the install and the
# rescore at S = 1 and 4 of the beat cell and of the contract's 8192 x 16 x
# 128 (chip_smoke.limit_problem)
ROWS_RANKS = (1, 2, 4, 8)
KEYS_RANKS = (1, 4)
LIMIT_INSTALL = (1, 6, 11, 14)           # the limit install's slots
ROW_FIELDS = ("totals", "avail", "mask", "keys", "reqs", "avail_eff",
              "mask_eff", "group_reqs", "group_counts")
# A kernel that does nothing, launched with a build's grid on the same
# stream: a launch's floor, measured in the same call
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int rt_empty(int ctas, int threads, void* stream) {
  empty_kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def _rows_probe(slot):
    return ("  if (p_on) { const long long c_ = clock64(); "
            f"atomicAdd(&g_phase[{slot}], (unsigned long long)(c_ - p_tc)); "
            "p_tc = c_; }\n")


# beat_rows as of 099ec69, thread 0 of CTA (tile 0, rank 0): the beat call
# by phase (the lane search with shared atomics, the scatter into the
# residents and its barrier, the dirty rows' key columns read back from
# them, the tile's avail_eff / mask_eff and its barrier, the overrides,
# tile 0's group gather, counts copy and exchange zeroing), and, in the
# install and the rescore, the cycles of its row's loop over every class
ROWS_PHASES = ("lane_search", "scatter", "rescore", "eff", "overrides",
               "gather", "keys_loop", "keys_calls")
PARENT_ROWS_PROBES = [
    ("constexpr int kModeRescore = 2;          "
     "// every class against every node\n", "", _TAIL_DECL),
    ("  const int base_row = k * n_l;            "
     "// the global row of local row 0\n", "",
     "  const bool p_on = blockIdx.x == 0 && k == 0 && tid == 0;\n"
     "  long long p_tc = clock64();\n"),
    ("    const int n_cls = install ? a.bc : a.c;\n", "",
     "    if (p_on) p_tc = clock64();\n"),
    ("    return;\n  }\n\n  const int* idx = input<int>(a, kIdx, k);\n",
     _rows_probe(6) + "    if (p_on) atomicAdd(&g_phase[7], 1ull);\n", ""),
    ("  const int nl = min(n_lanes, kTile), no = min(n_ov, kTile);\n", "",
     _rows_probe(0)),
    ("  // their key columns against every class, off the raw avail and the\n",
     _rows_probe(1), ""),
    ("  if (!a.eff) return;\n", _rows_probe(2), ""),
    ("  {\n    const int* ova = input<int>(a, kOvAvail, k);\n",
     _rows_probe(3), ""),
    ("  if (blockIdx.x == 0) {                   // the rank's scan inputs\n",
     _rows_probe(4), ""),
    ("      for (int e = tid; e < a.xchg_ints; e += nt) res.xchg[e] = 0u;\n"
     "  }\n", "", _rows_probe(5)),
]
# this beat.cu, thread 0 of every CTA: by kind of CTA the cycles of its
# first wave (up to its first barrier) and of the rest, summed over the
# CTAs (slot 5 counts them), and the launch's span (%globaltimer: the last
# CTA's end in slot 6, the first one's start as 2**62 - start in slot 7).
# The beat call: the lane CTAs (0, 1), the eff CTAs (2, 3), the gather CTA
# (4, whole); the install and the rescore: the key CTAs (0, 1).
THIS_ROWS_PHASES = ("lane_wave", "lane_keys", "eff_wave", "eff_rest",
                    "gather", "ctas", "end_ns", "start_ns_complement")


def _this_sig(slot, end=False):
    """``_tail_sig``; at a CTA's ``end``, also its count and end time."""
    return _tail_sig(slot) + (
        "    if (threadIdx.x == 0) {\n"
        "      atomicAdd(&g_phase[5], 1ull);\n"
        "      atomicMax(&g_phase[6], (unsigned long long)rt_gtimer());\n"
        "    }\n" if end else "")


THIS_ROWS_PROBES = [
    ("constexpr int kModeRescore = 2;          "
     "// every class against every node\n", "", _TAIL_DECL),
    ("  const int* idx = input<int>(a, kIdx, k);\n\n"
     "  if (blockIdx.x == 0) {                   // the rank's scan inputs\n",
     _TAIL_START, ""),
    ("      res.group_reqs[e] = q[s * r + e % r];\n    }\n", "",
     _this_sig(4, end=True)),
    ("    if (on && lane == 0) res.mask[row] = live;\n    __syncthreads();\n",
     "", _this_sig(0)),
    ("      res.keys[(long long)cls * n_l + row] = key;\n    }\n", "",
     _this_sig(1, end=True)),
    ("  const bool soft = tid < rows && (em == nullptr || em[lo + tid] != 0);"
     "\n  __syncthreads();\n", "", _this_sig(2)),
    ("    res.mask_eff[lo + tid] = (d >= 0 ? (d & 1) != 0 : live) && soft;\n"
     "  }\n", "", _this_sig(3, end=True)),
    ("  const RankRes res = tab[k];\n  const bool staged = r <= kRowCols;\n",
     "", _TAIL_START),
    ("  __syncthreads();\n  if (lane >= rows) return;\n", "",
     _this_sig(0)),
    ("    res.keys[(long long)slot[i] * n_l + row] = key;\n  }\n", "",
     _this_sig(1, end=True)),
]
# the same copy with key_of's division taken out (a shift): the keys'
# loop without its divisions, so the divisions' share of it
NO_DIVISION = ("    s = max(s, floordiv(num, max(t, 1)));\n",
               "    s = max(s, num >> 12);\n")


def _rows_recorder(real, seen, keep_beat):
    """A stand-in for ``beat_rows`` that copies each call's state and
    arguments into ``seen`` by call (the last of each; the beat call only
    while ``keep_beat[0]``)."""
    def rows(st, thr, **kw):
        mode = "rescore" if kw.get("rescore") else \
            "classes" if kw.get("classes") is not None else "beat"
        if mode != "beat" or keep_beat[0]:
            seen[mode] = (st.clone(), thr, kw)
        return real(st, thr, **kw)
    rows.launches = 0                      # the sharded engine reads it
    return rows


def rows_captures(s, mode="flat", device="cuda:0"):
    """``beat_rows``' three calls as an engine makes them on ``s`` ranks of
    the card at the beat cell (chip_smoke.build_cluster): {"rescore",
    "beat", "classes"}: (state copy, thr, kwargs).  The first beat's last
    full rescore; the third delta beat's call, with 12 dirty rows,
    overrides (one on a dirty row) and an extra_mask; and the install of
    a beat that brings chip_smoke.FRESH_CLASSES new classes."""
    from ray_tpu_torch.common.resources import ResourceRequest
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling import make_delta_scheduler

    rng, crm, vecs, counts = cs.build_cluster()
    eng = make_delta_scheduler(crm, device=device) if s == 1 else \
        make_delta_scheduler(crm, n_shards=s, reduce_mode=mode,
                             devices=[device] * s)
    fresh = cs.fresh_classes(crm)
    real, seen, keep = hk.beat_rows, {}, [True]
    hk.beat_rows = _rows_recorder(real, seen, keep)
    try:
        eng.beat(vecs, counts)
        for _ in range(3):
            rows = [int(rng.integers(0, cs.N_NODES))
                    for _ in range(BEAT_CHURN)]
            for row in rows:
                crm.force_subtract(row, ResourceRequest({"CPU": 1}))
            ov = {row: rng.integers(-4, 9, vecs.shape[1]).astype(np.int32)
                  for row in (rows[0], 3, 500)}
            eng.beat(vecs, counts, overrides=ov,
                     extra_mask=rng.random(cs.N_NODES) > 0.1)
        keep[0] = False
        eng.beat(np.concatenate([vecs, fresh]),
                 np.concatenate([counts, np.full(len(fresh), 7, np.int32)]))
    finally:
        hk.beat_rows = real
    return seen


def keys_limit(s, device="cuda"):
    """The install (4 classes, slots ``LIMIT_INSTALL``, staged as an
    upload) and the full rescore at the contract's 8192 x 16 x 128 on
    ``s`` ranks of the card: {"rescore", "classes"} as ``rows_captures``."""
    import torch

    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling.contract import threshold_fp
    from ray_tpu_torch.scheduling.policy import BeatBlob
    totals, avail, mask, reqs, _, _ = cs.limit_problem()

    def rows(a):
        return [torch.as_tensor(np.ascontiguousarray(b), device=device)
                for b in np.split(a, s)]

    st = hk.BeatState(rows(totals), rows(avail), rows(mask),
                      [torch.as_tensor(reqs, device=device)] * s)
    st.alloc_keys()
    thr = int(threshold_fp(None))
    hk.beat_rows(st, thr, rescore=True)
    rng = np.random.default_rng(3)
    new = rng.integers(0, 3000, (len(LIMIT_INSTALL), reqs.shape[1]))
    new[rng.random(new.shape) < 0.5] = 0
    blob = BeatBlob({"slots": [np.zeros(1, np.int32)] * s,
                     "cls_idx": [np.array(LIMIT_INSTALL, np.int32)] * s,
                     "cls_reqs": [new.astype(np.int32)] * s})
    dev = torch.as_tensor(blob.host.reshape(-1), device=device)
    v = blob.views(list(dev.view(s, blob.words)))
    return {"rescore": (st, thr, {"rescore": True}),
            "classes": (st, thr, {"classes": (v["cls_idx"],
                                              v["cls_reqs"])})}


def empty_caller():
    """(a function of (CTAs) that launches the empty kernel with 256
    threads a CTA on the current stream)."""
    import torch

    from ray_tpu_torch.ops import _build
    out = _build.BUILD_DIR.parent / "dataplane_empty" / "empty.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(EMPTY_SRC)
    (lib,) = _build.build_variants([(out, ())])
    fn = ctypes.CDLL(str(lib)).rt_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(ctas):
        def call():
            assert fn(ctas, 256, torch.cuda.current_stream().cuda_stream) == 0
        return call
    return launch


def rows_caller(lib, captured):
    """(a function of no arguments that runs one ``beat_rows`` launch of
    the build at path ``lib`` on a copy of a captured call, the copy, the
    layout buffer): the C arguments are this checkout's (``rows_call``),
    which an older build takes as they are."""
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import hybrid_kernel as hk
    snap, thr, kw = captured
    a = snap.clone()
    call = hk.rows_call(a, thr, **kw)
    launch = _build.entry(lib, "beat")
    buf = (ctypes.c_int * 8)()
    stream = torch.cuda.current_stream(a.totals[0].device).cuda_stream

    def run():
        err = launch(call.ptrs[0], call.ptrs[1], ctypes.addressof(buf),
                     stream)
        assert err == 0, f"beat_rows ({lib.name}): CUDA error {err}"
        return a
    return run, a, buf


def same_rows(got, want) -> bool:
    import torch
    return all(torch.equal(x, y)
               for f in ROW_FIELDS if getattr(want, f) is not None
               for x, y in zip(getattr(got, f), getattr(want, f)))


def rows_row(problem, name, s, captured, libs, reps, n_turns, empty,
             probes=None):
    """One beat_rows row: each build in ``libs`` equal to
    ``beat_rows_plain`` bit for bit on a copy of the captured call, its
    grid, its ms in turns (CUDA events) and profiler device ms, beside the
    empty kernel's device ms with the same grid and the call's bound; with
    ``probes`` ({tag: library} of the older source's probed copies), the
    older beat call's cycles by phase, or its keys loop's cycles with and
    without the division."""
    import torch

    from ray_tpu_torch.ops import hybrid_kernel as hk
    snap, thr, kw = captured
    want = snap.clone()
    hk.beat_rows_plain(want, thr, **kw)
    work = cs.beat_rows_work(snap, kw) if name == "beat" else \
        cs.beat_keys_work(snap, kw)
    bound_ms, bound_by = cs.bound(*work, cs.PEAK_I32)
    row = {"program": "beat_rows", "call": name, "problem": problem,
           "ranks": s, "rows": s * snap.n_local,
           "classes": int(snap.reqs[0].shape[0]),
           "resources": int(snap.totals[0].shape[1]), "bound_ms": bound_ms,
           "bound_by": bound_by}
    fns, ok = {}, True
    for tag, lib in libs.items():
        fn, a, buf = rows_caller(lib, captured)
        fn()
        torch.cuda.synchronize()
        row[f"{tag}_equals_plain"] = same_rows(a, want)
        row[f"{tag}_grid"] = list(buf)
        ok &= row[f"{tag}_equals_plain"]
        fns[tag] = fn
    row.update(turns(fns, n_turns, reps))
    row.update(device_turns(fns, "beat_rows", n_turns))
    for tag in fns:
        row[f"empty_{tag}_device_ms"] = cs.kernel_device_ms(
            empty(row[f"{tag}_grid"][0]), "empty_kernel", 20)
    for tag, lib in (probes or {}).items():
        fn, a, _ = rows_caller(lib, captured)
        if tag == "this":
            _, cyc = probe_row(lib, fn, THIS_ROWS_PHASES)
            row["this_probed_equals_plain"] = same_rows(a, want)
            ok &= row["this_probed_equals_plain"]
            n = max(cyc["ctas"], 1)
            parts = THIS_ROWS_PHASES[:5] if name == "beat" else \
                ("lane_wave", "lane_keys")
            row["this_cycles"] = {
                ("keys_wave", "keys_rest")[i] if name != "beat" else p:
                cyc[p] for i, p in enumerate(parts)}
            row["this_probed_ctas"] = cyc["ctas"]
            row["this_span_ns"] = cyc["end_ns"] - ((1 << 62) -
                                                  cyc["start_ns_complement"])
            continue
        _, cyc = probe_row(lib, fn, ROWS_PHASES)
        if name == "beat":
            row[f"{tag}_cycles"] = {p: cyc[p] for p in ROWS_PHASES[:6]}
        else:
            row[f"{tag}_keys_loop_cycles"] = cyc["keys_loop"]
    if "against_keys_loop_cycles" in row and \
            "against_nodiv_keys_loop_cycles" in row:
        full = row["against_keys_loop_cycles"]
        row["against_division_share"] = \
            (full - row["against_nodiv_keys_loop_cycles"]) / max(full, 1)
    cs.emit(row)
    return ok


def wrapper_host(ranks=ROWS_RANKS, turns_=2):
    """The host's ms a steady beat's ``beat_rows`` call takes through the
    wrapper of the ``ray_tpu_torch`` that is imported (``cs.host_ms``:
    the checks or the layout's lookup, the arguments, the launch), on
    ``rows_captures``' beat call at each S."""
    import torch

    from ray_tpu_torch.ops import hybrid_kernel as hk
    out = {}
    for s in ranks:
        snap, thr, kw = rows_captures(s)["beat"]
        a = snap.clone()
        out[s] = [cs.host_ms(lambda: hk.beat_rows(a, thr, **kw))
                  for _ in range(turns_)]
        torch.cuda.synchronize()
    return out


def parent_wrapper_host(root: Path, n_turns):
    """``wrapper_host`` of the package under ``root`` (an older commit's
    tree), in a process of its own."""
    import json
    import subprocess
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--wrapper-host",
         "--package-root", str(root), "--turns", str(n_turns)],
        capture_output=True, text=True, check=True)
    return {int(k): v for k, v in
            json.loads(proc.stdout.strip().splitlines()[-1])["host_ms"]
            .items()}


def beat_rows_rows(libs, args, against, probes) -> bool:
    """Every beat_rows row: the beat call at ``ROWS_RANKS``, the install
    and the rescore at ``KEYS_RANKS`` of the beat cell and of the limit;
    then the wrapper's host ms, this checkout's beside the older tree's
    (where DIR sits in one) in turns."""
    import torch
    ok = True
    empty = empty_caller()
    for s in ROWS_RANKS:
        calls = rows_captures(s)
        for name in ("beat", "classes", "rescore"):
            if name == "beat" or s in KEYS_RANKS:
                ok &= rows_row("beat", name, s, calls[name], libs, args.reps,
                               args.turns, empty, probes)
        del calls
        torch.cuda.synchronize()
    for s in KEYS_RANKS:
        calls = keys_limit(s)
        for name in ("classes", "rescore"):
            ok &= rows_row("limit 8192x16x128", name, s, calls[name], libs,
                           args.reps, args.turns, empty, probes)
        del calls
    root = None if against is None else against.resolve().parents[2]
    row = {"program": "beat_rows_wrapper_host"}
    for turn in range(args.turns):
        if root is not None and (root / "ray_tpu_torch").is_dir():
            for s, ms in parent_wrapper_host(root, 1).items():
                row.setdefault(f"against_host_ms_s{s}", []).extend(ms)
        for s, ms in ({} if args.against_only else
                      wrapper_host(turns_=2)).items():
            row.setdefault(f"this_host_ms_s{s}", []).extend(ms)
        if root is not None and (root / "ray_tpu_torch").is_dir():
            for s, ms in parent_wrapper_host(root, 1).items():
                row.setdefault(f"against_host_ms_s{s}", []).extend(ms)
    cs.emit(row)
    return ok


# this shard_scan.cu: the cluster route's exchange is the CTA reduction,
# the push and barrier.cluster, and every warp's combine (slot reads);
# the global route's the CTA reduction, the tagged publish, the polls
# until every slot carries the round (wait), the reduction of the slots
# and the __syncthreads that hands the result to the CTA
SCAN_PROBES = [
    PARENT_SCAN_PROBES[0],
    ("  Ctx cx{tab, s, rank, cta, cpr, (int)blockIdx.x, 0u, 0};\n", "",
     _SCAN_START),
    PARENT_SCAN_PROBES[2],
    ("  cross<NV, false, kCluster>(sh, cx, x, xm, out);\n",
     "  RT_PROBE(1);\n", ""),
    PARENT_SCAN_PROBES[4],
    ("    cross<2, true, kCluster>(sh, cx, tot, kNoKey, pre);\n",
     "    RT_PROBE(1);\n", ""),
    ("  const bool on = lane < nc;\n", "  RT_PROBE(2);\n", ""),
    ("  out.mn = warp_min64(on ? sh.slot_min[cx.parity][lane] : kNoKey);\n"
     "  cx.parity ^= 1;\n", "", "  RT_PROBE(5);\n" + _COUNT),
    ("              tagged(round, (unsigned)mn));\n", "",
     "    RT_PROBE(3);\n"),
    ("      m = y < m ? y : m;\n    }\n", "", "    RT_PROBE(4);\n"),
    ("    m = warp_min64(m);\n", "", "    RT_PROBE(5);\n"),
    ("  out.mn = sh.res_min;\n", "", "  RT_PROBE(6);\n" + _COUNT),
    PARENT_SCAN_PROBES[-1],
]
# this beat_tail: a budget CTA copies its share of the counts block (and
# CTA 0 the overflow column), then prices its classes over its rows
TAIL_PROBES = [
    PARENT_TAIL_PROBES[0], PARENT_TAIL_PROBES[1], PARENT_TAIL_PROBES[2],
    ("      a.packed[(a.g + cls) * ld + ld - 1] = 0;\n  }\n", "",
     _tail_sig(0)),
    ("    out[row] = budget;\n  }\n", "", _tail_sig(1) + _TAIL_BUDGET_END),
]
# the probed copies of each kernel: {tag: (probes, csrc or None for this
# checkout's)}; tag "" is this checkout's source, "against" the older
# commit's (the dc85228 probes)


def _sources(this, parent):
    def pick(against):
        out = {"": (this, None, None)}
        if against is not None:
            out["against"] = (parent, against, None)
        return out
    return pick


def _rows_sources(against):
    """beat_rows: this source's probed copy; with ``--against``, the older
    source's and the same without key_of's division."""
    out = {"rows_this": (THIS_ROWS_PROBES, None, None)}
    if against is not None:
        out.update(rows_against=(PARENT_ROWS_PROBES, against, None),
                   rows_against_nodiv=(PARENT_ROWS_PROBES, against,
                                       NO_DIVISION))
    return out


PHASE_SOURCES = {"shard_scan": _sources(SCAN_PROBES, PARENT_SCAN_PROBES),
                 "beat_tail": _sources(TAIL_PROBES, PARENT_TAIL_PROBES),
                 "beat_rows": _rows_sources}


def probed(kernel: str, probes, csrc=None, tag=None,
           edit=None) -> tuple[Path, tuple]:
    """A copy of ``kernel``'s source (this checkout's, or the one in
    ``csrc``) with ``probes`` and ``flash_phases.READER``, beside a copy
    of its header (in a directory of its own, named by ``tag`` where
    given); ``edit`` = (text, replacement), once, before the probes."""
    from ray_tpu_torch.ops import _build
    out = _build.BUILD_DIR.parent / (
        f"dataplane_phases_{tag or 'this'}" if tag is not None else
        "dataplane_phases" if csrc is None else "dataplane_phases_against")
    csrc = _build._CSRC if csrc is None else csrc
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(csrc / "contract.cuh", out / "contract.cuh")
    cu = out / _build.SOURCES[kernel]
    text = (csrc / _build.SOURCES[kernel]).read_text()
    if edit is not None:
        if text.count(edit[0]) != 1:
            raise RuntimeError(f"probed: {edit[0]!r} not found once")
        text = text.replace(*edit)
    cu.write_text(fp.instrumented(text, probes))
    return cu, ()


def entries(kernel: str, lib=None):
    """(launch, plan) entry points of ``kernel``: the port's own library,
    or the build of this checkout's source at path ``lib``."""
    from ray_tpu_torch.ops import _build
    plan = {"bundle": "rt_bundle_plan", "pull": "rt_pull_plan",
            "topk": "rt_topk_plan", "broadcast": "rt_fanout_plan"}[kernel]
    if lib is None:
        return _build.load(kernel), _build.load(kernel, plan)
    return _build.entry(lib, kernel), _build.entry(lib, kernel, plan)


def old_entry(name: str, lib_path: Path):
    fn_name, argtypes = OLD_SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(lib_path)), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def callers(name, arrays, other, lib=None):
    """(this, against or None, wrapper): each a function of no arguments
    that runs one launch on the problem's device tensors and returns its
    outputs; `this` and `against` call the entry points directly (`this`
    those of the build at path ``lib``, the port's own by default), and
    `wrapper` the port's wrapper."""
    import torch

    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import pull_kernel as pk
    from ray_tpu_torch.scheduling.contract import threshold_fp
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = torch.int32
    t = [torch.tensor(a, device=dev) for a in arrays
         if isinstance(a, np.ndarray)]
    if name == "bundles":
        entry, plan = entries("bundle", lib)
        thr = threshold_fp(None)
        n, r = arrays[0].shape
        p, b = arrays[4].shape
        valid = t[4].contiguous()
        strat = t[5].to(i32).contiguous()
        out = (ctypes.c_longlong * 5)()
        assert plan(n, r, p, b, out) == 0
        lists = torch.empty(max(out[3], 1), dtype=i32, device=dev)
        cols = torch.empty(max(out[4], 1), dtype=i32, device=dev)

        def this():
            # the entry point as `against` calls its own: outputs made
            # here, the plan and scratch made once
            rows = torch.empty((p, b), dtype=i32, device=dev)
            ok = torch.empty(p, dtype=torch.bool, device=dev)
            new_avail = torch.empty_like(t[1])
            err = entry(*[x.data_ptr() for x in t[:4]], valid.data_ptr(),
                        strat.data_ptr(), n, r, p, b, int(thr),
                        rows.data_ptr(), ok.data_ptr(), new_avail.data_ptr(),
                        lists.data_ptr(), cols.data_ptr(), stream)
            assert err == 0, f"this: CUDA error {err}"
            return rows, ok, new_avail

        def wrapper():
            return bk.schedule_bundle_groups(*t[:4], valid, strat, thr)

        def against():
            rows = torch.empty((p, b), dtype=i32, device=dev)
            ok = torch.empty(p, dtype=torch.bool, device=dev)
            new_avail = torch.empty_like(t[1])
            err = other(*[x.data_ptr() for x in t[:4]], valid.data_ptr(),
                        strat.data_ptr(), n, r, p, b, int(thr),
                        rows.data_ptr(), ok.data_ptr(), new_avail.data_ptr(),
                        stream)
            assert err == 0, f"against: CUDA error {err}"
            return rows, ok, new_avail
    elif name == "topk":
        from fractions import Fraction

        from ray_tpu_torch.ops import locality_kernel as lk
        entry, plan = entries("topk", lib)
        totals, _avail, _mask, reqs = arrays[:4]
        (n, r), g = totals.shape, reqs.shape[0]
        gm = t[5] if len(t) > 5 else None
        frac = Fraction(TOPK_K_FRAC).limit_denominator(1 << 16)
        k_args = (int(threshold_fp(None)), TOPK_K_ABS, frac.numerator,
                  frac.denominator)
        draws = torch.tensor(lk.topk_draws(TOPK_SEED, TOPK_ROUND, g),
                             device=dev)
        out = (ctypes.c_longlong * 3)()
        assert plan(n, r, g, out) == 0
        blocks = torch.empty(max(out[1], 1), dtype=i32, device=dev)
        cols = torch.empty(max(out[2], 1), dtype=i32, device=dev)
        ins = [t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(), None,
               t[3].data_ptr(), t[4].data_ptr(),
               None if gm is None else gm.data_ptr(), draws.data_ptr(),
               n, r, g, *k_args]

        def this():
            counts = torch.empty((g, n + 1), dtype=i32, device=dev)
            new_avail = torch.empty_like(t[1])
            err = entry(*ins, counts.data_ptr(), new_avail.data_ptr(),
                        blocks.data_ptr(), cols.data_ptr(), stream)
            assert err == 0, f"this: CUDA error {err}"
            return counts, new_avail

        def wrapper():
            return lk.schedule_grouped_topk(*t[:5], gm, *k_args, draws)

        def against():
            counts = torch.empty((g, n + 1), dtype=i32, device=dev)
            new_avail = torch.empty_like(t[1])
            err = other(*ins, counts.data_ptr(), new_avail.data_ptr(),
                        stream)
            assert err == 0, f"against: CUDA error {err}"
            return counts, new_avail
    elif name == "broadcast":
        from ray_tpu_torch.ops import broadcast_kernel as bc
        entry, _plan = entries("broadcast", lib)
        root, fanout = arrays[3], arrays[4]
        n = arrays[0].shape[0]
        t = t[:3]

        def call(fn, label):
            parent = torch.empty(n, dtype=i32, device=dev)
            order = torch.empty(n, dtype=i32, device=dev)
            cl = ctypes.c_int(0)
            err = fn(t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(), n,
                     root, fanout, parent.data_ptr(), order.data_ptr(),
                     ctypes.addressof(cl), stream)
            assert err == 0, f"{label}: CUDA error {err}"
            return parent, order

        def this():
            return call(entry, "this")

        def wrapper():
            return bc.plan_fanout(t[0], t[1], root, fanout, t[2])

        def against():
            return call(other, "against")
    else:
        entry, plan = entries("pull", lib)
        r, n = arrays[0].shape
        out = (ctypes.c_longlong * 2)()
        assert plan(r, n, out) == 0
        scratch = torch.empty(max(out[1], 1), dtype=i32, device=dev)

        def this():
            src = torch.empty(r, dtype=i32, device=dev)
            cost = torch.empty(r, dtype=i32, device=dev)
            err = entry(*[x.data_ptr() for x in t], r, n, scratch.data_ptr(),
                        src.data_ptr(), cost.data_ptr(), stream)
            assert err == 0, f"this: CUDA error {err}"
            return src, cost

        def wrapper():
            return pk.choose_sources(*t)

        def against():
            gathered = torch.empty((max(r, 1), n), dtype=i32, device=dev)
            src = torch.empty(r, dtype=i32, device=dev)
            cost = torch.empty(r, dtype=i32, device=dev)
            err = other(*[x.data_ptr() for x in t], r, n,
                        gathered.data_ptr(), src.data_ptr(),
                        cost.data_ptr(), stream)
            assert err == 0, f"against: CUDA error {err}"
            return src, cost
    return this, (against if other is not None else None), wrapper


def oracle(name, arrays):
    """The reference a row is held to: the numpy oracle (bundles, pulls),
    the CPU run (top-k) or the plain version on the card (the broadcast
    plan: its oracle takes ~an hour at 8192)."""
    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import pull_kernel as pk
    if name == "bundles":
        return bk.schedule_bundle_groups_oracle(*arrays)
    if name == "topk":
        from ray_tpu_torch.ops import locality_kernel as lk
        totals, avail, mask, reqs, counts = arrays[:5]
        return lk.schedule_grouped_topk_np(
            totals, avail, mask, reqs, counts, TOPK_SEED, TOPK_ROUND,
            arrays[5] if len(arrays) > 5 else None, k_abs=TOPK_K_ABS,
            k_frac=TOPK_K_FRAC, device="cpu")
    if name == "broadcast":
        import torch

        from ray_tpu_torch.ops import broadcast_kernel as bc
        member, bw, infl, root, fanout = arrays
        t = [torch.tensor(a, device="cuda") for a in (member, bw, infl)]
        return tuple(x.cpu().numpy() for x in bc.plan_fanout_plain(
            t[0], t[1], root, fanout, t[2]))
    with np.errstate(over="ignore", divide="ignore"):
        return pk.choose_sources_oracle(*arrays)


def topk_problems():
    """The topk phase's problems: the beat width and the contract's
    limit (per-class masks, negative avail)."""
    return {"1000x8x64": cs.build_problem(seed=3),
            "8192x16x128": cs.limit_problem()}


def broadcast_entry_problem(seed=0):
    """A plan of the broadcast phase's size: 72 rows, every one a member,
    each link at a seeded rate of ``chip_smoke.BCAST_LINKS_MBPS``."""
    rng = np.random.default_rng(seed)
    n = BCAST_ENTRY_ROWS
    bw = rng.choice(cs.BCAST_LINKS_MBPS, size=(n, n)).astype(np.int32)
    np.fill_diagonal(bw, 0)
    return np.ones(n, bool), bw, np.zeros(n, np.int32)


def broadcast_problems(problems):
    """(member, bw, inflight, root, fan-out) of each timed plan."""
    out = {size: (*prob["broadcast"], 0, cs.DP_FANOUT)
           for size, prob in problems.items() if size != "threshold"}
    out["uniform"] = (*cs.broadcast_uniform(), 0, cs.DP_FANOUT)
    out[BCAST_ENTRY_ROWS] = (*broadcast_entry_problem(), 0,
                             BCAST_ENTRY_FANOUT)
    return out


def same(got, want):
    return all(np.array_equal(g.cpu().numpy(), np.asarray(w))
               for g, w in zip(got, want))


def turns(fns, n_turns, reps):
    """{label: [ms, ...]}: (against, this, this, against) n_turns times."""
    out = {}
    for _ in range(n_turns):
        for label in ("against", "this", "this", "against"):
            if fns.get(label) is not None:
                out.setdefault(label, []).append(
                    cs.cuda_ms(fns[label], reps=reps))
    return out


def dense_pulls(n, r=256, seed=5):
    """Every row holds every object: each request passes the list cap."""
    rng = np.random.default_rng(seed)
    loc = np.ones((r, n), bool)
    bw = rng.integers(0, 50_000, size=(n, n)).astype(np.int32)
    bw[rng.random((n, n)) < 0.05] = 0
    dest = rng.integers(0, n, size=r).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=r).astype(np.int32)
    infl = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    return loc, bw, dest, sizes, infl


PROGRAMS = {"bundle": "bundles", "pull": "pulls", "topk": "topk",
            "broadcast": "broadcast"}
PROBES = {"bundle": (BUNDLE_PROBES, BUNDLE_PHASES),
          "pull": (PULL_PROBES, PULL_PHASES),
          "topk": (TOPK_PROBES, TOPK_PHASES),
          "broadcast": (BROADCAST_PROBES, BROADCAST_PHASES)}


def chain_unit(name, arrays, want, ms):
    """(unit, steps, ns a step) of one row: the chain's unit is a bundle
    step (the key passes the inputs need), a pull, a top-k class step or
    a broadcast attach."""
    if name == "bundles":
        steps = len(cs.bundle_key_passes(*arrays))
        return "step", steps, ms * 1e6 / steps
    if name == "pulls":
        return "pull", arrays[0].shape[0], ms * 1e6 / arrays[0].shape[0]
    if name == "topk":
        return "class", arrays[3].shape[0], ms * 1e6 / arrays[3].shape[0]
    attaches = max(int((np.asarray(want[0]) >= 0).sum()), 1)
    return "attach", attaches, ms * 1e6 / attaches


def phases(programs, refs, libs, other=None) -> bool:
    """Cycles by phase (thread 0 of CTA 0) of one call of each probed
    build ``libs`` ({kernel: library path}) at each size, and of the
    older commit's broadcast plan where ``other`` holds its probed build;
    True where each equals its reference."""
    import torch
    ok = True
    runs = [(k, lib, PROBES[k][1], "") for k, lib in libs.items()]
    if other is not None:
        runs.append(("broadcast", other, PARENT_BROADCAST_PHASES,
                     "against_"))
    for kernel, lib, labels, tag in runs:
        name = PROGRAMS[kernel]
        for size, arrays in programs[name].items():
            if tag:
                this = callers(name, arrays, old_entry(kernel, lib))[1]
            else:
                this = callers(name, arrays, None, lib)[0]
            read = ctypes.CDLL(str(lib)).rt_phases
            read.argtypes = [ctypes.c_void_p]
            read.restype = ctypes.c_int
            buf = (ctypes.c_ulonglong * 8)()
            this()                               # warm-up, then zeroed
            torch.cuda.synchronize()
            assert read(buf) == 0
            got = this()
            torch.cuda.synchronize()
            assert read(buf) == 0
            row = {"program": f"{tag}{name}_phases", "size": size,
                   "equals_oracle": same(got, refs[name, size]),
                   "cycles": dict(zip(labels, list(buf)))}
            ok &= row["equals_oracle"]
            cs.emit(row)
    return ok


def sweep(name, kernel, programs, refs, libs, args) -> bool:
    """A kernel's rows a CTA (its cluster), one -DRT_ROWS_PER_CTA build a
    row, at each size."""
    from ray_tpu_torch.ops import broadcast_kernel as bc
    from ray_tpu_torch.ops import bundle_kernel as bk
    ok = True
    for size, arrays in programs[name].items():
        want = refs[name, size]
        for per_cta, lib in libs.items():
            fn = callers(name, arrays, None, lib)[0]
            if kernel == "bundle":
                out = (ctypes.c_longlong * 5)()
                n, r = arrays[0].shape
                assert entries("bundle", lib)[1](n, r, *arrays[4].shape,
                                                 out) == 0
                layout = bk.LAYOUTS[out[0]]
            else:
                out = (ctypes.c_longlong * 2)()
                assert entries("broadcast", lib)[1](arrays[0].shape[0],
                                                    out) == 0
                layout = bc.FANOUT_LAYOUTS[out[0]]
            row = {"program": f"{name}_per_cta", "size": size,
                   "per_cta": per_cta, "layout": layout, "cluster": out[1],
                   "equals_oracle": same(fn(), want),
                   "ms": [cs.cuda_ms(fn, reps=args.reps)
                          for _ in range(args.turns)]}
            unit, _count, ns = chain_unit(name, arrays, want, min(row["ms"]))
            row[f"ns_a_{unit}"] = ns
            ok &= row["equals_oracle"]
            cs.emit(row)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="an older commit's ops/csrc directory")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2,
                    help="repeat (against, this, this, against) N times")
    ap.add_argument("--phases", action="store_true",
                    help="cycles by phase from copies with clock probes")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS), help="the kernels to time")
    ap.add_argument("--wrapper-host", action="store_true",
                    help="only the host ms of a steady beat's beat_rows "
                         "call through the wrapper (one JSON line)")
    ap.add_argument("--package-root", type=Path, default=None,
                    help="import ray_tpu_torch from this tree")
    ap.add_argument("--against-only", action="store_true",
                    help="the beat kernels: time DIR's build alone")
    args = ap.parse_args()
    if args.package_root is not None:
        sys.path.insert(0, str(args.package_root.resolve()))
    import torch
    if args.wrapper_host:
        if not torch.cuda.is_available():
            print("dataplane_routes.py: no CUDA device", file=sys.stderr)
            return 1
        import ray_tpu_torch
        cs.emit({"program": "beat_rows_wrapper_host",
                 "package": str(Path(ray_tpu_torch.__file__).parent),
                 "host_ms": wrapper_host(turns_=args.turns)})
        return 0

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import broadcast_kernel as bc
    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import locality_kernel as lk
    if not torch.cuda.is_available():
        print("dataplane_routes.py: no CUDA device", file=sys.stderr)
        return 1
    kernels = [k for k in KERNELS if k in args.kernels]
    cs.emit({"nvidia_smi": cs.phase_device(), "against": str(args.against),
             "kernels": kernels})
    beat = [k for k in kernels if k in BEAT_KERNELS]
    ok = beat_kernel_rows(beat, args, args.against) if beat else True
    kernels = [k for k in kernels if k not in BEAT_KERNELS]
    if not kernels:
        return 0 if ok else 1
    # every build at once: the port's, the older commit's, the -D sweeps
    # and the probed copies
    _build.build(kernels)
    csrc = _build._CSRC
    specs, slots = [], {}

    def add(key, more):
        slots[key] = (len(specs), len(more))
        specs.extend(more)

    if "bundle" in kernels:
        add("bundle", [(csrc / "bundle.cu", (f"-DRT_ROWS_PER_CTA={k}",))
                       for k in ROWS_PER_CTA])
    if "pull" in kernels:
        add("one_warp", [(csrc / "pull.cu",
                          (f"-DRT_LIST_CAP={ONE_WARP_CAP}",))])
    if "broadcast" in kernels:
        add("broadcast", [(csrc / "broadcast.cu",
                           (f"-DRT_ROWS_PER_CTA={k}",))
                          for k in FANOUT_ROWS_PER_CTA])
    if args.phases:
        add("probed", [probed(k, PROBES[k][0]) for k in kernels])
        if args.against is not None and "broadcast" in kernels:
            add("probed_against", [probed("broadcast",
                                          PARENT_BROADCAST_PROBES,
                                          args.against)])
    if args.against is not None:
        add("against", [(args.against / _build.SOURCES[k], ())
                        for k in kernels])
    libs = _build.build_variants(specs)

    def built(key):
        at, count = slots.get(key, (0, 0))
        return libs[at:at + count]

    other = {PROGRAMS[k]: old_entry(k, lib)
             for k, lib in zip(kernels, built("against"))}
    programs = {}
    if {"bundle", "pull", "broadcast"} & set(kernels):
        problems = {
            cs.DP_NODES: cs.dataplane_problem(),
            cs.DP_LIMIT_NODES: cs.dataplane_problem(n=cs.DP_LIMIT_NODES,
                                                    seed=1),
            "threshold": cs.dataplane_problem(groups=cs.DP_THRESHOLD_GROUPS,
                                              pulls=cs.DP_THRESHOLD_PULLS,
                                              seed=2)}
        for k in ("bundle", "pull"):
            if k in kernels:
                programs[PROGRAMS[k]] = {size: prob[PROGRAMS[k]]
                                         for size, prob in problems.items()}
        if "broadcast" in kernels:
            programs["broadcast"] = broadcast_problems(problems)
        del problems
    if "topk" in kernels:
        programs["topk"] = topk_problems()
    refs = {}
    for kernel in kernels:
        name = PROGRAMS[kernel]
        for size, arrays in programs[name].items():
            this, against, wrapper = callers(name, arrays, other.get(name))
            want = refs[name, size] = oracle(name, arrays)
            row = {"program": name, "size": size,
                   "this_equals_oracle": same(this(), want),
                   "wrapper_equals_oracle": same(wrapper(), want)}
            if against is not None:
                row["against_equals_oracle"] = same(against(), want)
            torch.cuda.synchronize()
            row.update(turns({"this": this, "against": against},
                             args.turns, args.reps))
            # the wrapper around the same launch (checks, plan, scratch)
            row["wrapper"] = [cs.cuda_ms(wrapper, reps=args.reps)
                              for _ in range(args.turns)]
            unit, count, ns = chain_unit(name, arrays, want, min(row["this"]))
            row.update({"steps": count, f"ns_a_{unit}": ns})
            if against is not None:
                row[f"against_ns_a_{unit}"] = chain_unit(
                    name, arrays, want, min(row["against"]))[2]
                row["speedup"] = (sum(row["against"]) / len(row["against"])) \
                    / (sum(row["this"]) / len(row["this"]))
            if name == "bundles":
                row.update(layout=bk.schedule_bundle_groups.last_layout,
                           cluster=bk.schedule_bundle_groups.last_cluster)
            elif name == "topk":
                row["layout"] = lk.schedule_grouped_topk.last_layout
            elif name == "broadcast":
                row.update(layout=bc.plan_fanout.last_layout,
                           cluster=bc.plan_fanout.last_cluster)
            ok &= row["this_equals_oracle"] and \
                row["wrapper_equals_oracle"] and \
                row.get("against_equals_oracle", True)
            cs.emit(row)
    # bundle.cu's and broadcast.cu's rows a CTA, swept at each size
    if "bundle" in kernels:
        ok &= sweep("bundles", "bundle", programs, refs,
                    dict(zip(ROWS_PER_CTA, built("bundle"))), args)
    if "broadcast" in kernels:
        ok &= sweep("broadcast", "broadcast", programs, refs,
                    dict(zip(FANOUT_ROWS_PER_CTA, built("broadcast"))), args)
    if args.phases:
        ok &= phases(programs, refs, dict(zip(kernels, built("probed"))),
                     (built("probed_against") or [None])[0])
    # pull.cu's list cap: dense holders, the CTA past the cap vs one warp
    if "pull" in kernels:
        (one_warp_lib,) = built("one_warp")
        for n in (cs.DP_NODES, cs.DP_LIMIT_NODES):
            arrays = dense_pulls(n)
            want = oracle("pulls", arrays)
            row = {"program": "pulls_dense", "size": n,
                   "requests": len(arrays[2])}
            for label, lib in (("cap", None), ("one_warp", one_warp_lib)):
                fn = callers("pulls", arrays, None, lib)[0]
                row[f"{label}_equals_oracle"] = same(fn(), want)
                ok &= row[f"{label}_equals_oracle"]
                row[f"{label}_ms"] = [cs.cuda_ms(fn, reps=args.reps)
                                      for _ in range(args.turns)]
                row[f"{label}_ns_a_pull"] = min(row[f"{label}_ms"]) * 1e6 \
                    / len(arrays[2])
            cs.emit(row)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

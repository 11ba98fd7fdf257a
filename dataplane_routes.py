"""Time the data-plane kernels on the card, against another build.

    python3 dataplane_routes.py [--against DIR] [--reps N] [--turns N]
                                [--phases] [--kernels NAME ...]

Builds this checkout's ``ray_tpu_torch/ops/csrc/bundle.cu``, ``pull.cu``,
``topk.cu`` and ``broadcast.cu`` (through the wrappers) and, with
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
  and the layout.

Then constants of the kernels, each from builds that override it with
``-D``: bundle.cu's and broadcast.cu's rows a CTA (``RT_ROWS_PER_CTA``,
which sets their clusters) swept at each size, and pull.cu's list cap
(``RT_LIST_CAP``) on dense holders at 1000 and 8192 nodes, where every
request passes the cap of 128 and the CTA reduces it, against a cap of
8192, where one warp loops over every list.  ``--phases`` builds copies
of the sources with ``clock64`` probes inserted at anchor lines (as
``flash_phases.py`` does for flash attention) and prints cycles by phase
of thread 0 of CTA 0 at each size.  Each row is one JSON line on stdout,
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
KERNELS = ("bundle", "pull", "topk", "broadcast")
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


def probed(kernel: str, probes, csrc=None) -> tuple[Path, tuple]:
    """A copy of ``kernel``'s source (this checkout's, or the one in
    ``csrc``) with ``probes`` and ``flash_phases.READER``, beside a copy
    of its header."""
    from ray_tpu_torch.ops import _build
    out = _build.BUILD_DIR.parent / ("dataplane_phases" if csrc is None
                                     else "dataplane_phases_against")
    csrc = _build._CSRC if csrc is None else csrc
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(csrc / "contract.cuh", out / "contract.cuh")
    cu = out / _build.SOURCES[kernel]
    cu.write_text(fp.instrumented(
        (csrc / _build.SOURCES[kernel]).read_text(), probes))
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
    args = ap.parse_args()
    import torch

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
    ok = True
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

"""Time the gang-placement and pull-source kernels on the card, against
another build.

    python3 dataplane_routes.py [--against DIR] [--reps N] [--turns N]
                                [--phases]

Builds this checkout's ``ray_tpu_torch/ops/csrc/bundle.cu`` and
``pull.cu`` (through the wrappers) and, with ``--against``, the two
sources of an older commit in DIR (its ``csrc`` directory, unpacked from
``git archive`` into an ignored directory, ``contract.cuh`` beside them),
built with the same nvcc flags and called through the C entry points
they had before the kernels' redesign (``OLD_SIGNATURES``).  For every
row (the ``dataplane`` phase's problems of ``chip_smoke.py``: 1000 nodes,
8192 nodes, and the runtime thresholds' sizes) it checks both builds
against the numpy oracle, bit for bit, and times them in turns
(against, this, this, against; ``--turns`` times over, each turn the p50
of ``--reps`` launches, CUDA events), beside ns a pull or a bundle step
(the key passes of ``chip_smoke.bundle_key_passes``) and the bundle
layout.  Then two constants of the kernels, each from builds that
override it with ``-D``: bundle.cu's rows a CTA (``RT_ROWS_PER_CTA``,
which sets its cluster) swept at each size, and pull.cu's list cap
(``RT_LIST_CAP``) on dense holders at 1000 and 8192 nodes, where every
request passes the cap of 128 and the CTA reduces it, against a cap of
8192, where one warp loops over every list.  ``--phases`` builds copies
of both sources with ``clock64`` probes inserted at anchor lines (as
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
# the C entry points of the kernels as PR 10 wrote them (b84b189)
OLD_SIGNATURES = {
    "bundle": ("rt_bundle_schedule",
               [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "pull": ("rt_pull_choose", [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P]),
}
ROWS_PER_CTA = (1024, 512, 256, 128, 64)    # the sweep; the source's is 128
ONE_WARP_CAP = 8192                         # a list as long as N can be


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


def probed(kernel: str, probes) -> tuple[Path, tuple]:
    """A copy of this checkout's ``kernel`` source with ``probes`` and
    ``flash_phases.READER``, beside a copy of its header."""
    from ray_tpu_torch.ops import _build
    csrc = _build._CSRC
    out = _build.BUILD_DIR.parent / "dataplane_phases"
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
    plan = {"bundle": "rt_bundle_plan", "pull": "rt_pull_plan"}[kernel]
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
    t = [torch.tensor(a, device=dev) for a in arrays]
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
    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import pull_kernel as pk
    if name == "bundles":
        return bk.schedule_bundle_groups_oracle(*arrays)
    with np.errstate(over="ignore", divide="ignore"):
        return pk.choose_sources_oracle(*arrays)


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


def phases(problems, libs) -> bool:
    """Cycles by phase (thread 0 of CTA 0) of one call of each probed
    build ``libs`` ({kernel: library path}) at each size; True where each
    equals its oracle."""
    import torch
    ok = True
    for size, prob in problems.items():
        for name, kernel, labels in (("bundles", "bundle", BUNDLE_PHASES),
                                     ("pulls", "pull", PULL_PHASES)):
            arrays = prob[name]
            this = callers(name, arrays, None, libs[kernel])[0]
            read = ctypes.CDLL(str(libs[kernel])).rt_phases
            read.argtypes = [ctypes.c_void_p]
            read.restype = ctypes.c_int
            buf = (ctypes.c_ulonglong * 8)()
            this()                               # warm-up, then zeroed
            torch.cuda.synchronize()
            assert read(buf) == 0
            got = this()
            torch.cuda.synchronize()
            assert read(buf) == 0
            row = {"program": f"{name}_phases", "size": size,
                   "equals_oracle": same(got, oracle(name, arrays)),
                   "cycles": dict(zip(labels, list(buf)))}
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
    args = ap.parse_args()
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import bundle_kernel as bk
    if not torch.cuda.is_available():
        print("dataplane_routes.py: no CUDA device", file=sys.stderr)
        return 1
    cs.emit({"nvidia_smi": cs.phase_device(), "against": str(args.against)})
    # every build at once: the port's, the older commit's, the -D sweeps
    # and the probed copies
    _build.build(["bundle", "pull"])
    csrc = _build._CSRC
    specs = [(csrc / "bundle.cu", (f"-DRT_ROWS_PER_CTA={k}",))
             for k in ROWS_PER_CTA]
    specs.append((csrc / "pull.cu", (f"-DRT_LIST_CAP={ONE_WARP_CAP}",)))
    if args.phases:
        specs += [probed("bundle", BUNDLE_PROBES), probed("pull", PULL_PROBES)]
    if args.against is not None:
        specs += [(args.against / "bundle.cu", ()),
                  (args.against / "pull.cu", ())]
    libs = _build.build_variants(specs)
    per_cta_libs = dict(zip(ROWS_PER_CTA, libs))
    one_warp_lib = libs[len(ROWS_PER_CTA)]
    rest = libs[len(ROWS_PER_CTA) + 1:]
    probe_libs = {}
    if args.phases:
        probe_libs, rest = {"bundle": rest[0], "pull": rest[1]}, rest[2:]
    other = {}
    if args.against is not None:
        other = {"bundles": old_entry("bundle", rest[0]),
                 "pulls": old_entry("pull", rest[1])}
    problems = {
        cs.DP_NODES: cs.dataplane_problem(),
        cs.DP_LIMIT_NODES: cs.dataplane_problem(n=cs.DP_LIMIT_NODES, seed=1),
        "threshold": cs.dataplane_problem(groups=cs.DP_THRESHOLD_GROUPS,
                                          pulls=cs.DP_THRESHOLD_PULLS,
                                          seed=2)}
    ok = True
    for size, prob in problems.items():
        for name in ("bundles", "pulls"):
            arrays = prob[name]
            this, against, wrapper = callers(name, arrays, other.get(name))
            want = oracle(name, arrays)
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
            ms = min(row["this"])
            if name == "bundles":
                steps = len(cs.bundle_key_passes(*arrays))
                row.update(layout=bk.schedule_bundle_groups.last_layout,
                           cluster=bk.schedule_bundle_groups.last_cluster,
                           steps=steps, ns_a_step=ms * 1e6 / steps)
                if against is not None:
                    row["against_ns_a_step"] = \
                        min(row["against"]) * 1e6 / steps
            else:
                r = arrays[0].shape[0]
                row["ns_a_pull"] = ms * 1e6 / r
                if against is not None:
                    row["against_ns_a_pull"] = min(row["against"]) * 1e6 / r
            if against is not None:
                row["speedup"] = (sum(row["against"]) / len(row["against"])) \
                    / (sum(row["this"]) / len(row["this"]))
            ok &= row["this_equals_oracle"] and \
                row["wrapper_equals_oracle"] and \
                row.get("against_equals_oracle", True)
            cs.emit(row)
    # bundle.cu's rows a CTA (its cluster), swept at each size
    for size, prob in problems.items():
        arrays = prob["bundles"]
        want = oracle("bundles", arrays)
        steps = len(cs.bundle_key_passes(*arrays))
        n, r = arrays[0].shape
        for per_cta, lib in per_cta_libs.items():
            fn = callers("bundles", arrays, None, lib)[0]
            out = (ctypes.c_longlong * 5)()
            assert entries("bundle", lib)[1](n, r, *arrays[4].shape, out) == 0
            row = {"program": "bundles_per_cta", "size": size,
                   "per_cta": per_cta, "layout": bk.LAYOUTS[out[0]],
                   "cluster": out[1], "equals_oracle": same(fn(), want),
                   "ms": [cs.cuda_ms(fn, reps=args.reps)
                          for _ in range(args.turns)]}
            row["ns_a_step"] = min(row["ms"]) * 1e6 / steps
            ok &= row["equals_oracle"]
            cs.emit(row)
    if args.phases:
        ok &= phases(problems, probe_libs)
    # pull.cu's list cap: dense holders, the CTA past the cap vs one warp
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

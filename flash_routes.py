"""Time flash attention's routes on the card, against another build.

    python3 flash_routes.py [--against PATH/flash_attention.cu] [--reps N]
                            [--turns N] [--dtype bfloat16|float32]
                            [--back-to-back] [--shape B,T,H,D ...]
                            [--split]

Builds this checkout's ``ray_tpu_torch/ops/csrc/flash_attention.cu`` and,
with ``--against``, a second source of the same C entry point (an older
commit's, unpacked from ``git archive`` into an ignored directory), with
the same nvcc flags.  For every row of ROWS it checks each build against
the plain version within ``chip_smoke.FLASH_TOL`` and times both in turns
(against, this, this, against; ``--turns`` times over, each turn the p50
of ``--reps`` launches, or with ``--back-to-back`` their mean, launched
with no wait between them, so that no host gap or idle clock enters a
short row) with CUDA events, beside
``scaled_dot_product_attention`` (timed here, used nowhere in the port),
the backend it ran on, the plain PyTorch version's time and the row's
bound (f32: three TF32 products, the FMA bound beside it).  ``--dtype``
keeps the rows of one dtype; ``--shape`` (repeatable) times those
shapes, causal and not, in place of ROWS.  A row the older build refuses (16-bit
inputs past D = 512 before the cluster routes) says so in
``against_refused`` and is timed on this build alone; where the older
build's route table says its caller widened 16-bit inputs to f32 (code
6), they are widened and the output rounded back, inside the timed call,
as that build's wrapper did.  ``--split`` adds this build's device ms a
call by kernel (``torch.profiler``'s trace over three calls; null where
the trace holds no device events).  Each row is one JSON line on stdout,
after one with the card's name and power limit.  Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import sys
from pathlib import Path

import chip_smoke as cs

# (dtype, causal, b, t, h, d): the per-route sweep (B=2 H=4 T=1024; D =
# 1088 and 1600: the two-pass routes, ``flash_wide_kernel`` for f32 in a
# build older than them), the headline, the full-card rows past D = 128,
# 16-bit and f32, and f32 at the headline shape; the full-card rows take
# D = 576 (the two-pass routes)
ROWS = ([("bfloat16", c, 2, 1024, 4, d) for d in (160, 256, 320, 512, 1088)
         for c in (False, True)]
        + [("float32", c, 2, 1024, 4, d) for d in (256, 320, 512, 1600)
           for c in (False, True)]
        + [("float32", c, 2, 1024, 16, 64) for c in (False, True)]
        + [("bfloat16", True, 2, 4096, 16, 128)]
        + [("float32", c, 2, 4096, 16, 128) for c in (False, True)]
        + [(dtype, c, b, t, h, d) for dtype in ("bfloat16", "float32")
           for b, t, h, d in cs.FLASH_WIDE_PATHS for c in (False, True)])


# the kernels of route codes the current library no longer gives (codes
# are not given again), for an older build's rows: 4 and 5 the cluster
# routes of 16-bit inputs at 576-1024 and of f32 at 576-1536; 6 16-bit
# inputs past 1024, widened to f32 by the caller
RETIRED_ROUTES = {4: "flash_cluster16_kernel", 5: "flash_cluster32_kernel",
                  6: "widened to f32"}
WIDEN = 6


def caller(library):
    """What ``ops.flash_attention`` does around the launch (pad to the
    kernel width, the original D's scale, the two-pass route's score
    scratch, cut back), for the flash attention library at path
    ``library``: this build's, or an older one whose entry point takes no
    scratch, or whose caller widened 16-bit inputs past 1024 to f32 (its
    route code 6: widened here, rounded back after).  The scratch-less
    branch serves only builds from before the two-pass route (they lack
    ``rt_flash_scratch_bytes`` and ran route 3 on ``flash_wide_kernel``),
    to time that route against the FMA kernel it replaced; every later
    build takes the scratch."""
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import _DTYPE_CODE, kernel_width

    fn = _build.entry(library, "flash_attention")
    route_of = _build.entry(library, "flash_attention", "rt_flash_route")
    scratch_of = None
    if hasattr(ctypes.CDLL(str(library)), "rt_flash_scratch_bytes"):
        scratch_of = _build.entry(library, "flash_attention",
                                  "rt_flash_scratch_bytes")
    else:                               # no scratch argument
        fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]

    def call(q, k, v, causal):
        b, t, h, d = q.shape
        dtype = q.dtype
        width = kernel_width(d)
        if width != d:
            q, k, v = (torch.nn.functional.pad(x, (0, width - d))
                       for x in (q, k, v))
        if route_of(width, _DTYPE_CODE[dtype]) == WIDEN:
            q, k, v = (x.float() for x in (q, k, v))
        out = torch.empty_like(q)
        code = _DTYPE_CODE[q.dtype]
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, t, h, width, code, int(causal), 1.0 / math.sqrt(d)]
        if scratch_of is not None:
            n = scratch_of(b, t, h, width, code)
            scratch = (torch.empty(n, dtype=torch.uint8, device=q.device)
                       if n > 0 else None)
            args.append(None if scratch is None else scratch.data_ptr())
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash attention: CUDA error {err}")
        return (out if width == d else out[..., :d]).to(dtype)
    return call


def kernel_split_ms(fn, calls: int = 3):
    """Device ms a call by kernel name (the name cut at its template
    arguments) over ``calls`` calls of ``fn`` after one warm-up, from
    the profiler's raw trace events; None where it holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        found = re.search(r"\w+_kernel", e.name())
        name = found.group(0) if found else e.name()[:60]
        split[name] = split.get(name, 0.0) + e.duration_ns() / 1e6 / calls
    return split or None


def back_to_back_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of ``reps`` calls of ``fn`` queued with no wait between
    them, between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch import ops
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import (_DTYPE_CODE, _ROUTES,
                                                   kernel_width)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another flash_attention.cu to time beside this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=1,
                    help="repeat (against, this, this, against) N times")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="time only the rows of this dtype")
    ap.add_argument("--back-to-back", action="store_true",
                    help="time each turn's launches as one stretch")
    ap.add_argument("--split", action="store_true",
                    help="add this build's device ms by kernel")
    ap.add_argument("--shape", action="append", default=None,
                    metavar="B,T,H,D",
                    help="time this shape (both dtypes, causal and not) "
                         "in place of ROWS; repeatable")
    args = ap.parse_args()
    rows = ROWS if not args.shape else [
        (dtype, c, *map(int, shape.split(",")))
        for dtype in ("bfloat16", "float32") for shape in args.shape
        for c in (False, True)]
    if not torch.cuda.is_available():
        print("flash_routes: needs a GPU", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    _build.build(["flash_attention"])
    this = caller(_build.lib_path("flash_attention"))
    other = other_route = None
    if args.against:
        lib = _build.build_variants([(args.against, ())])[0]
        other = caller(lib)
        other_route = _build.entry(lib, "flash_attention", "rt_flash_route")
        # an older build's names: retired codes, and code 3 was the FMA
        # kernel before the two-pass route
        other_names = {**_ROUTES, **RETIRED_ROUTES}
        if not hasattr(ctypes.CDLL(str(lib)), "rt_flash_scratch_bytes"):
            other_names[3] = "flash_wide_kernel"
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.emit({"nvidia_smi": smi, "against": str(args.against)})
    for dtype_name, causal, b, t, h, d in rows:
        if args.dtype not in (None, dtype_name):
            continue
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn((b, t, h, d), generator=gen,
                               device="cuda").to(dtype)
                   for _ in range(3))
        row = {"dtype": dtype_name, "causal": causal,
               "shape": [b, t, h, d], "width": kernel_width(d),
               "route": _ROUTES[_build.load("flash_attention",
                                            "rt_flash_route")(
                   kernel_width(d), _DTYPE_CODE[dtype])]}
        if other_route is not None:
            code = other_route(kernel_width(d), _DTYPE_CODE[dtype])
            row["against_route"] = other_names[code] if code >= 0 else None
        want, limit = cs.flash_limit(q, k, v, causal)
        against = other
        for key, fn in (("err_over_limit", this),
                        ("against_err_over_limit", other)):
            if fn is None:
                continue
            try:
                got = fn(q, k, v, causal)
            except RuntimeError as err:
                if fn is this:
                    raise
                row["against_refused"] = str(err)   # an older build's
                against = None
                continue
            row[key] = float(((got.float() - want).abs() / limit).max())
            del got
        del want, limit
        fns = [("ms", this)] if against is None else [
            ("against_ms", against), ("ms", this), ("ms", this),
            ("against_ms", against)]
        fns *= args.turns
        timer = back_to_back_ms if args.back_to_back else cs.cuda_ms
        for key, fn in fns:
            row.setdefault(key, []).append(timer(
                lambda: fn(q, k, v, causal), reps=args.reps))
        if args.split:
            row["split_ms"] = kernel_split_ms(lambda: this(q, k, v, causal))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_ms"] = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=args.reps)
        row["sdpa_backend"] = cs.sdpa_backend(qt, kt, vt, causal)
        row["plain_ms"] = cs.cuda_ms(lambda: ops.flash_attention_plain(
            q, k, v, causal=causal), reps=args.reps)
        row["bound_ms"], row["bound_by"], _ = cs.flash_bound(q, causal)
        ms = sum(row["ms"]) / len(row["ms"])
        row["bound_share"] = row["bound_ms"] / ms
        fma_ms = cs.flash_fma_bound_ms(q, causal)
        if fma_ms is not None:
            row["bound_of"] = "3 TF32 products"
            row["fma_bound_ms"] = fma_ms
            row["fma_bound_share"] = fma_ms / ms
        row["vs_sdpa"] = ms / row["sdpa_ms"]
        if against is not None:
            row["speedup"] = (sum(row["against_ms"])
                              / len(row["against_ms"])) / ms
        cs.emit(row)
        if not (row["err_over_limit"] <= 1.0 and
                row.get("against_err_over_limit", 0.0) <= 1.0):
            raise AssertionError(f"flash attention out of its limit: "
                                 f"{row}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time flash attention's routes on the card, against another build.

    python3 flash_routes.py [--against PATH/flash_attention.cu] [--reps N]
                            [--turns N] [--dtype bfloat16|float32]
                            [--back-to-back]

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
keeps the rows of one dtype.  Each row is one JSON line on stdout, after
one with the card's name and power limit.  Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import chip_smoke as cs

# (dtype, causal, b, t, h, d): the per-route sweep (B=2 H=4 T=1024), the
# f32 routes, the headline, the full-card rows past D = 128, 16-bit
# and f32, f32 at the headline shape, and f32 past D = 512 (the FMA
# route, ``flash_wide_kernel``; 16-bit raises there)
ROWS = ([("bfloat16", c, 2, 1024, 4, d) for d in (160, 256, 320, 512)
         for c in (False, True)]
        + [("float32", c, 2, 1024, 4, d) for d in (256, 320, 512)
           for c in (False, True)]
        + [("float32", c, 2, 1024, 16, 64) for c in (False, True)]
        + [("bfloat16", True, 2, 4096, 16, 128)]
        + [("float32", c, 2, 4096, 16, 128) for c in (False, True)]
        + [(dtype, c, b, t, h, d) for dtype in ("bfloat16", "float32")
           for b, t, h, d in cs.FLASH_WIDE_PATHS for c in (False, True)]
        + [("float32", c, 2, 4096, 8, 576) for c in (False, True)])


def caller(fn):
    """What ``ops.flash_attention`` does around the launch (pad to the
    kernel width, the original D's scale, cut back), for entry ``fn``."""
    import torch

    from ray_tpu_torch.ops.flash_attention import _DTYPE_CODE, kernel_width

    def call(q, k, v, causal):
        b, t, h, d = q.shape
        width = kernel_width(d)
        if width != d:
            q, k, v = (torch.nn.functional.pad(x, (0, width - d))
                       for x in (q, k, v))
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, h, width, _DTYPE_CODE[q.dtype], int(causal),
                 1.0 / math.sqrt(d),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash attention: CUDA error {err}")
        return out if width == d else out[..., :d]
    return call


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_routes: needs a GPU", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    _build.build(["flash_attention"])
    this = caller(_build.load("flash_attention"))
    other = caller(_build.entry(_build.build_variants(
        [(args.against, ())])[0], "flash_attention")) if args.against \
        else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.emit({"nvidia_smi": smi, "against": str(args.against)})
    for dtype_name, causal, b, t, h, d in ROWS:
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
        want, limit = cs.flash_limit(q, k, v, causal)
        for key, fn in (("err_over_limit", this),
                        ("against_err_over_limit", other)):
            if fn is not None:
                row[key] = float(((fn(q, k, v, causal).float() - want)
                                  .abs() / limit).max())
        del want, limit
        fns = [("ms", this)] if other is None else [
            ("against_ms", other), ("ms", this), ("ms", this),
            ("against_ms", other)]
        fns *= args.turns
        timer = back_to_back_ms if args.back_to_back else cs.cuda_ms
        for key, fn in fns:
            row.setdefault(key, []).append(timer(
                lambda: fn(q, k, v, causal), reps=args.reps))
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
        if other is not None:
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

"""Pull-source selection: the PullManager's bandwidth cost model, in PyTorch.

The port of ``ray_tpu/ops/pull_kernel.py``.  One batch of R pending pull
requests is scored over the (N x N) node-bandwidth matrix on the
raylet's device.  For request r the candidate score is the source's
bandwidth to the destination derated by the bytes already in flight
FROM that source --

    eff[r, n] = loc[r, n] & bw[n, dest[r]] > 0
                  ? max(bw[n, dest[r]] // (1 + infl[n] // UNIT), 1) : 0
    src[r]    = argmax_n eff[r, n]          (first max -> deterministic)
    cost[r]   = size_kb[r] // eff[src[r]]   (~ transfer ms)
    infl[src[r]] += size_kb[r]              (sequential greedy)

The in-flight update runs sequentially over the batch (a ``fori_loop``
in the JAX package, a Python loop over tensor ops here, with no host
sync inside): two pulls of one activation round spread across replicas
instead of piling onto the same source.  All arithmetic is int32 (sizes
in KB, bandwidth in MB/s, cost in ~ms), bit-identical to the numpy
oracle below.

On a card the loop is the hand-written CUDA kernel ``csrc/pull.cu``: one
cooperative launch whose warps compact every request's candidates (the
holders with a live link to the destination, in column order, at most
the kernel's list cap a request, ``kernel_plan``), then one warp of one
CTA runs the chain with ``infl`` in shared memory, the lists streamed
ahead of it; a request with more candidates is reduced by the rest of
that CTA.  Eagerly it was
~23 launches a request.  The plain PyTorch version
``choose_sources_plain`` keeps the loop; CPU tensors take it.

Where ``infl`` has wrapped below zero the divisor ``1 + infl // UNIT``
can be 0 or negative.  The JAX program's eff is then 1 (``raw // d`` is
at most -1, and XLA's quotient by 0 is negative too), and so is the
port's: the plain version divides by a divisor clamped to 1 and selects
1 there, since torch raises on an integer division by zero.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..scheduling.contract import MAX_NODES

_NO_SOURCE_COST = np.int32(2**31 - 1)
# in-flight derating unit: one "stream equivalent" per 32 MB already
# queued on a source's uplink (4 default-size chunks) — eff bandwidth is
# the fair share bw / (1 + streams)
_INFLIGHT_UNIT_KB = np.int32(32 * 1024)
_I32 = torch.int32


def choose_sources(loc, bw, dest, sizes_kb, inflight_kb):
    """Pick the best transfer source for each pull request.

    loc: (R, N) bool — which nodes hold a copy of each object.
    bw: (N, N) int32 — bandwidth in MB/s, ``bw[src, dst]``.
    dest: (R,) int32 — requesting node row per request.
    sizes_kb: (R,) int32 — object size in KB.
    inflight_kb: (N,) int32 — KB already assigned to transfers FROM
        each node (this batch's own picks accumulate on top).

    Returns (src (R,) int32, cost (R,) int32): ``src = -1`` when no node
    holds the object; cost ~ transfer milliseconds (KB // eff-MB/s), used
    for activation ordering.  Deterministic: ties break to the lowest row.

    CPU tensors take ``choose_sources_plain``; CUDA tensors launch the
    hand-written kernel (``csrc/pull.cu``, 1 <= N <= MAX_NODES, with a
    scratch of R lists of candidate pairs, ``kernel_plan``) or raise, and
    count the launch in ``choose_sources.launches``.
    """
    if bw.device.type == "cpu":
        return choose_sources_plain(loc, bw, dest, sizes_kb, inflight_kb)
    if bw.device.type != "cuda":
        raise ValueError(f"choose_sources: unsupported device {bw.device}")
    r, n = loc.shape
    dev = bw.device
    for name, t, dtype, shape in (("loc", loc, torch.bool, (r, n)),
                                  ("bw", bw, _I32, (n, n)),
                                  ("dest", dest, _I32, (r,)),
                                  ("sizes_kb", sizes_kb, _I32, (r,)),
                                  ("inflight_kb", inflight_kb, _I32, (n,))):
        if t.device != dev or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"choose_sources: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"choose_sources: N={n} (the kernel takes 1 <= N "
                         f"<= {MAX_NODES})")
    from . import _build
    _cap, scratch_ints = kernel_plan(r, n)
    # one scratch (the lists, then the counts) and one output (src, cost)
    scratch = torch.empty(max(scratch_ints, 1), dtype=_I32, device=dev)
    src, cost = torch.empty((2, r), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        err = _build.load("pull")(
            loc.data_ptr(), bw.data_ptr(), dest.data_ptr(),
            sizes_kb.data_ptr(), inflight_kb.data_ptr(), r, n,
            scratch.data_ptr(), src.data_ptr(), cost.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pull")
    choose_sources.launches += 1
    return src, cost


@functools.lru_cache(maxsize=256)
def kernel_plan(r, n):
    """``csrc/pull.cu``'s list cap for N columns and its scratch ints for
    R requests (the library's ``rt_pull_plan``; kept per shape)."""
    import ctypes

    from . import _build
    out = (ctypes.c_longlong * 2)()
    err = _build.load("pull", "rt_pull_plan")(r, n, out)
    if err != 0:
        raise ValueError(f"choose_sources: no plan for R={r} N={n}")
    return int(out[0]), int(out[1])


choose_sources.launches = 0


def choose_sources_plain(loc, bw, dest, sizes_kb, inflight_kb):
    """The plain PyTorch version of ``choose_sources``, on either device:
    the request loop with the JAX program's arithmetic."""
    r = loc.shape[0]
    dev = bw.device
    bw_to_dest = bw[:, dest.long()].T.contiguous()        # (R, N)
    infl = inflight_kb.to(_I32).clone()
    src = torch.full((r,), -1, dtype=_I32, device=dev)
    cost = torch.full((r,), int(_NO_SOURCE_COST), dtype=_I32, device=dev)
    for i in range(r):
        raw = bw_to_dest[i]
        div = 1 + infl // int(_INFLIGHT_UNIT_KB)
        eff = torch.where(
            loc[i] & (raw > 0),
            torch.where(div > 0, torch.clamp_min(raw // div.clamp_min(1), 1),
                        1),
            0).to(_I32)
        s = torch.argmax(eff).reshape(1)
        best = eff.gather(0, s)[0]
        picked = best > 0
        size = sizes_kb[i]
        src[i] = torch.where(picked, s[0].to(_I32), -1)
        cost[i] = torch.where(picked, size // best.clamp_min(1),
                              int(_NO_SOURCE_COST))
        infl.index_add_(0, torch.where(picked, s, 0),
                        torch.where(picked, size, 0).to(_I32)[None])
    return src, cost


def choose_sources_oracle(loc: np.ndarray, bw: np.ndarray, dest: np.ndarray,
                          sizes_kb: np.ndarray,
                          inflight_kb: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Numpy oracle — bit-identical to ``choose_sources``."""
    loc = np.asarray(loc, dtype=bool)
    bw = np.asarray(bw, dtype=np.int32)
    dest = np.asarray(dest, dtype=np.int32)
    sizes_kb = np.asarray(sizes_kb, dtype=np.int32)
    n = bw.shape[0]
    infl = np.zeros(n, dtype=np.int32)
    if inflight_kb is not None:
        infl[:] = np.asarray(inflight_kb, dtype=np.int32)
    r = loc.shape[0]
    src = np.full(r, -1, dtype=np.int32)
    cost = np.full(r, _NO_SOURCE_COST, dtype=np.int32)
    bw_to_dest = bw[:, dest].T
    for i in range(r):
        raw = bw_to_dest[i]
        eff = np.where(
            loc[i] & (raw > 0),
            np.maximum(raw // (1 + infl // _INFLIGHT_UNIT_KB),
                       np.int32(1)),
            np.int32(0)).astype(np.int32)
        s = np.int32(eff.argmax())
        best = eff[s]
        if best > 0:
            src[i] = s
            cost[i] = sizes_kb[i] // max(np.int32(1), best)
            infl[s] += sizes_kb[i]
    return src, cost


def choose_sources_np(loc, bw, dest, sizes_kb, inflight_kb=None,
                      device=None):
    """Host wrapper: numpy in/out, compute on ``device`` (the GPU unless
    the caller asks for the CPU).  Unlike the JAX wrapper it does not pad
    the request axis: padding only kept XLA's compile cache stable."""
    dev = resolve_device(device)
    loc = np.asarray(loc, dtype=bool)
    n = loc.shape[1]
    infl = np.zeros(n, dtype=np.int32)
    if inflight_kb is not None:
        infl[:] = inflight_kb

    def put(x, dtype):
        return torch.tensor(np.ascontiguousarray(x, dtype), device=dev)

    src, cost = choose_sources(put(loc, bool), put(bw, np.int32),
                               put(dest, np.int32), put(sizes_kb, np.int32),
                               put(infl, np.int32))
    # the host wrapper's result: its one deliberate readback
    return src.cpu().numpy(), cost.cpu().numpy()  # rtlint: disable=W6

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
oracle below.  There is no kernel yet; PERF.md has the loop's times.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

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
    """
    r = loc.shape[0]
    dev = bw.device
    bw_to_dest = bw[:, dest.long()].T.contiguous()        # (R, N)
    infl = inflight_kb.to(_I32).clone()
    src = torch.full((r,), -1, dtype=_I32, device=dev)
    cost = torch.full((r,), int(_NO_SOURCE_COST), dtype=_I32, device=dev)
    for i in range(r):
        raw = bw_to_dest[i]
        eff = torch.where(
            loc[i] & (raw > 0),
            torch.clamp_min(raw // (1 + infl // int(_INFLIGHT_UNIT_KB)), 1),
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
    return src.cpu().numpy(), cost.cpu().numpy()

"""Broadcast tree shaping: the fan-out plan, in PyTorch.

The port of ``ray_tpu/ops/broadcast_kernel.py``.  1->N weight
distribution wants a relay tree whose shape follows the node-bandwidth
matrix, the same input the pull cost model (``ops/pull_kernel.py``)
scores sources against.  Given the member set, the root, a fan-out cap
and the current per-node uplink load, it emits a parent assignment plus
the attach order (an earlier-attached member starts receiving, and
therefore relaying, sooner).  On a card the N steps are the hand-written
CUDA kernel ``csrc/broadcast.cu``: one launch of one CTA (or of a
thread-block cluster) that keeps each parent's best child, rescans only
the two rows an attach changed, and refreshes a row that lost its best
child only when its stale key surfaces.  Eagerly it was ~37 launches a
step.  The plain PyTorch
version ``plan_fanout_plain`` keeps the loop (a ``fori_loop`` in the JAX
package); CPU tensors take it.

Greedy one-attach-per-step construction, all int32:

    step k:  eff[p, c] = covered[p] & member[c] & ~covered[c]
                           & children[p] < fanout & bw[p, c] > 0
               ? max(bw[p, c] // ((1 + children[p]
                                     + inflight_kb[p] // UNIT)
                                  * (1 + depth[p])), 1) : 0
             (p*, c*) = argmax eff   (flat row-major, first max)
             parent[c*] = p*; order[c*] = k
             depth[c*] = depth[p*] + 1; children[p*] += 1

Two deratings shape the tree.  The load term (children + uplink
in-flight, same 32 MB stream unit as the pull cost model) makes a
parent that already feeds children progressively less attractive, so
the tree spreads across the topology instead of every member chaining
off the root.  The depth term charges a parent for its own distance
from the root — without it a freshly attached leaf always out-scores
a once-loaded parent and a uniform-bandwidth matrix degenerates to an
N-deep chain; with it the same matrix yields a balanced fanout-F tree
(depth ~log_F N).  Ties break to the lowest (parent, child) pair —
deterministic on both backends.  The CPU oracle below is bit-identical
(same discipline as the hybrid/pull programs).

Where ``inflight_kb`` has wrapped below zero the denominator can be 0 or
negative.  The JAX program's eff is then 1 (``bw // d`` is at most -1,
and XLA's quotient by 0 is negative too), and so is the port's: the
plain version divides by a denominator clamped to 1 and selects 1 there,
since torch raises on an integer division by zero.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..scheduling.contract import MAX_NODES

# same stream-equivalent unit as the pull cost model: every 32 MB in
# flight on a node's uplink counts as one extra concurrent stream
_INFLIGHT_UNIT_KB = np.int32(32 * 1024)
_I32 = torch.int32


def plan_fanout(member, bw, root, fanout, inflight_kb):
    """Shape the broadcast tree.

    member: (N,) bool — broadcast participants (root included).
    bw: (N, N) int32 — bandwidth in MB/s, ``bw[src, dst]``.
    root: int — row of the origin replica.
    fanout: int — max children per node (>= 1).
    inflight_kb: (N,) int32 — KB already in flight FROM each node.

    Returns (parent (N,) int32, order (N,) int32): ``parent[c]`` is the
    node c relays from (-1 for the root and non-members), ``order[c]``
    the attach step (0-based; -1 for the root and non-members).  A
    member left unattached (unreachable bandwidth row) keeps -1/-1.

    CPU tensors take ``plan_fanout_plain``; CUDA tensors launch the
    hand-written kernel (``csrc/broadcast.cu``, 1 <= N <= MAX_NODES) or
    raise, and count the launch in ``plan_fanout.launches``;
    ``plan_fanout.last_cluster`` is the launch's CTAs and
    ``plan_fanout.last_layout`` its layout (``fanout_plan``).
    """
    if bw.device.type == "cpu":
        return plan_fanout_plain(member, bw, root, fanout, inflight_kb)
    if bw.device.type != "cuda":
        raise ValueError(f"plan_fanout: unsupported device {bw.device}")
    from . import _build

    n = member.shape[0]
    dev = bw.device
    for name, t, dtype, shape in (("member", member, torch.bool, (n,)),
                                  ("bw", bw, _I32, (n, n)),
                                  ("inflight_kb", inflight_kb, _I32, (n,))):
        if t.device != dev or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"plan_fanout: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"plan_fanout: N={n} (the kernel takes 1 <= N <= "
                         f"{MAX_NODES})")
    root = int(root)
    if not -n <= root < n:
        raise IndexError(f"plan_fanout: root {root} out of range for N={n}")
    root %= n
    # children < fanout with 0 <= children < N: any fanout past N is N
    fanout = min(max(int(fanout), 0), n)
    parent = torch.empty(n, dtype=_I32, device=dev)
    order = torch.empty(n, dtype=_I32, device=dev)
    cluster = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _build.load("broadcast")(
            member.data_ptr(), bw.data_ptr(), inflight_kb.data_ptr(), n,
            root, fanout, parent.data_ptr(), order.data_ptr(),
            ctypes.addressof(cluster),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "broadcast")
    plan_fanout.launches += 1
    plan_fanout.last_cluster = cluster.value
    plan_fanout.last_layout = FANOUT_LAYOUTS[int(cluster.value > 1)]
    return parent, order


plan_fanout.launches = 0
plan_fanout.last_cluster = None
plan_fanout.last_layout = None

FANOUT_LAYOUTS = ("cta", "cluster")


def fanout_plan(n):
    """``csrc/broadcast.cu``'s layout for N rows: (layout name, CTAs),
    from N alone (the library's ``rt_fanout_plan``): every row in one CTA
    (``cta``) or the rows over a thread-block cluster (``cluster``)."""
    from . import _build
    out = (ctypes.c_longlong * 2)()
    err = _build.load("broadcast", "rt_fanout_plan")(int(n), out)
    if err != 0:
        raise ValueError(f"plan_fanout: N={n} (the kernel takes 1 <= N <= "
                         f"{MAX_NODES})")
    return FANOUT_LAYOUTS[out[0]], int(out[1])


def plan_fanout_plain(member, bw, root, fanout, inflight_kb):
    """The plain PyTorch version of ``plan_fanout``, on either device:
    the step loop with the JAX program's arithmetic."""
    n = member.shape[0]
    dev = bw.device
    units = inflight_kb.to(_I32) // int(_INFLIGHT_UNIT_KB)
    covered = torch.zeros((n,), dtype=torch.bool, device=dev)
    covered[int(root)] = True
    children = torch.zeros((n,), dtype=_I32, device=dev)
    depth = torch.zeros((n,), dtype=_I32, device=dev)
    parent = torch.full((n,), -1, dtype=_I32, device=dev)
    order = torch.full((n,), -1, dtype=_I32, device=dev)
    bw_pos = bw > 0
    for k in range(n):
        # (p, c) eligibility + load- and depth-derated uplink score
        can_parent = covered & (children < fanout)          # (N,)
        want_child = member & ~covered                      # (N,)
        denom = ((1 + children + units) * (1 + depth))[:, None]
        eff = torch.where(
            can_parent[:, None] & want_child[None, :] & bw_pos,
            torch.where(denom > 0,
                        torch.clamp_min(bw // denom.clamp_min(1), 1), 1),
            0).reshape(-1)
        idx = torch.argmax(eff).reshape(1)
        p, c = idx // n, idx % n
        hit = eff.gather(0, idx)[0] > 0
        parent.index_copy_(0, c, torch.where(hit, p.to(_I32),
                                             parent.gather(0, c)))
        order.index_copy_(0, c, torch.where(hit, k, order.gather(0, c)))
        depth.index_copy_(0, c, torch.where(hit, depth.gather(0, p) + 1,
                                            depth.gather(0, c)))
        covered.index_copy_(0, c, covered.gather(0, c) | hit)
        children.index_add_(0, p, hit.to(_I32).reshape(1))
    return parent, order


def plan_fanout_oracle(member: np.ndarray, bw: np.ndarray, root: int,
                       fanout: int,
                       inflight_kb: np.ndarray | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Numpy oracle — bit-identical to ``plan_fanout``."""
    member = np.asarray(member, dtype=bool)
    bw = np.asarray(bw, dtype=np.int32)
    n = member.shape[0]
    units = np.zeros(n, dtype=np.int32)
    if inflight_kb is not None:
        units[:] = np.asarray(inflight_kb,
                              dtype=np.int32) // _INFLIGHT_UNIT_KB
    covered = np.zeros(n, dtype=bool)
    covered[root] = True
    children = np.zeros(n, dtype=np.int32)
    depth = np.zeros(n, dtype=np.int32)
    parent = np.full(n, -1, dtype=np.int32)
    order = np.full(n, -1, dtype=np.int32)
    for k in range(n):
        can_parent = covered & (children < fanout)
        want_child = member & ~covered
        denom = ((1 + children + units) * (1 + depth)).astype(np.int32)
        eff = np.where(
            can_parent[:, None] & want_child[None, :] & (bw > 0),
            np.maximum(bw // denom[:, None], np.int32(1)),
            np.int32(0)).astype(np.int32)
        idx = int(eff.reshape(-1).argmax())
        p, c = idx // n, idx % n
        if eff.reshape(-1)[idx] <= 0:
            continue        # matches the device no-op step
        parent[c] = p
        order[c] = k
        depth[c] = depth[p] + 1
        covered[c] = True
        children[p] += 1
    return parent, order


def plan_fanout_np(member, bw, root: int, fanout: int, inflight_kb=None,
                   device=None):
    """Host wrapper: numpy in/out, compute on ``device`` (the GPU unless
    the caller asks for the CPU).  Unlike the JAX wrapper it does not pad
    the node axis: padding only kept XLA's compile cache stable, and the
    padded steps were no-ops."""
    dev = resolve_device(device)
    member = np.asarray(member, dtype=bool)
    n = member.shape[0]
    infl = np.zeros(n, dtype=np.int32)
    if inflight_kb is not None:
        infl[:] = inflight_kb

    def put(x, dtype):
        return torch.tensor(np.ascontiguousarray(x, dtype), device=dev)

    parent, order = plan_fanout(put(member, bool), put(bw, np.int32),
                                int(root), int(fanout), put(infl, np.int32))
    return parent.cpu().numpy(), order.cpu().numpy()

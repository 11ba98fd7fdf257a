"""Soft-locality placement: the localized water-fill.

The port of ``ray_tpu/ops/locality_kernel.py::schedule_grouped_localized``:
per scheduling class, a preferred node row (the raylet's locality row)
takes the WHOLE class when it is feasible for it (the host's
NodeAffinity-soft semantics: tasks queue there; availability only gates
how much of the node is consumed), and the class falls through to the
ordinary water-fill when it is not.  Bit-identical to the sequential
host path (``hybrid_kernel.schedule_group_host(pref_row=...)``).

The kernel is the hand-written water-fill (``csrc/waterfill.cu``) in its
localized mode: ``waterfill_scan(..., pref_rows=...)`` decides each
class's preferred row while it sets the class up and debits it on the
thread that owns the row, so a localized class costs the same cluster
exchanges as any other.  Eagerly each class would be ~45 launches.  What
bounds it is what bounds the water-fill: the latency of each class's
chain of cluster exchanges, not bytes or operations (the preference adds
one warp's reads of the preferred row while the class is set up).  The
plain PyTorch version is ``waterfill_scan_plain(..., pref_rows=...)``;
CPU tensors take it.

``schedule_grouped_topk`` is the contention-spread mode
(``scheduler_top_k_fraction`` > 0): each class's tasks spread EVENLY over
its k best-keyed feasible nodes, the remainder rotated by one draw per
(seed, round, group).  The class loop (a ``lax.scan`` in the JAX
package) is the hand-written CUDA kernel ``csrc/topk.cu``, one launch of
one CTA: eagerly it was ~90 launches a class.  Its plain PyTorch version
``schedule_grouped_topk_plain`` is a host loop over the classes of a few
tensor ops each (keys, a stable argsort, the even split, the cap at
availability), no host sync inside; CPU tensors take it.  The JAX
function draws its rotation
as ``randint(fold_in(fold_in(PRNGKey(seed), round), g), (), 0, k)``;
``jax.random`` is threefry2x32, a pure uint32 function, so the host
computes the same bits in numpy (``topk_draws``: randint's two words per
group, which do not depend on k, under ``jax_threefry_partitionable``,
the default since JAX 0.5) and the device finishes randint's span
arithmetic once k is known (``_randint_offset``), without a sync.  The
port is therefore bit-exact against the JAX function: the same
``counts`` and ``new_avail`` on the same (seed, round), on the CPU and on
the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..scheduling.contract import MAX_NODES
from .hybrid_kernel import (_BIG, _I32, _INF_KEY, _floordiv, _keys_one_req,
                            waterfill_scan)


def schedule_grouped_localized(totals, avail, node_mask, group_reqs,
                               group_counts, group_masks, pref_rows,
                               thr_fp, extra_mask=None):
    """Like ``schedule_grouped`` with per-group soft locality.

    pref_rows: (G,) int32 preferred node row per group, -1 = none.
    extra_mask: optional (N,) bool beat-scoped node filter (suspect
    soft-mask) ANDed into node_mask.  Returns (counts (G, N+1),
    new_avail).  CUDA tensors launch the water-fill kernel in its
    localized mode (counted in ``waterfill_scan.localized_launches``) or
    raise; CPU tensors take the plain version."""
    if extra_mask is not None:
        node_mask = node_mask & extra_mask
    return waterfill_scan(totals, avail, node_mask, group_reqs,
                          group_counts, group_masks, thr_fp, False,
                          pref_rows)


def schedule_grouped_localized_np(totals, avail, node_mask, group_reqs,
                                  group_counts, pref_rows,
                                  group_masks=None, thr_fp=None,
                                  spread_threshold=None,
                                  extra_mask=None, device=None):
    """Host wrapper: numpy in/out, compute on ``device`` (the GPU unless
    the caller asks for the CPU)."""
    from ..scheduling.contract import threshold_fp
    if thr_fp is None:
        thr_fp = threshold_fp(spread_threshold)
    dev = resolve_device(device)
    g, n = group_reqs.shape[0], totals.shape[0]
    if group_masks is None:
        group_masks = np.ones((g, n), dtype=bool)

    def put(x, dtype):
        return torch.tensor(np.ascontiguousarray(x, dtype), device=dev)

    counts, new_avail = schedule_grouped_localized(
        put(totals, np.int32), put(avail, np.int32), put(node_mask, bool),
        put(group_reqs, np.int32), put(group_counts, np.int32),
        put(group_masks, bool), put(pref_rows, np.int32), int(thr_fp),
        None if extra_mask is None else put(extra_mask, bool))
    # the host wrapper's result: its one deliberate readback
    return counts.cpu().numpy(), new_avail.cpu().numpy()  # rtlint: disable=W6


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = 0xFFFFFFFF


def _threefry2x32(k0, k1, x0, x1):
    """``jax._src.prng._threefry2x32_lowering`` in numpy: the threefry
    2x32 hash (20 rounds) of the counter words (x0, x1) under the key
    (k0, k1), elementwise over uint32 arrays."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def topk_draws(seed, round_index, n_groups) -> np.ndarray:
    """The rotation draws of one top-k round: (n_groups, 2) int64, the two
    uint32 words (high, low) that ``jax.random.randint`` reduces to each
    group's offset, for the key ``fold_in(fold_in(PRNGKey(seed),
    round_index), g)``.  With ``jax_threefry_partitionable`` (JAX's
    default): ``PRNGKey(s)`` is (0, s mod 2**32) without x64;
    ``fold_in(key, d)`` hashes the counter (0, d); ``split`` hashes (0, 0)
    and (0, 1); ``random_bits`` of a scalar is the xor of the hash of
    (0, 0).  A group's words depend only on (seed, round, group)."""
    u = np.uint32
    g = np.arange(int(n_groups), dtype=u)
    zero = np.zeros_like(g)
    one = np.zeros(1, dtype=u)                    # arrays wrap silently
    k = _threefry2x32(one, one + u(int(seed) & _U32), one,
                      one + u(int(round_index) & _U32))
    k = _threefry2x32(k[0], k[1], zero, g)                # fold_in(., g)
    words = []
    for half in (0, 1):                                   # split(key)
        sub = _threefry2x32(k[0], k[1], zero, zero + u(half))
        bits = _threefry2x32(sub[0], sub[1], zero, zero)  # random_bits
        words.append(bits[0] ^ bits[1])
    return np.stack(words, axis=1).astype(np.int64)


def _randint_offset(words, k):
    """``jax.random._randint``'s reduction of its two words to [0, k) for
    int32 (``span`` = k >= 1): ``(hi % span) * m + lo % span`` modulo
    span, where ``m = (2**16 % span)**2 % span``, each product and sum
    wrapped to uint32 as JAX does (past span 2**16 the square wraps to
    0); the int64 tensors hold every intermediate before the mask."""
    span = k.to(torch.int64)
    mult = ((65536 % span) * (65536 % span) & _U32) % span
    t = (words[0] % span) * mult & _U32
    t = (t + words[1] % span) & _U32
    return (t % span).to(_I32)


def schedule_grouped_topk(totals, avail, node_mask, group_reqs,
                          group_counts, group_masks, thr_fp, k_abs,
                          k_frac_num, k_frac_den, draws, extra_mask=None):
    """Top-k contention spread (see the module docstring).

    k per group = min(feasible, max(k_abs,
    ceil(feasible * k_frac_num / k_frac_den))).  Each group's tasks
    spread evenly over its k best keys, the remainder rotated by
    ``_randint_offset(draws[g], k)`` (``draws``: (G, 2) int64 from
    ``topk_draws``);
    consuming placements are capped by per-node availability (tasks
    beyond capacity queue without consuming).  Returns (counts (G, N+1),
    new_avail) on the inputs' device.

    CPU tensors take ``schedule_grouped_topk_plain``; CUDA tensors launch
    the hand-written kernel (``csrc/topk.cu``, N <= MAX_NODES) or raise,
    and count the launch in ``schedule_grouped_topk.launches``."""
    if totals.device.type == "cpu":
        return schedule_grouped_topk_plain(
            totals, avail, node_mask, group_reqs, group_counts, group_masks,
            thr_fp, k_abs, k_frac_num, k_frac_den, draws, extra_mask)
    if totals.device.type != "cuda":
        raise ValueError(f"schedule_grouped_topk: unsupported device "
                         f"{totals.device}")
    from . import _build

    n, r = totals.shape
    g = group_reqs.shape[0]
    for name, t, dtype, shape in (
            ("totals", totals, _I32, (n, r)),
            ("avail", avail, _I32, (n, r)),
            ("node_mask", node_mask, torch.bool, (n,)),
            ("group_reqs", group_reqs, _I32, (g, r)),
            ("group_counts", group_counts, _I32, (g,)),
            ("group_masks", group_masks, torch.bool, (g, n)),
            ("draws", draws, torch.int64, (g, 2)),
            ("extra_mask", extra_mask, torch.bool, (n,))):
        if t is None and name in ("group_masks", "extra_mask"):
            continue
        if t.device != totals.device or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"schedule_grouped_topk: {name} must be a contiguous "
                f"{dtype} tensor of shape {shape} on {totals.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if n > MAX_NODES or r < 1:
        raise ValueError(f"schedule_grouped_topk: N={n} R={r} (the kernel "
                         f"takes 1 <= R and N <= {MAX_NODES})")
    if int(k_frac_den) < 1:
        raise ValueError("schedule_grouped_topk: k_frac_den must be >= 1")
    layout, block_ints, col_ints = topk_plan(n, r, g)
    dev = totals.device
    counts = torch.empty((g, n + 1), dtype=_I32, device=dev)
    new_avail = torch.empty_like(avail)
    blocks = torch.empty(max(block_ints, 1), dtype=_I32, device=dev)
    cols = torch.empty(max(col_ints, 1), dtype=_I32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = _build.load("topk")(
            ptr(totals), ptr(avail), ptr(node_mask), ptr(extra_mask),
            ptr(group_reqs), ptr(group_counts), ptr(group_masks),
            ptr(draws), n, r, g, int(thr_fp), int(k_abs), int(k_frac_num),
            int(k_frac_den), ptr(counts), ptr(new_avail), ptr(blocks),
            ptr(cols), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "topk")
    schedule_grouped_topk.launches += 1
    schedule_grouped_topk.last_layout = layout
    return counts, new_avail


schedule_grouped_topk.launches = 0
schedule_grouped_topk.last_layout = None

TOPK_LAYOUTS = ("shared", "global")


def topk_plan(n, r, g):
    """``csrc/topk.cu``'s layout for N rows x R kinds x G classes:
    (layout name, block scratch ints, column scratch ints), from the
    shape alone (the library's ``rt_topk_plan``): the rows' totals,
    multipliers and avail in shared memory (``shared``) while they fit
    there, else in a global scratch (``global``)."""
    import ctypes

    from . import _build
    out = (ctypes.c_longlong * 3)()
    err = _build.load("topk", "rt_topk_plan")(n, r, g, out)
    if err != 0:
        raise ValueError(f"schedule_grouped_topk: no layout holds N={n} "
                         f"R={r} G={g}")
    return TOPK_LAYOUTS[out[0]], int(out[1]), int(out[2])


def schedule_grouped_topk_plain(totals, avail, node_mask, group_reqs,
                                group_counts, group_masks, thr_fp, k_abs,
                                k_frac_num, k_frac_den, draws,
                                extra_mask=None):
    """The plain PyTorch version of ``schedule_grouped_topk``, on either
    device: the class loop with the JAX program's arithmetic, ~90 small
    launches a class on a card."""
    if extra_mask is not None:
        node_mask = node_mask & extra_mask
    n, dev = totals.shape[0], totals.device
    pos = torch.arange(n, dtype=_I32, device=dev)
    counts = torch.zeros((group_reqs.shape[0], n + 1), dtype=_I32,
                         device=dev)
    av = avail
    for gi in range(group_reqs.shape[0]):
        req, count = group_reqs[gi], group_counts[gi]
        mask = node_mask if group_masks is None \
            else node_mask & group_masks[gi]
        keys = _keys_one_req(totals, av, req, thr_fp, mask)
        nf = (keys != _INF_KEY).sum().to(_I32)
        # ceil(nf * num / den): the brackets matter, -(-x) // d floors
        k = torch.clamp(-_floordiv(-nf * k_frac_num, k_frac_den),
                        min=k_abs)
        k = torch.minimum(k.clamp_min(1), nf.clamp_min(1))
        order = torch.argsort(keys, stable=True)            # best first
        offset = _randint_offset(draws[gi], k)
        base = _floordiv(count, k)
        extra_n = count - base * k
        gets_extra = torch.remainder(pos - offset, k) < extra_n
        per_slot = torch.where(pos < k, base + gets_extra.to(_I32), 0)
        per_slot = torch.where(nf > 0, per_slot, 0).to(_I32)
        alloc = torch.zeros(n, dtype=_I32, device=dev).scatter(
            0, order, per_slot)
        # consume only up to availability (queued tasks don't subtract)
        caps = torch.where((req > 0)[None, :],
                           _floordiv(av, req.clamp_min(1)[None, :]), _BIG)
        consumed = torch.minimum(alloc, caps.amin(dim=1).clamp(0, _BIG))
        av = (av - consumed[:, None] * req[None, :]).to(_I32)
        # no feasible node: the whole class overflows to column n
        counts[gi, :n] = torch.where(nf > 0, alloc, 0)
        counts[gi, n] = torch.where(nf > 0, 0, count)
    return counts, av.clone() if av is avail else av


def schedule_grouped_topk_np(totals, avail, node_mask, group_reqs,
                             group_counts, seed, round_index,
                             group_masks=None, thr_fp=None,
                             spread_threshold=None, k_abs=1,
                             k_frac=0.0, extra_mask=None, device=None):
    """Host wrapper: numpy in/out, compute on ``device`` (the GPU unless
    the caller asks for the CPU); the draws are made here, on the host."""
    from fractions import Fraction

    from ..scheduling.contract import threshold_fp
    if thr_fp is None:
        thr_fp = threshold_fp(spread_threshold)
    dev = resolve_device(device)
    g = group_reqs.shape[0]
    frac = Fraction(k_frac).limit_denominator(1 << 16)

    def put(x, dtype):
        return torch.tensor(np.ascontiguousarray(x, dtype), device=dev)

    counts, new_avail = schedule_grouped_topk(
        put(totals, np.int32), put(avail, np.int32), put(node_mask, bool),
        put(group_reqs, np.int32), put(group_counts, np.int32),
        None if group_masks is None else put(group_masks, bool),
        int(thr_fp), max(int(k_abs), 1), int(frac.numerator),
        max(int(frac.denominator), 1),
        put(topk_draws(seed, round_index, g), np.int64),
        None if extra_mask is None else put(extra_mask, bool))
    # the host wrapper's result: its one deliberate readback
    return counts.cpu().numpy(), new_avail.cpu().numpy()  # rtlint: disable=W6


def _sharded_call(fn, pl, pad, args, n):
    """``fn`` over every node row on the first of ``pl``'s ranks
    (``ShardPlane.call_gathered``), as GSPMD runs an op it cannot
    partition (top-k's argsort); on a card that is the water-fill
    kernel's localized mode.  ``args`` as ``call_gathered`` takes them,
    their node axes padded by ``pad`` mask-False rows; the padding is
    cut from the host results."""
    (counts,), new_avail = pl.call_gathered(fn, *args)
    # the host wrappers' results: their deliberate readbacks
    counts = counts.cpu().numpy()  # rtlint: disable=W6
    new_avail = np.concatenate(
        [a.cpu().numpy() for a in new_avail])  # rtlint: disable=W6
    if pad:
        counts = np.concatenate([counts[:, :n], counts[:, -1:]], axis=1)
        new_avail = new_avail[:n]
    return counts, new_avail


def _pad_rows(pad, totals, avail, node_mask, group_masks, extra_mask):
    if not pad:
        return totals, avail, node_mask, group_masks, extra_mask
    return (np.pad(totals, ((0, pad), (0, 0))),
            np.pad(avail, ((0, pad), (0, 0))), np.pad(node_mask, (0, pad)),
            np.pad(group_masks, ((0, 0), (0, pad))),
            None if extra_mask is None else np.pad(extra_mask, (0, pad)))


def schedule_grouped_localized_sharded_np(totals, avail, node_mask,
                                          group_reqs, group_counts,
                                          pref_rows, group_masks=None,
                                          thr_fp=None,
                                          spread_threshold=None,
                                          extra_mask=None,
                                          n_shards: int = 0,
                                          reduce_mode: str = "auto",
                                          devices=None):
    """Row-sharded twin of ``schedule_grouped_localized_np`` (node rows
    over the ranks of ``ops.shard_reduce``).  The single-device
    function runs on the first rank over every row, and new_avail goes
    back to the ranks; a shard-local localized water-fill is later
    work.  Bit-identical."""
    from ..scheduling.contract import threshold_fp
    from .shard_reduce import gspmd_plane, pad_node_rows
    if thr_fp is None:
        thr_fp = threshold_fp(spread_threshold)
    g, n = group_reqs.shape[0], totals.shape[0]
    if group_masks is None:
        group_masks = np.ones((g, n), dtype=bool)
    pl = gspmd_plane(n_shards, reduce_mode, devices)
    pad = pad_node_rows(n, pl.n_shards)
    totals, avail, node_mask, group_masks, extra_mask = _pad_rows(
        pad, totals, avail, node_mask, group_masks, extra_mask)
    return _sharded_call(
        schedule_grouped_localized, pl, pad,
        ((totals, np.int32), (avail, np.int32),
         (node_mask, bool), (group_reqs, np.int32),
         (group_counts, np.int32), (group_masks, bool),
         (pref_rows, np.int32), int(thr_fp),
         (extra_mask, bool)), n)


def schedule_grouped_topk_sharded_np(totals, avail, node_mask, group_reqs,
                                     group_counts, seed, round_index,
                                     group_masks=None, thr_fp=None,
                                     spread_threshold=None, k_abs=1,
                                     k_frac=0.0, extra_mask=None,
                                     n_shards: int = 0,
                                     reduce_mode: str = "auto",
                                     devices=None):
    """Row-sharded twin of ``schedule_grouped_topk_np`` (the same
    first-rank route and padding as the localized variant; a shard-local
    top-k is later work).  Bit-identical."""
    from fractions import Fraction

    from ..scheduling.contract import threshold_fp
    from .shard_reduce import gspmd_plane, pad_node_rows
    if thr_fp is None:
        thr_fp = threshold_fp(spread_threshold)
    g, n = group_reqs.shape[0], totals.shape[0]
    if group_masks is None:
        group_masks = np.ones((g, n), dtype=bool)
    pl = gspmd_plane(n_shards, reduce_mode, devices)
    pad = pad_node_rows(n, pl.n_shards)
    totals, avail, node_mask, group_masks, extra_mask = _pad_rows(
        pad, totals, avail, node_mask, group_masks, extra_mask)
    frac = Fraction(k_frac).limit_denominator(1 << 16)
    return _sharded_call(
        schedule_grouped_topk, pl, pad,
        ((totals, np.int32), (avail, np.int32),
         (node_mask, bool), (group_reqs, np.int32),
         (group_counts, np.int32), (group_masks, bool),
         int(thr_fp), max(int(k_abs), 1), int(frac.numerator),
         max(int(frac.denominator), 1),
         (topk_draws(seed, round_index, g), np.int64),
         (extra_mask, bool)), n)

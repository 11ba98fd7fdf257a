"""Sequence/context parallelism: ring attention + Ulysses all-to-all.

The port of ``ray_tpu/ops/ring_attention.py``.  The sequence axis of
``(batch, seq, heads, dim)`` tensors is split over a list of ranks
(``torch.device``s: distinct cards, or S ranks on one card or on the
CPU, as ``ops.shard_reduce`` takes them), seq = world x block.

- **Ring attention**: each rank attends its query block against one K/V
  block at a time while the K/V blocks rotate one rank along the ring,
  accumulating with an online softmax.  The rotation is ``.to(next
  rank's device)``: a peer copy between cards, which autograd
  differentiates (an NCCL call would not, and the dry run takes the
  gradient through the ring).
- **Ulysses**: an all-to-all (split and concatenate with peer copies)
  reshards sequence-parallel blocks to HEAD-parallel ones, each rank
  runs ``full_attention`` on its head slice, and a second all-to-all
  reshards back.

The folds are the reference's einsum online softmax in
``torch.einsum``: plain products the reference computes outside any
Pallas kernel, so they stay library calls here (this is not
``ops.flash_attention``).  ``precision="highest"`` (or the reference's
``Precision.HIGHEST``) pins full float32 products inside the function,
whatever the caller set for TF32; on the card TF32 products are off by
~1e-3 relative, past the 2e-5 bar the tests hold these to.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _pinned(precision):
    """Full float32 matmuls for ``precision`` "highest"/"float32"; the
    caller's settings for None/"default"."""
    name = None if precision is None else \
        str(getattr(precision, "name", precision)).lower()
    if name in (None, "default"):
        yield
        return
    if name not in ("highest", "float32"):
        raise ValueError(f"unsupported precision {precision!r}")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _ranks(mesh) -> list:
    from ..device import resolve_device
    return [resolve_device(d) for d in mesh]


def full_attention(q, k, v, causal: bool = False, precision=None):
    """Single-device reference: softmax(QK^T / sqrt(d)) V.

    Shapes ``(batch, seq, heads, dim)``.  ``precision="highest"`` pins
    full float32 products (see the module docstring)."""
    with _pinned(precision):
        scale = 1.0 / np.sqrt(q.shape[-1])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        if causal:
            tq, tk = scores.shape[-2], scores.shape[-1]
            mask = torch.arange(tk, device=q.device)[None, :] > \
                torch.arange(tq, device=q.device)[:, None]
            scores = scores.masked_fill(mask, -torch.inf)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _fold(s, my, world, q, k_blk, v_blk, acc, denom, m, causal):
    """Online-softmax accumulation of one K/V block into rank ``my``'s
    state (the block held after ``s`` rotations is rank ``my - s``'s)."""
    block = q.shape[1]
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    if causal:
        kv_rank = (my - s) % world
        ar = torch.arange(block, device=q.device)
        bad = (kv_rank * block + ar)[None, :] > (my * block + ar)[:, None]
        scores = scores.masked_fill(bad, -torch.inf)   # future keys
    new_m = torch.maximum(m, scores.amax(dim=-1))
    # fully-masked rows keep a -inf max; exp(-inf - -inf) is NaN, so
    # both terms are guarded as the reference guards them
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m, -torch.inf))
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
    denom = denom * corr + p.sum(dim=-1)
    return acc, denom, new_m


def _ring_attention_shard(qs, ks, vs, ranks, causal):
    """The ring over every rank: ``qs``/``ks``/``vs`` are the ranks'
    sequence blocks ``(batch, block, heads, dim)``; returns each rank's
    output block.  World-1 [fold + rotate] rounds, then the last fold,
    so no exchange is wasted at the end."""
    world = len(ranks)
    b, t, h, d = qs[0].shape
    acc = [q.new_zeros((b, h, t, d)) for q in qs]
    denom = [q.new_zeros((b, h, t)) for q in qs]
    m = [q.new_full((b, h, t), -torch.inf) for q in qs]
    k_blk, v_blk = list(ks), list(vs)
    for s in range(world):
        for r in range(world):
            acc[r], denom[r], m[r] = _fold(s, r, world, qs[r], k_blk[r],
                                           v_blk[r], acc[r], denom[r], m[r],
                                           causal)
        if s < world - 1:
            # rotate K/V to the next rank (a peer copy between cards)
            k_blk = [k_blk[(r - 1) % world].to(ranks[r])
                     for r in range(world)]
            v_blk = [v_blk[(r - 1) % world].to(ranks[r])
                     for r in range(world)]
    return [(a / dn[..., None].clamp_min(1e-30)).permute(0, 2, 1, 3)
            for a, dn in zip(acc, denom)]


def _split(x, ranks, dim=1):
    return [c.to(d) for c, d in zip(x.chunk(len(ranks), dim=dim), ranks)]


def ring_attention(q, k, v, *, mesh, causal: bool = False, precision=None):
    """Exact attention with the SEQUENCE axis split over the ranks
    ``mesh`` (a list of devices); inputs/outputs ``(batch, seq, heads,
    dim)`` with seq = world * block, the output on ``q``'s device."""
    ranks = _ranks(mesh)
    if q.shape[1] % len(ranks):
        raise ValueError(f"seq ({q.shape[1]}) must divide over "
                         f"{len(ranks)} ranks")
    with _pinned(precision):
        outs = _ring_attention_shard(_split(q, ranks), _split(k, ranks),
                                     _split(v, ranks), ranks, causal)
    return torch.cat([o.to(q.device) for o in outs], dim=1)


def _a2a(xs, ranks, forward: bool):
    """The all-to-all between layouts, rank ``j`` taking chunk ``j`` of
    every rank in rank order: forward (b, block, H, d) -> (b, seq, H/w,
    d) splits heads and concatenates sequence blocks; backward the
    reverse."""
    split, cat = (2, 1) if forward else (1, 2)
    chunks = [x.chunk(len(ranks), dim=split) for x in xs]
    return [torch.cat([c[j].to(d) for c in chunks], dim=cat)
            for j, d in enumerate(ranks)]


def ulysses_attention(q, k, v, *, mesh, causal: bool = False,
                      precision=None):
    """Exact attention via all-to-all head resharding; requires
    ``heads % world == 0``.  Same layout contract as
    ``ring_attention``."""
    ranks = _ranks(mesh)
    world = len(ranks)
    if q.shape[2] % world != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the mesh "
            f"axis ({world})")
    if q.shape[1] % world:
        raise ValueError(f"seq ({q.shape[1]}) must divide over {world} "
                         f"ranks")
    with _pinned(precision):
        qh, kh, vh = (_a2a(_split(x, ranks), ranks, True) for x in (q, k, v))
        outs = [full_attention(a, b, c, causal=causal)
                for a, b, c in zip(qh, kh, vh)]
        back = _a2a(outs, ranks, False)
    return torch.cat([o.to(q.device) for o in back], dim=1)

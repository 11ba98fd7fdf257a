"""Flash attention as a hand-written CUDA kernel — the single-device op.

The port of ``ray_tpu/ops/flash_attention.py`` (a Pallas TPU kernel):
blocked attention with the online-softmax recurrence, O(T) memory
instead of the O(T^2) score matrix.  The kernel is
``csrc/flash_attention.cu`` (wgmma + TMA on Hopper for f16/bf16, f32
FMA for f32; D in {64, 128}); ``flash_attention_plain`` is the dense
PyTorch version of the same function, which CPU tensors take.

Shapes ``(batch, seq, heads, dim)`` at the public function, as in JAX.
"""

from __future__ import annotations

import math

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KERNEL_DIMS = (64, 128)


def flash_attention_plain(q, k, v, causal: bool = False):
    """Dense softmax(QK^T / sqrt(d)) V in f32 with an optional causal
    mask, cast to the input dtype.  Any head dim."""
    d = q.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        t = q.shape[1]
        dead = torch.ones((t, t), dtype=torch.bool,
                          device=q.device).triu(1)
        s = s.masked_fill(dead, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = False,
                    block_q: int = 128, block_k: int = 128):
    """softmax(QK^T / sqrt(d)) V for (B, T, H, D) q, k, v.

    Same checks and messages as the JAX function.  ``block_q``/``block_k``
    are validated for parity with its signature; the CUDA kernel tiles by
    its own (128 x 128 for f16/bf16, 64 x 64 for f32).  CPU tensors take
    ``flash_attention_plain``; CUDA
    tensors launch the kernel (f32/f16/bf16, D in {64, 128}) or raise."""
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q/k/v must share shape (batch, seq, heads, "
                         f"dim); got {q.shape}/{k.shape}/{v.shape}")
    block_q = min(block_q, t)
    block_k = min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(
            f"seq {t} must divide by block_q={block_q} and "
            f"block_k={block_k} (pad the sequence)")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dim "
                         f"in {_KERNEL_DIMS}; got {d}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: the CUDA kernel takes float32, "
                         f"float16 or bfloat16; got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention: {name} is {x.dtype} on "
                             f"{x.device}, q is {q.dtype} on {q.device}")
    from . import _build

    # TMA's tensor maps need a 16-byte aligned, row-contiguous base
    q, k, v = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.load("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, t, h, d, _DTYPE_CODE[q.dtype], int(bool(causal)),
             1.0 / math.sqrt(d),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

"""Flash attention as a hand-written CUDA kernel — the single-device op.

The port of ``ray_tpu/ops/flash_attention.py`` (a Pallas TPU kernel):
blocked attention with the online-softmax recurrence, O(T) memory
instead of the O(T^2) score matrix (past D = 512 a score scratch of at
most the larger of 256 MiB and one query block's scores, below).  The kernel is
``csrc/flash_attention.cu``; the route follows dtype and kernel width:

* f16/bf16 at D = 64 and 128: wgmma + TMA, 128 query rows a CTA, key
  tiles of 128;
* f16/bf16 at D = 256 to 512: wgmma + TMA as well (both products on the
  tensor cores, S computed once a key tile); at 256 two warpgroups of
  64 rows, past 256 two warpgroups that share 64 rows, split O's columns
  and sum S from their halves of the head dim;
* f32 at D = 64 to 512: wgmma + TMA in split TF32 (3xTF32: each operand
  is a TF32 hi plus a TF32 lo, each product hi*hi + hi*lo + lo*hi in f32,
  within f32's tolerance); 128 query rows a CTA at 64 and 128, past 128 a
  cluster of two CTAs per query tile, each holding half of the head dim;
* past D = 512, both dtypes: two passes on wgmma + TMA.  A scores kernel
  computes S once per (query block, key tile) over the whole head dim
  and each row's max; a values kernel reads S back for each slice of O's
  columns, takes p against the final max and multiplies P by the slice's
  V.  f32 runs both products in split TF32 (``flash_scores32_kernel``,
  ``flash_values32_kernel``); 16-bit inputs on their own type
  (``flash_scores16_kernel``, ``flash_values16_kernel``: S one 16-bit
  product with an f32 sum, times the scale in f32; P rounded to 16 bits
  for P V), as the other 16-bit routes.  S (f32) goes through a score
  scratch in device memory that this wrapper allocates: bounded by a
  fixed cap (256 MiB; the call walks its 128-row query blocks in chunks
  that fit, two kernel launches a chunk) or, where one block's scores
  pass it (T past 2**19), by that block's (512 T bytes): O(T) whatever B
  and H are, never O(B*H*T^2).  Every other route keeps no scratch.

The route is chosen by dtype and width alone (the library's
``rt_flash_route``); a kernel that fails to build or launch, or a
scratch that cannot be allocated, raises.

``flash_attention_plain`` is the dense PyTorch version of the same
function, which CPU tensors take.

Other head dims are padded with zeros to the next kernel width (64, 128
or 256, and past 256 the next multiple of 64) and the output cut back:
exact, since zero columns add nothing to QK^T and the extra output
columns are P 0.  The softmax scale stays 1/sqrt(D) of the original D,
passed to the kernel as an argument (the 16-bit paths multiply the f32
product by it, never a 16-bit Q).

Shapes ``(batch, seq, heads, dim)`` at the public function, as in JAX.
"""

from __future__ import annotations

import math

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KERNEL_DIMS = (64, 128, 256)        # the kernel's widths; others pad up
_WIDE_CHUNK = 64                     # past 256: the next multiple of 64
# the kernels of the entry point's routes (rt_flash_route's codes 0-5)
# the kernels of the entry point's routes, by rt_flash_route's code (the
# codes of deleted routes are not given again)
_ROUTES = {0: "flash_wgmma_kernel", 1: "flash_big16_kernel",
           2: "flash_tf32_kernel",
           3: "flash_scores32_kernel+flash_values32_kernel",
           7: "flash_scores16_kernel+flash_values16_kernel"}
_TWOPASS = (3, 7)   # the two-pass routes' codes (f32, 16-bit)


def kernel_width(d: int) -> int:
    """The head dim the CUDA kernel runs a head dim ``d`` at."""
    return next((w for w in _KERNEL_DIMS if d <= w), None) or \
        -(-d // _WIDE_CHUNK) * _WIDE_CHUNK


def kernel_key_tile(d: int, dtype) -> int:
    """Keys a tile of the CUDA kernel the entry point launches for a head
    dim ``d`` and ``dtype`` (the library's ``rt_flash_key_tile``, read
    from the kernels' layouts; builds the library, so it needs nvcc)."""
    from . import _build
    tile = _build.load("flash_attention", "rt_flash_key_tile")(
        kernel_width(d), _DTYPE_CODE[dtype])
    if tile < 1:
        raise ValueError(f"flash_attention: no kernel takes {dtype} at "
                         f"head dim {d}")
    return tile


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
    its own (f16/bf16: 128 x 128 up to D = 128, 128 x 64 at 256, 64 x 32
    to 512; f32: 128 x 64 at 64, 128 x 32 at 128, 128 x 16 at 256 and
    320 and 64 x 16 to 512, each over a cluster of two CTAs; past 512
    128 x 64 for the scores and 128 x 32 for the values).  CPU tensors
    take ``flash_attention_plain``; CUDA tensors launch the kernel at any
    D or raise.  ``flash_attention.last_route`` names the kernel(s) the
    entry point launched last, ``flash_attention.last_kernel_launches``
    how many kernel launches the call made (counted by the library where
    each launch succeeded: 2 a chunk on the two-pass routes, else 1), and
    ``flash_attention.last_scratch_bytes`` the bytes of score scratch it
    allocated (0 off the two-pass routes)."""
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
    width = kernel_width(d)
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: the CUDA kernel takes float32, "
                         f"float16 or bfloat16; got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention: {name} is {x.dtype} on "
                             f"{x.device}, q is {q.dtype} on {q.device}")
    from . import _build

    if width != d:          # zero columns: exact (see the module note)
        q, k, v = (torch.nn.functional.pad(x, (0, width - d))
                   for x in (q, k, v))
    # TMA's tensor maps need a 16-byte aligned, row-contiguous base
    q, k, v = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    code = _DTYPE_CODE[q.dtype]
    route = _build.load("flash_attention", "rt_flash_route")(width, code)
    scratch = None
    if route in _TWOPASS:
        # its score scratch (bounded; module note), on the tensors'
        # device and stream; a plan the route refuses (-1) fails the launch
        n_scratch = _build.load("flash_attention", "rt_flash_scratch_bytes")(
            b, t, h, width, code)
        if n_scratch > 0:
            scratch = torch.empty(n_scratch, dtype=torch.uint8,
                                  device=q.device)
    out = torch.empty_like(q)
    fn = _build.load("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, t, h, width, code, int(bool(causal)),
             1.0 / math.sqrt(d),                  # the original D's scale
             None if scratch is None else scratch.data_ptr(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.last_route = _ROUTES[route]
    flash_attention.last_kernel_launches = _build.load(
        "flash_attention", "rt_flash_last_launches")()
    flash_attention.last_scratch_bytes = (0 if scratch is None
                                          else scratch.numel())
    return out if width == d else out[..., :d].contiguous()


flash_attention.launches = 0
flash_attention.last_route = None
flash_attention.last_kernel_launches = 0
flash_attention.last_scratch_bytes = 0

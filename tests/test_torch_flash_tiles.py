"""A model of flash attention's 16-bit wgmma arithmetic at widths 256-512.

``flash_big16_kernel`` (``ray_tpu_torch/ops/csrc/flash_attention.cu``)
runs only on the card.  This file keeps its arithmetic testable on the
CPU: ``tile_model`` repeats it in plain PyTorch, step for step as the
source note states it, and is held against the JAX Pallas kernel
(``ray_tpu.ops.flash_attention`` in interpreter mode) on the same seeded
numpy inputs, within the limit the card is held to (``FLASH_TOL``, as in
``chip_smoke.py``).  The same limit must reject the model with its last 64
keys dropped, so it is tight enough to see a lost key tile.

What the model repeats:

* operands in bf16/f16 (each product exact in f32), S and P V summed in
  f32;
* the kernel's tiles at each width: 128 query rows and key tiles of 64 at
  D = 256; 64 rows and key tiles of 32 past it;
* past 256, S as the sum of two partials, over head-dim chunks [0, C/2)
  and [C/2, C) (C = D/64 chunks, C/2 rounded down), each in f32;
* the online softmax in key-tile order in log2 units: m from the tile's
  raw row max times scale*log2(e), p = 2**(S*scale*log2(e) - m), p = 0
  where S is not finite, l summed from the unrounded p, P rounded to 16
  bits before P V, O = acc / max(l, 1e-30) rounded to 16 bits.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as ref_flash
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import flash_attention_plain
from ray_tpu_torch.ops.flash_attention import kernel_width

# |model - JAX| <= atol + rtol * |JAX| + p_u * (softmax(QK^T) |V|),
# elementwise in f32: the numbers of chip_smoke.FLASH_TOL, whose reasons
# stand beside it
FLASH_TOL = {  # dtype: (atol, rtol, p_u)
    torch.float16: (1e-5, 2.0**-9, 2.0**-11),
    torch.bfloat16: (1e-5, 2.0**-6, 2.0**-8),
}
JNP_DTYPE = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def kernel_tiles(width):
    """(query rows a CTA, keys a tile, head-dim chunks of the first S
    partial or None) of flash_big16_kernel at a kernel width."""
    if width == 256:
        return 128, 64, None
    return 64, 32, width // 64 // 2


def tile_model(q, k, v, causal, drop_last=0):
    """The kernel's arithmetic on (B, T, H, D) 16-bit CPU tensors at a
    kernel width D in 256..512; ``drop_last`` keys at the end are left
    out (a model of a kernel that loses them)."""
    dtype = q.dtype
    b, t, h, d = q.shape
    _, bn, split = kernel_tiles(kernel_width(d))
    # the wrapper passes 1/sqrt(D) as a C float; the launcher folds in
    # log2(e) in f32
    scale_log2 = (torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    rows = torch.arange(t).view(t, 1)
    m2 = torch.full((b, h, t), -math.inf)
    lsum = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, d))
    for k0 in range(0, t, bn):
        kb, vb = kf[:, :, k0:k0 + bn], vf[:, :, k0:k0 + bn]
        if split is None:
            s = qf @ kb.transpose(-1, -2)
        else:
            c = 64 * split
            s = (qf[..., :c] @ kb[..., :c].transpose(-1, -2)
                 + qf[..., c:] @ kb[..., c:].transpose(-1, -2))
        cols = torch.arange(k0, k0 + kb.shape[2]).view(1, -1)
        dead = cols >= t - drop_last
        if causal:
            dead = dead | (cols > rows)
        s = s.masked_fill(dead, -math.inf)
        m_new = torch.maximum(m2, s.amax(-1) * scale_log2)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m2 - m_use)
        p = torch.where(torch.isfinite(s),
                        torch.exp2(s * scale_log2 - m_use[..., None]), 0.0)
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.to(dtype).float() @ vb
        m2 = m_new
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(dtype)


CASES = [(d, dtype, causal, t)
         for d in (256, 320, 512)
         for dtype in (torch.bfloat16, torch.float16)
         for causal in (False, True)
         # T = 96: a multiple of neither the query tile nor, at 256, the
         # key tile; T = 256: whole tiles at every width
         for t in (96, 256)]
IDS = [f"d{d}-{str(dtype)[6:]}-{'causal' if causal else 'full'}-t{t}"
       for d, dtype, causal, t in CASES]


@functools.lru_cache(maxsize=None)
def _case(d, dtype, causal, t):
    """Seeded inputs, the JAX kernel's output and the limit, all f32."""
    rng = np.random.default_rng(d * 1000 + t + int(causal))
    arrays = [rng.normal(size=(1, t, 2, d)).astype(np.float32)
              for _ in range(3)]
    q, k, v = (torch.from_numpy(x).to(dtype) for x in arrays)
    jq, jk, jv = (jnp.asarray(x).astype(JNP_DTYPE[dtype]) for x in arrays)
    want = np.array(ref_flash(jq, jk, jv, causal=causal, block_q=32,
                              block_k=32, interpret=True)
                    .astype(jnp.float32))
    want = torch.from_numpy(want)
    atol, rtol, p_u = FLASH_TOL[dtype]
    pv_abs = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   causal=causal)
    limit = atol + rtol * want.abs() + p_u * pv_abs
    return q, k, v, want, limit


@pytest.mark.parametrize("d,dtype,causal,t", CASES, ids=IDS)
def test_tile_model_matches_jax_kernel(d, dtype, causal, t):
    q, k, v, want, limit = _case(d, dtype, causal, t)
    got = tile_model(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    ratio = float(((got.float() - want).abs() / limit).max())
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("d,dtype,causal,t", CASES, ids=IDS)
def test_limit_rejects_the_model_without_its_last_64_keys(d, dtype, causal,
                                                          t):
    q, k, v, want, limit = _case(d, dtype, causal, t)
    faulty = tile_model(q, k, v, causal, drop_last=64)
    assert float(((faulty.float() - want).abs() / limit).max()) > 1.0


def test_split_sum_is_one_s_for_both_consumers():
    """Past 256 each consumer adds the other's partial to its own; f32
    addition commutes, so both hold the same S and run the same softmax,
    and the sum is S over the whole head dim up to f32 rounding."""
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.normal(size=(64, 320)).astype(np.float32))
            .to(torch.bfloat16).float() for _ in range(2))
    c = 64 * kernel_tiles(320)[2]
    own = q[:, :c] @ k[:32, :c].T
    other = q[:, c:] @ k[:32, c:].T
    assert torch.equal(own + other, other + own)
    whole = q.double() @ k[:32].double().T
    # f32 sums of 320 terms: within 320 ulps of the sum of |q k|
    bound = 320 * 2.0**-24 * (q.abs().double() @ k[:32].abs().double().T)
    assert bool(((own + other).double() - whole).abs().le(bound).all())

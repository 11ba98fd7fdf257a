"""A model of flash attention's cluster routes past kernel width 512.

``flash_cluster16_kernel`` and ``flash_cluster32_kernel``
(``ray_tpu_torch/ops/csrc/flash_attention.cu``) run only on the card.
This file keeps their arithmetic testable on the CPU: ``cluster_model``
repeats it in plain PyTorch, step for step as the source note states
it, and is held against the JAX Pallas kernel
(``ray_tpu.ops.flash_attention`` in interpreter mode) on the same seeded
numpy inputs, within the limit the card is held to (``FLASH_TOL``, as in
``chip_smoke.py``).  The same limit must reject the model with its last
key tile dropped, so it is tight enough to see a lost tile.

What the model repeats, for a query tile served by a cluster of CTAs:

* the head dim split over the CTAs as the kernels split it
  (``kernel_slices``): 16-bit, the D/64 chunks over ceil(D/256) CTAs;
  f32, the D/32 boxes over ceil(D/192) CTAs; the first CTAs one more
  than the rest;
* each CTA's partial S over its own columns in f32: 16-bit, one product
  of the 16-bit operands; f32, split TF32 (as
  ``tests/test_torch_flash_split32.py``: three TF32 products of each
  32-column batch, the batches added in f32);
* S as the sum of the partials in rank order, from 0 (every CTA adds the
  same numbers in the same order, so all hold one S);
* the online softmax in key-tile order (key tiles of 32 for 16-bit, 16
  for f32) in log2 units: 16-bit with the scale on the f32 product and P
  rounded to 16 bits before P V; f32 with Q scaled before the split, P
  split for P V, each tile's P V added to acc * corr in f32;
  O = acc / max(l, 1e-30), rounded to the input dtype.
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
from test_torch_flash_split32 import product

# |model - JAX| <= atol + rtol * |JAX| + p_u * (softmax(QK^T) |V|),
# elementwise in f32: the numbers of chip_smoke.FLASH_TOL, whose reasons
# stand beside it
FLASH_TOL = {  # dtype: (atol, rtol, p_u)
    torch.float32: (1e-6, 1e-5, 1e-5),
    torch.float16: (1e-5, 2.0**-9, 2.0**-11),
    torch.bfloat16: (1e-5, 2.0**-6, 2.0**-8),
}
JNP_DTYPE = {torch.float32: jnp.float32, torch.float16: jnp.float16,
             torch.bfloat16: jnp.bfloat16}
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def kernel_slices(width, dtype):
    """[(first column, columns)] of each CTA of a query tile's cluster,
    in rank order, at a kernel width past 512."""
    unit, most = (32, 6) if dtype == torch.float32 else (64, 4)
    n = width // unit
    ctas = -(-n // most)
    small, extra = divmod(n, ctas)
    return [(unit * (r * small + min(r, extra)),
             unit * (small + (r < extra))) for r in range(ctas)]


def kernel_key_tile(dtype):
    """Keys a tile of the cluster kernels."""
    return 16 if dtype == torch.float32 else 32


def rank_order_sum(partials):
    """S from the cluster's partials as every CTA adds them: from 0, in
    rank order."""
    s = torch.zeros_like(partials[0])
    for p in partials:
        s = s + p
    return s


def cluster_model(q, k, v, causal, drop_last=0):
    """The cluster kernels' arithmetic on (B, T, H, D) CPU tensors at a
    kernel width past 512 (zero-padded to it, as the wrapper does);
    ``drop_last`` keys at the end are left out (a model of a kernel that
    loses them)."""
    dtype = q.dtype
    b, t, h, d = q.shape
    width = kernel_width(d)
    slices = kernel_slices(width, dtype)
    bn = kernel_key_tile(dtype)
    wide = dtype == torch.float32
    # the wrapper passes 1/sqrt(D) as a C float: the f32 kernel scales Q
    # by it before the split, the 16-bit launcher folds in log2(e) in f32
    # and scales the product
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, kf, vf = (torch.nn.functional.pad(x.float(), (0, width - d))
                  .permute(0, 2, 1, 3) for x in (q, k, v))
    if wide:
        qf = qf * scale
    rows = torch.arange(t).view(t, 1)
    m2 = torch.full((b, h, t), -math.inf)
    lsum = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, width))
    for k0 in range(0, t, bn):
        kb, vb = kf[:, :, k0:k0 + bn], vf[:, :, k0:k0 + bn]
        partials = []
        for c0, n in slices:                 # each CTA's partial S
            if wide:
                part = None
                for x in range(c0, c0 + n, 32):    # batches of 32 columns
                    p_x = product(qf[..., x:x + 32],
                                  kb[..., x:x + 32].transpose(-1, -2),
                                  "3xtf32")
                    part = p_x if part is None else part + p_x
            else:
                part = (qf[..., c0:c0 + n]
                        @ kb[..., c0:c0 + n].transpose(-1, -2))
            partials.append(part)
        s = rank_order_sum(partials)
        keys = torch.arange(k0, k0 + kb.shape[2]).view(1, -1)
        dead = keys >= t - drop_last
        if causal:
            dead = dead | (keys > rows)
        s = s.masked_fill(dead, -math.inf)
        log2 = LOG2E if wide else scale_log2
        m_new = torch.maximum(m2, s.amax(-1) * log2)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m2 - m_use)
        p = torch.where(torch.isfinite(s),
                        torch.exp2(s * log2 - m_use[..., None]), 0.0)
        lsum = lsum * corr + p.sum(-1)
        pv = product(p, vb, "3xtf32") if wide else p.to(dtype).float() @ vb
        acc = acc * corr[..., None] + pv
        m2 = m_new
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3)[..., :d].to(dtype)


# T = 80: a multiple of neither the query tile (64 or 128) nor the 16-bit
# key tile; D = 576 splits evenly (3 CTAs), 640 does not in 16 bits (4,
# 3, 3 chunks), 1024 takes 4 CTAs in 16 bits and 6 in f32 (6, 6, 5, 5, 5,
# 5 boxes)
CASES = [(d, dtype, causal, t)
         for d in (576, 640, 1024)
         for dtype in (torch.bfloat16, torch.float16, torch.float32)
         for causal in (False, True)
         for t in (80, 128)]
IDS = [f"d{d}-{str(dtype)[6:]}-{'causal' if causal else 'full'}-t{t}"
       for d, dtype, causal, t in CASES]


@functools.lru_cache(maxsize=None)
def _case(d, dtype, causal, t):
    """Seeded inputs, the JAX kernel's output and the limit, all f32."""
    rng = np.random.default_rng(d * 1000 + t + int(causal))
    arrays = [rng.normal(size=(1, t, 2, d)).astype(np.float32)
              for _ in range(3)]
    q, k, v = (torch.from_numpy(x).to(dtype) for x in arrays)
    block = 16 if t % 32 else 32
    want = np.array(ref_flash(*(jnp.asarray(x).astype(JNP_DTYPE[dtype])
                                for x in arrays),
                              causal=causal, block_q=block, block_k=block,
                              interpret=True).astype(jnp.float32))
    want = torch.from_numpy(want)
    atol, rtol, p_u = FLASH_TOL[dtype]
    pv_abs = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   causal=causal)
    return q, k, v, want, atol + rtol * want.abs() + p_u * pv_abs


def _ratio(got, want, limit):
    return float(((got.float() - want).abs() / limit).max())


@pytest.mark.parametrize("d,dtype,causal,t", CASES, ids=IDS)
def test_cluster_model_matches_jax_kernel(d, dtype, causal, t):
    q, k, v, want, limit = _case(d, dtype, causal, t)
    got = cluster_model(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    ratio = _ratio(got, want, limit)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("d,dtype,causal,t", CASES, ids=IDS)
def test_limit_rejects_the_model_without_its_last_key_tile(d, dtype, causal,
                                                           t):
    q, k, v, want, limit = _case(d, dtype, causal, t)
    faulty = cluster_model(q, k, v, causal, drop_last=kernel_key_tile(dtype))
    assert _ratio(faulty, want, limit) > 1.0


@pytest.mark.parametrize("width,dtype,slices", [
    (576, torch.bfloat16, [(0, 192), (192, 192), (384, 192)]),
    (640, torch.bfloat16, [(0, 256), (256, 192), (448, 192)]),
    (832, torch.float16, [(0, 256), (256, 192), (448, 192), (640, 192)]),
    (1024, torch.bfloat16, [(0, 256), (256, 256), (512, 256), (768, 256)]),
    (576, torch.float32, [(0, 192), (192, 192), (384, 192)]),
    (640, torch.float32, [(0, 160), (160, 160), (320, 160), (480, 160)]),
    (1024, torch.float32, [(0, 192), (192, 192), (384, 160), (544, 160),
                           (704, 160), (864, 160)]),
    (1536, torch.float32, [(192 * r, 192) for r in range(8)]),
])
def test_slices_cover_the_head_dim_in_portable_clusters(width, dtype,
                                                        slices):
    """Every column once, in rank order, at most 8 CTAs (a portable
    cluster) and at most 4 chunks (16-bit) or 6 boxes (f32) a CTA."""
    got = kernel_slices(width, dtype)
    assert got == slices
    assert len(got) <= 8 and sum(n for _, n in got) == width
    assert all(c0 + n == nxt for (c0, n), (nxt, _) in zip(got, got[1:]))
    assert max(n for _, n in got) <= (192 if dtype == torch.float32
                                      else 256)


@pytest.mark.parametrize("n_cta", [3, 4, 6, 8])
def test_rank_order_gives_one_s_to_every_cta(n_cta):
    """With three or more partials f32 addition is not associative: a
    CTA that added its own partial first and then the others in rank
    order would hold another S than CTA 0 for some seed, so the CTAs
    would run the softmax on different S; the kernels add every partial
    in rank order, the own one at its rank, and all hold the same S."""
    rng = np.random.default_rng(n_cta)
    q, k = (torch.from_numpy(rng.normal(size=(64, 192 * n_cta))
                             .astype(np.float32)) for _ in range(2))
    partials = [product(q[:, 192 * r:192 * (r + 1)],
                        k[:16, 192 * r:192 * (r + 1)].T, "3xtf32")
                for r in range(n_cta)]
    s = rank_order_sum(partials)        # what every CTA holds
    # own first, then the others in rank order: some CTA's S is not CTA
    # 0's (whose own partial comes first either way)
    own_first = [rank_order_sum([partials[rank]] + partials[:rank]
                                + partials[rank + 1:])
                 for rank in range(n_cta)]
    assert torch.equal(own_first[0], s)
    assert any(not torch.equal(x, s) for x in own_first[1:])
    whole = q.double() @ k[:16].double().T
    bound = q.shape[1] * 2.0**-20 * (q.abs().double()
                                     @ k[:16].abs().double().T)
    assert bool((s.double() - whole).abs().le(bound).all())

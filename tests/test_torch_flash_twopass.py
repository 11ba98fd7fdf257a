"""A model of flash attention's two-pass routes past kernel width 512.

``flash_scores32_kernel`` and ``flash_values32_kernel`` (f32) and
``flash_scores16_kernel`` and ``flash_values16_kernel`` (f16, bf16)
(``ray_tpu_torch/ops/csrc/flash_attention.cu``) run only on the card.
This file keeps their arithmetic testable on the CPU: ``twopass_model``
repeats it in plain PyTorch, step for step as the source note states it,
and is held against the JAX Pallas kernel (``ray_tpu.ops.flash_attention``
in interpreter mode) on the same seeded numpy inputs, within the limit
the card is held to (``FLASH_TOL``, as in ``chip_smoke.py``).  The same
limit must reject the model with its last key tile dropped.

What the model repeats in f32 (split TF32, "3xTF32", as
``tests/test_torch_flash_split32.py``):

* pass 1, per key tile of 64 (the scores kernel's): S = (Q scale) K^T
  over the whole head dim, Q scaled in f32 before the split, each
  32-column batch three TF32 products (small products first) in its own
  sum and the batches added in f32 in column order; keys past the
  sequence (and, causal, past the row) set to -inf; the row max m of
  S log2(e) over the key tiles, from the stored S;
* pass 2, per slice of O's columns (the d/32 boxes over ceil(d/192)
  slices, 5 or 6 boxes each) and key tile of 32 (the values kernel's):
  p = 2**(S log2(e) - m) against the final m, 0 where S is not finite;
  l summed from those p in key-tile order; split P times the slice's
  split V^T, each tile's P V added to O in f32 (no rescale: m is final);
  O = acc / max(l, 1e-30).

In 16 bits the same two passes on the inputs' own type, as the other
16-bit routes: S per key tile of 64 one product of the 16-bit operands
summed in f32 over the whole head dim, then times the scale in f32
(never a 16-bit Q); pass 2 per slice of O's columns (the d/64 boxes over
ceil(d/256) slices, 3 or 4 boxes each) takes p in f32 against the final
m, sums l from those p, rounds P to 16 bits and adds P V in f32;
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
SCORES_TILE, VALUES_TILE = 64, 32      # keys a tile of each kernel


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def value_slices(width, dtype=torch.float32):
    """[(first column, columns)] of the values kernel's slices of O at a
    kernel width: f32, the width/32 boxes over ceil(boxes / 6) slices;
    16-bit, the width/64 boxes over ceil(boxes / 4) slices; the first
    ones one box more."""
    unit, most = (32, 6) if dtype == torch.float32 else (64, 4)
    n = width // unit
    slices = -(-n // most)
    small, extra = divmod(n, slices)
    return [(unit * (r * small + min(r, extra)),
             unit * (small + (r < extra))) for r in range(slices)]


def scores(q, k, causal, drop_last=0, scale=None):
    """Pass 1 on (B, H, T, W) q and k: S with dead keys at -inf, and m,
    the row max of S log2(e) over the key tiles.  f32 (no ``scale``): q
    already scaled, each 32-column batch in split TF32, the batches added
    in f32; 16-bit (q and k the 16-bit values in f32): one product over
    the whole head dim in f32, times the f32 ``scale``."""
    b, h, t, width = q.shape
    rows = torch.arange(t).view(t, 1)
    tiles, m2 = [], torch.full((b, h, t), -math.inf)
    for k0 in range(0, t, SCORES_TILE):
        kb = k[:, :, k0:k0 + SCORES_TILE]
        if scale is not None:
            s = (q @ kb.transpose(-1, -2)) * scale
        else:
            s = None
            for x in range(0, width, 32):      # batches of 32 columns
                part = product(q[..., x:x + 32],
                               kb[..., x:x + 32].transpose(-1, -2),
                               "3xtf32")
                s = part if s is None else s + part
        keys = torch.arange(k0, k0 + kb.shape[2]).view(1, -1)
        dead = keys >= t - drop_last
        if causal:
            dead = dead | (keys > rows)
        s = s.masked_fill(dead, -math.inf)
        m2 = torch.maximum(m2, s.amax(-1) * LOG2E)
        tiles.append(s)
    return torch.cat(tiles, -1), m2


def values(s, m2, v, dtype=torch.float32):
    """Pass 2 on S, m and (B, H, T, W) v (f32; 16-bit values in f32 for
    a 16-bit ``dtype``): per slice of O's columns, p against the final m,
    l from those p in key-tile order, P V per key tile added in f32 (f32:
    split TF32; 16-bit: P rounded to ``dtype``).  Returns (O
    unnormalised, [l of each slice], [the p of each key tile, as taken
    before P V])."""
    t, width = v.shape[2], v.shape[3]
    m_use = torch.where(m2 == -math.inf, 0.0, m2)[..., None]
    acc = torch.zeros(v.shape)
    ls, ps = [], []
    for c0, n in value_slices(width, dtype):
        lsum = torch.zeros(m2.shape)
        ps = []
        for k0 in range(0, t, VALUES_TILE):
            st = s[..., k0:k0 + VALUES_TILE]
            p = torch.where(torch.isfinite(st),
                            torch.exp2(st * LOG2E - m_use), 0.0)
            lsum = lsum + p.sum(-1)
            vt = v[:, :, k0:k0 + VALUES_TILE, c0:c0 + n]
            acc[..., c0:c0 + n] += (
                product(p, vt, "3xtf32") if dtype == torch.float32
                else p.to(dtype).float() @ vt)
            ps.append(p)
        ls.append(lsum)
    return acc, ls, ps


def twopass_model(q, k, v, causal, drop_last=0):
    """The two kernels' arithmetic on (B, T, H, D) CPU tensors (f32, f16
    or bf16) at a head dim past 512 (zero-padded to the kernel width, as
    the wrapper does); ``drop_last`` keys at the end are left out (a model
    of a kernel that loses them)."""
    dtype = q.dtype
    b, t, h, d = q.shape
    width = kernel_width(d)
    # the wrapper passes 1/sqrt(D) as a C float: the f32 pair scales Q by
    # it before the split, the 16-bit pair the f32 product
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    wide = dtype == torch.float32
    qf, kf, vf = (torch.nn.functional.pad(x, (0, width - d))
                  .permute(0, 2, 1, 3)
                  for x in (q * scale if wide else q.float(), k.float(),
                            v.float()))
    s, m2 = scores(qf, kf, causal, drop_last, None if wide else scale)
    acc, ls, _ = values(s, m2, vf, dtype)
    out = acc / ls[0].clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3)[..., :d].to(dtype)


# T = 80: a multiple of neither the scores' key tile (64) nor the query
# block (128); D = 576 splits its 18 boxes evenly (3 slices of 6), 640 and
# 1600 unevenly (4 of 5; 5 of 6, 4 of 5), 1024 its 32 (2 of 6, 4 of 5),
# 2048 its 64 (9 of 6, 2 of 5)
CASES = [(d, causal, t) for d in (1600, 2048) for causal in (False, True)
         for t in (80, 128)]
CASES += [(d, causal, t) for d in (576, 640, 1024)
          for causal in (False, True) for t in (80, 128)]
IDS = [f"d{d}-{'causal' if causal else 'full'}-t{t}" for d, causal, t in CASES]
# 16-bit: D = 576 (3 slices of 3 boxes), 640 (4, 3, 3), 1024 (4 x 4),
# 1088 (4, 4, 3, 3, 3), 1600 (4 x 4, 3 x 3)
CASES16 = [(d, dtype, causal, t) for d in (576, 640, 1024, 1088, 1600)
           for dtype in (torch.bfloat16, torch.float16)
           for causal in (False, True) for t in (80, 128)]
IDS16 = [f"d{d}-{str(dtype)[6:]}-{'causal' if causal else 'full'}-t{t}"
         for d, dtype, causal, t in CASES16]


@functools.lru_cache(maxsize=None)
def _case(d, causal, t, dtype=torch.float32):
    """Seeded inputs, the JAX kernel's output and the limit, all f32."""
    rng = np.random.default_rng(d * 1000 + t + int(causal))
    arrays = [rng.normal(size=(1, t, 2, d)).astype(np.float32)
              for _ in range(3)]
    q, k, v = (torch.from_numpy(x).to(dtype) for x in arrays)
    block = 16 if t % 32 else 32
    want = torch.from_numpy(np.array(ref_flash(
        *(jnp.asarray(x).astype(JNP_DTYPE[dtype]) for x in arrays),
        causal=causal, block_q=block, block_k=block,
        interpret=True).astype(jnp.float32)))
    atol, rtol, p_u = FLASH_TOL[dtype]
    pv_abs = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   causal=causal)
    return q, k, v, want, atol + rtol * want.abs() + p_u * pv_abs


def _ratio(got, want, limit):
    return float(((got.float() - want).abs() / limit).max())


@pytest.mark.parametrize("d,causal,t", CASES, ids=IDS)
def test_twopass_model_matches_jax_kernel(d, causal, t):
    q, k, v, want, limit = _case(d, causal, t)
    got = twopass_model(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    ratio = _ratio(got, want, limit)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("d,causal,t", CASES, ids=IDS)
def test_limit_rejects_the_model_without_its_last_key_tile(d, causal, t):
    q, k, v, want, limit = _case(d, causal, t)
    faulty = twopass_model(q, k, v, causal, drop_last=VALUES_TILE)
    assert _ratio(faulty, want, limit) > 1.0


@pytest.mark.parametrize("d,dtype,causal,t", CASES16, ids=IDS16)
def test_twopass16_model_matches_jax_kernel(d, dtype, causal, t):
    q, k, v, want, limit = _case(d, causal, t, dtype)
    got = twopass_model(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    ratio = _ratio(got, want, limit)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("d,dtype,causal,t", CASES16, ids=IDS16)
def test_limit_rejects_the_16bit_model_without_its_last_key_tile(
        d, dtype, causal, t):
    q, k, v, want, limit = _case(d, causal, t, dtype)
    faulty = twopass_model(q, k, v, causal, drop_last=VALUES_TILE)
    assert _ratio(faulty, want, limit) > 1.0


@pytest.mark.parametrize("width,slices", [
    (1600, [(0, 192), (192, 192), (384, 192), (576, 192), (768, 192),
            (960, 160), (1120, 160), (1280, 160), (1440, 160)]),
    (2048, [(192 * r, 192) for r in range(9)]
     + [(1728, 160), (1888, 160)]),
    (1664, [(192 * r, 192) for r in range(7)] + [(1344, 160), (1504, 160)]),
    (576, [(0, 192), (192, 192), (384, 192)]),
    (640, [(0, 160), (160, 160), (320, 160), (480, 160)]),
    (1024, [(0, 192), (192, 192), (384, 160), (544, 160), (704, 160),
            (864, 160)]),
])
def test_value_slices_cover_the_head_dim(width, slices):
    """Every column once, in order, 160 or 192 columns a slice (what one
    values CTA holds in registers)."""
    got = value_slices(width)
    assert got == slices
    assert sum(n for _, n in got) == width
    assert all(c0 + n == nxt for (c0, n), (nxt, _) in zip(got, got[1:]))
    assert {n for _, n in got} <= {160, 192}


@pytest.mark.parametrize("width,slices", [
    (576, [(0, 192), (192, 192), (384, 192)]),
    (640, [(0, 256), (256, 192), (448, 192)]),
    (1024, [(256 * r, 256) for r in range(4)]),
    (1088, [(0, 256), (256, 256), (512, 192), (704, 192), (896, 192)]),
    (1600, [(256 * r, 256) for r in range(4)]
     + [(1024, 192), (1216, 192), (1408, 192)]),
])
def test_16bit_value_slices_cover_the_head_dim(width, slices):
    """In 16 bits every column once, in order, 192 or 256 columns a slice
    (3 or 4 boxes of 64: what one 16-bit values CTA holds in registers,
    wgmma's widest N at most)."""
    got = value_slices(width, torch.bfloat16)
    assert got == slices
    assert sum(n for _, n in got) == width
    assert all(c0 + n == nxt for (c0, n), (nxt, _) in zip(got, got[1:]))
    assert {n for _, n in got} <= {192, 256}


@pytest.mark.parametrize("causal", [False, True])
def test_every_slice_holds_one_l_the_sum_of_its_p(causal):
    """l is summed in pass 2 from the p taken against the final m, in
    key-tile order: every slice's CTA adds the same numbers in the same
    order, so all hold one l bit for bit, and it is exactly the sum of
    the p multiplied into O.  An online l (p against a running max,
    rescaled as the max moves) is another sum of other numbers: not the
    p the second pass multiplies in."""
    rng = np.random.default_rng(7 + int(causal))
    t, width = 128, 1600
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, t, width))
                                .astype(np.float32)) for _ in range(3))
    s, m2 = scores(q * (1.0 / math.sqrt(width)), k, causal)
    _, ls, ps = values(s, m2, v)
    assert len(ls) == len(value_slices(width)) == 9
    assert all(torch.equal(x, ls[0]) for x in ls[1:])
    lsum = torch.zeros(m2.shape)
    for p in ps:                     # the p of the last slice, tile by tile
        lsum = lsum + p.sum(-1)
    assert torch.equal(lsum, ls[0])
    # the online recurrence over the same tiles
    m_run = torch.full(m2.shape, -math.inf)
    l_run = torch.zeros(m2.shape)
    for k0 in range(0, t, VALUES_TILE):
        st = s[..., k0:k0 + VALUES_TILE]
        m_new = torch.maximum(m_run, st.amax(-1) * LOG2E)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        l_run = l_run * torch.exp2(m_run - m_use) + torch.where(
            torch.isfinite(st), torch.exp2(st * LOG2E - m_use[..., None]),
            0.0).sum(-1)
        m_run = m_new
    assert torch.equal(m_run, m2)
    assert not torch.equal(l_run, ls[0])
    assert torch.allclose(l_run, ls[0], rtol=1e-5)

"""A model of flash attention's f32 arithmetic on the tensor cores.

``flash_tf32_kernel`` (``ray_tpu_torch/ops/csrc/flash_attention.cu``)
runs only on the card.  This file keeps its arithmetic testable on the
CPU: ``tile_model`` repeats it in plain PyTorch, step for step as the
source note states it, and is held against the JAX Pallas kernel
(``ray_tpu.ops.flash_attention`` in interpreter mode) on the same seeded
numpy inputs, within f32's limit (``FLASH_TOL``, as in ``chip_smoke.py``).
The same limit must reject the model with one TF32 pass, the model with
its last key tile dropped, and, where the first rows have few live keys,
the bf16x3 split, so it is tight enough to tell the designs apart.

What the model repeats (split-TF32, "3xTF32"):

* every operand x of both products split in two TF32 values: ``hi`` is
  x with its low 13 bits cleared, ``lo`` is x - hi (exact in f32) rounded
  to TF32 to nearest, ties away from zero (``cvt.rna.tf32.f32``); each
  product is ``A_hi B_lo + A_lo B_hi + A_hi B_hi`` (each term exact in
  f32), summed in f32;
* Q scaled by 1/sqrt(d) in f32 before the split, as the JAX kernel;
* the kernel's key tiles at each width: 64 at D = 64, 32 at 128, 16 from
  256 on;
* S summed per 32 columns of the head dim (one batch of the kernel's
  products, in its own accumulator) and the batches added in f32; from
  D = 256 on, S as the sum of two partials over the halves of the head
  dim (the two CTAs of a cluster), each in f32;
* the online softmax in key-tile order in log2 units: m from the tile's
  row max times log2(e), p = 2**(S*log2(e) - m), p = 0 where S is not
  finite, l summed from the unsplit p, P split for P V; each tile's P V
  in its own accumulator, added to acc * corr in f32; O = acc /
  max(l, 1e-30).
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
# elementwise in f32: chip_smoke.FLASH_TOL["float32"], whose reasons
# stand beside it
ATOL, RTOL, P_U = 1e-6, 1e-5, 1e-5
LOG2E = 1.4426950408889634
TF32_MASK = ~0x1FFF                  # clears the 13 bits TF32 drops


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def split_tf32(x):
    """(hi, lo) of f32 ``x`` as the kernel forms them from the bits."""
    hi = (x.view(torch.int32) & TF32_MASK).view(torch.float32)
    rest = x - hi                               # exact
    lo = ((rest.view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)
    return hi, lo


def one_pass_tf32(x):
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def split_bf16(x):
    """bf16x3's split (hi the bf16 of x, lo the bf16 of the rest)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def product(a, b, design):
    """a @ b in one of the designs the limit is to tell apart."""
    if design == "3xtf32":
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        return ah @ bl + al @ bh + ah @ bh
    if design == "bf16x3":
        (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
        return ah @ bl + al @ bh + ah @ bh
    assert design == "1xtf32"
    return one_pass_tf32(a) @ one_pass_tf32(b)


def kernel_tiles(width):
    """(CTAs a query tile, keys a tile) of flash_tf32_kernel at a kernel
    width: one CTA up to 128, a cluster of two (each half of the head
    dim) from 256 on."""
    if width <= 128:
        return 1, 64 if width == 64 else 32
    return 2, 16


def tile_model(q, k, v, causal, design="3xtf32", drop_last=0):
    """The kernel's arithmetic on (B, T, H, D) f32 CPU tensors at any D
    up to 512 (zero-padded to the kernel width, as the wrapper does);
    ``drop_last`` keys at the end are left out (a model of a kernel that
    loses them)."""
    b, t, h, d = q.shape
    width = kernel_width(d)
    n_cta, bn = kernel_tiles(width)
    # the wrapper passes 1/sqrt(D) as a C float; Q is scaled in f32
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    qf, kf, vf = (torch.nn.functional.pad(x, (0, width - d))
                  .permute(0, 2, 1, 3) for x in (q * scale, k, v))
    part = width // n_cta
    rows = torch.arange(t).view(t, 1)
    m2 = torch.full((b, h, t), -math.inf)
    lsum = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, width))
    for k0 in range(0, t, bn):
        kb, vb = kf[:, :, k0:k0 + bn], vf[:, :, k0:k0 + bn]
        s = None
        for c in range(n_cta):                  # own partial + the other's
            s_c = None
            for x in range(c * part, (c + 1) * part, 32):   # batches
                p_x = product(qf[..., x:x + 32],
                              kb[..., x:x + 32].transpose(-1, -2), design)
                s_c = p_x if s_c is None else s_c + p_x
            s = s_c if s is None else s + s_c
        keys = torch.arange(k0, k0 + kb.shape[2]).view(1, -1)
        dead = keys >= t - drop_last
        if causal:
            dead = dead | (keys > rows)
        s = s.masked_fill(dead, -math.inf)
        m_new = torch.maximum(m2, s.amax(-1) * LOG2E)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m2 - m_use)
        p = torch.where(torch.isfinite(s),
                        torch.exp2(s * LOG2E - m_use[..., None]), 0.0)
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + product(p, vb, design)
        m2 = m_new
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3)[..., :d]


# every kernel width's layout: one CTA (64, 128), the cluster with two
# consumer warpgroups a CTA (256, 320) and with one (512); T = 80 is a
# multiple of neither the query tile nor the key tiles of 32 and 64
CASES = [(d, causal, t)
         for d in (64, 128, 256, 320, 512)
         for causal in (False, True)
         for t in ((80, 128) if d in (64, 320) else (80,))]
IDS = [f"d{d}-{'causal' if causal else 'full'}-t{t}" for d, causal, t in CASES]


@functools.lru_cache(maxsize=None)
def _case(d, causal, t):
    """Seeded inputs, the JAX kernel's output and the limit, all f32."""
    rng = np.random.default_rng(d * 1000 + t + int(causal))
    arrays = [rng.normal(size=(1, t, 2, d)).astype(np.float32)
              for _ in range(3)]
    q, k, v = (torch.from_numpy(x) for x in arrays)
    block = 16 if t % 32 else 32
    want = torch.from_numpy(np.array(ref_flash(
        *(jnp.asarray(x) for x in arrays), causal=causal, block_q=block,
        block_k=block, interpret=True)))
    pv_abs = flash_attention_plain(q, k, v.abs(), causal=causal)
    return q, k, v, want, ATOL + RTOL * want.abs() + P_U * pv_abs


def _ratio(got, want, limit):
    return float(((got - want).abs() / limit).max())


@pytest.mark.parametrize("d,causal,t", CASES, ids=IDS)
def test_tile_model_matches_jax_kernel(d, causal, t):
    q, k, v, want, limit = _case(d, causal, t)
    got = tile_model(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    ratio = _ratio(got, want, limit)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("d,causal,t", CASES, ids=IDS)
def test_limit_rejects_one_tf32_pass(d, causal, t):
    q, k, v, want, limit = _case(d, causal, t)
    assert _ratio(tile_model(q, k, v, causal, "1xtf32"), want, limit) > 1.0


@pytest.mark.parametrize("d,causal,t", CASES, ids=IDS)
def test_limit_rejects_the_model_without_its_last_key_tile(d, causal, t):
    q, k, v, want, limit = _case(d, causal, t)
    bn = kernel_tiles(kernel_width(d))[1]
    faulty = tile_model(q, k, v, causal, drop_last=bn)
    assert _ratio(faulty, want, limit) > 1.0


@pytest.mark.parametrize("d", [128, 512])
def test_limit_rejects_bf16x3_where_few_keys_are_live(d):
    """Causal: row i has i + 1 live keys, so the first rows' p carry S's
    error unaveraged; bf16x3 (JAX's Precision.HIGH) fails the limit
    there, where 3xTF32 stays far inside it."""
    q, k, v, want, limit = _case(d, True, 80)
    assert _ratio(tile_model(q, k, v, True), want, limit) <= 0.25
    assert _ratio(tile_model(q, k, v, True, "bf16x3"), want, limit) > 1.0


def test_split_is_exact_in_two_tf32_values():
    """hi has its low 13 bits clear, lo is a TF32 value, and hi + lo is
    within 2**-21 |x| of x, over normal values of every exponent range
    the kernel meets, their negatives, and the edges of the rounding."""
    rng = np.random.default_rng(13)
    x = np.concatenate([
        rng.normal(size=20000),
        rng.normal(size=20000) * 10.0 ** rng.integers(-30, 30, 20000),
        [1.0, -1.0, 2.0 ** -126, 3.0e38, 1.0 + 2.0 ** -23,
         1.0 + 2.0 ** -11 + 2.0 ** -22, -(1.0 + 2.0 ** -10 - 2.0 ** -23)],
    ]).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = split_tf32(xt)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    err = (xt.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * xt.double().abs()).all())
    # the rest itself is exact: hi + (x - hi) == x in f32
    assert torch.equal(hi + (xt - hi), xt)


def test_cluster_halves_give_one_s_to_both_ctas():
    """From 256 on each CTA adds the other's partial to its own; f32
    addition commutes, so both hold the same S bit for bit and run the
    same softmax."""
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.normal(size=(64, 320)).astype(np.float32))
            for _ in range(2))
    own = product(q[:, :160], k[:16, :160].T, "3xtf32")
    other = product(q[:, 160:], k[:16, 160:].T, "3xtf32")
    assert torch.equal(own + other, other + own)


if __name__ == "__main__":
    # each design's worst |model - JAX| / limit at every case, from the
    # root of the checkout:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_flash_split32.py
    print("d causal t: 3xtf32 bf16x3 1xtf32 (x the f32 limit)")
    for d, causal, t in CASES:
        q, k, v, want, limit = _case(d, causal, t)
        print(d, causal, t, *(round(_ratio(tile_model(q, k, v, causal, des),
                                           want, limit), 4)
                              for des in ("3xtf32", "bf16x3", "1xtf32")))

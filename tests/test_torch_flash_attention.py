"""The port's flash attention vs the JAX Pallas kernel.

``ray_tpu_torch.ops.flash_attention`` on CPU tensors (its plain PyTorch
path) against ``ray_tpu.ops.flash_attention`` in Pallas interpreter mode
on the same seeded numpy inputs, with the cases and tolerance of
tests/test_flash_attention.py (atol 2e-5 in f32), and the same
ValueErrors raised before any device work."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as ref_flash
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import flash_attention, flash_attention_plain


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _qkv(b=2, t=128, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(3)]


CASES = [
    # (name, t, seed, causal, block_q, block_k)
    ("dense", 128, 0, False, 32, 32),
    ("causal", 128, 1, True, 32, 32),
    ("uneven_blocks", 96, 2, True, 48, 32),
    ("single_block", 32, 3, False, 64, 64),     # blocks clamp to t
]


@pytest.mark.parametrize("name,t,seed,causal,bq,bk", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_jax_kernel(name, t, seed, causal, bq, bk):
    q, k, v = _qkv(t=t, seed=seed)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=bq,
                                block_k=bk, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, block_q=bq,
                          block_k=bk)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_keeps_dtype_and_f32_math(dtype):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(t=64, seed=4))
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == dtype
    want = flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=True).to(dtype)
    assert torch.equal(got, want)


def test_shape_validation_matches_jax():
    q, k, v = _qkv(t=100)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    with pytest.raises(ValueError) as ref_err:
        ref_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True)
    with pytest.raises(ValueError) as port_err:
        flash_attention(tq, tk, tv, block_q=32, block_k=32)
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError) as ref_err:
        ref_flash(jq, jk, jv[:, :, :1], interpret=True)
    with pytest.raises(ValueError) as port_err:
        flash_attention(tq, tk, tv[:, :, :1])
    # the same text up to the shapes, which print as tuple / torch.Size
    head = "q/k/v must share shape (batch, seq, heads, dim); got "
    assert str(ref_err.value).startswith(head)
    assert str(port_err.value).startswith(head)


def test_non_cpu_tensor_never_takes_the_plain_path():
    q, k, v = (torch.from_numpy(x).to("meta") for x in _qkv(t=64))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before

"""Sequence parallelism in the port: ring attention + Ulysses against the
JAX package's, on 8 CPU ranks beside the conftest's 8-device mesh.

Every case of tests/test_ring_attention.py at its shapes (B, T, H, D = 2,
64, 4, 16; Ulysses at H = 8), seeded with numpy and fed to both packages:
the port's output within atol 2e-5 of the reference's (the bar of that
file), and of the port's own ``full_attention``.  Then the dry run's
sequence-parallel training step: the port's causal ring loss and its
gradients (``torch.autograd``) against JAX's ``value_and_grad`` through
the reference's ring, within 1e-4."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

# the packages' ``ops`` export the function under the module's name
ref = importlib.import_module("ray_tpu.ops.ring_attention")
port = importlib.import_module("ray_tpu_torch.ops.ring_attention")

B, T, H, D = 2, 64, 4, 16       # T splits 8 ways
ATOL = 2e-5
RANKS = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()), ("sp",))


def _qkv(seed, h):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, h, D)).astype(np.float32)
                 for _ in range(3))


def _both(fn_name, arrays, mesh, **kw):
    """(port output, reference output) as numpy for the same inputs."""
    pt = [torch.from_numpy(a) for a in arrays]
    jx = [jnp.asarray(a) for a in arrays]
    if fn_name == "full_attention":
        return (getattr(port, fn_name)(*pt, **kw).numpy(),
                np.asarray(getattr(ref, fn_name)(*jx, **kw)))
    return (getattr(port, fn_name)(*pt, mesh=RANKS, **kw).numpy(),
            np.asarray(getattr(ref, fn_name)(*jx, mesh=mesh, **kw)))


@pytest.mark.parametrize("fn_name,heads", [("ring_attention", H),
                                           ("ulysses_attention", 8),
                                           ("full_attention", H)])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_the_reference_and_full_attention(mesh, fn_name, heads,
                                                  causal):
    arrays = _qkv(0 if heads == H else 2, heads)
    got, want = _both(fn_name, arrays, mesh, causal=causal)
    np.testing.assert_allclose(got, want, atol=ATOL)
    full = port.full_attention(*[torch.from_numpy(a) for a in arrays],
                               causal=causal).numpy()
    np.testing.assert_allclose(got, full, atol=ATOL)


def test_long_sequence_beyond_one_block(mesh):
    """tests/test_ring_attention.py's hot key: every position must
    attend across ALL blocks, not just its own."""
    rng = np.random.default_rng(1)
    t = 8 * 16
    q = rng.normal(size=(1, t, 2, 8)).astype(np.float32)
    k = np.zeros((1, t, 2, 8), np.float32)
    k[0, 3] = 10.0
    v = rng.normal(size=(1, t, 2, 8)).astype(np.float32)
    got = port.ring_attention(*map(torch.from_numpy, (q, k, v)),
                              mesh=RANKS).numpy()
    want = np.asarray(ref.ring_attention(*map(jnp.asarray, (q, k, v)),
                                         mesh=mesh))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_head_divisibility_enforced():
    bad = torch.zeros((1, 64, 3, 8))                     # 3 heads, 8 ranks
    with pytest.raises(ValueError, match="divisible"):
        port.ulysses_attention(bad, bad, bad, mesh=RANKS)


def test_agreement_between_strategies():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 8))
    np.testing.assert_allclose(
        port.ring_attention(q, k, v, mesh=RANKS).numpy(),
        port.ulysses_attention(q, k, v, mesh=RANKS).numpy(), atol=ATOL)


def test_highest_precision_is_pinned_inside_the_call():
    """A caller's TF32 setting is put back after the call, and a
    precision the port does not know raises."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, H))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        port.ring_attention(q, k, v, mesh=RANKS, precision="highest")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(
        port.full_attention(q, k, v, precision=jax.lax.Precision.HIGHEST),
        port.full_attention(q, k, v, precision="highest"))
    with pytest.raises(ValueError, match="precision"):
        port.full_attention(q, k, v, precision="bfloat16")


def test_dryrun_sp_step_equals_jax_value_and_grad(mesh):
    """The dry run's training step at 8 ranks: loss and every gradient
    within 1e-4 of ``jax.value_and_grad`` through the reference's ring
    on the same seeded params and tokens (rng 7, as both dry runs)."""
    from ray_tpu_torch import entry
    loss, grads = entry._dryrun_sp_step(RANKS, port.full_attention,
                                        port.ring_attention)
    n = 8
    b, t, h, dh = 2, 8 * n, 2, 8
    e = h * dh
    rng = np.random.default_rng(7)
    params = {name: jnp.asarray(rng.normal(size=(e, e)) * 0.1, jnp.float32)
              for name in ("wq", "wk", "wv")}
    tokens = jnp.asarray(rng.normal(size=(b, t, e)).astype(np.float32))
    prec = jax.lax.Precision.HIGHEST

    def sp_loss(p, x):
        def proj(w):
            return (x @ w).reshape(b, t, h, dh)
        out = ref.ring_attention(proj(p["wq"]), proj(p["wk"]),
                                 proj(p["wv"]), mesh=mesh, causal=True,
                                 precision=prec)
        return jnp.mean(out ** 2)

    want_loss, want_grads = jax.value_and_grad(sp_loss)(params, tokens)
    assert abs(loss - float(want_loss)) < 1e-4
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[name]),
                                   atol=1e-4)

"""The port's heartbeat device programs vs the JAX package's, bit for bit.

``ray_tpu_torch.ops.hybrid_kernel`` on CPU tensors (the plain PyTorch
path of every function, including ``waterfill_scan_plain`` behind
``schedule_grouped``/``fused_beat``) against ``ray_tpu.ops.hybrid_kernel``
under jit on the CPU, on the same seeded numpy inputs: padding lanes,
the empty request, zero counts, negative-avail override rows, an
all-masked class, ``require_available``, and a node count that is not a
multiple of 64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import hybrid_kernel as ref
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import hybrid_kernel as port

SCALE = 1 << 12
THRESHOLDS = [0, SCALE // 2, 2 * SCALE + 1]


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _problem(seed, n=77, r=6, g=9, c=12):
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 3200, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.1
    reqs = rng.integers(0, 500, size=(c, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.4] = 0
    reqs[0] = 0                                  # the empty request
    group_reqs = reqs[rng.integers(0, c, size=g)]
    group_reqs[1] = 0
    counts = rng.integers(0, 300, size=g).astype(np.int32)
    counts[2] = 0                                # a zero-count (padding) row
    masks = rng.random((g, n)) > 0.15
    masks[3] = False                             # an all-masked class
    return rng, totals, avail, mask, reqs, group_reqs, counts, masks


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("require_available", [False, True])
def test_schedule_grouped_bit_exact(seed, thr, require_available):
    _, totals, avail, mask, _, greqs, counts, masks = _problem(seed)
    avail[5] = -avail[5] - 40                    # an overcommitted row
    got = port.schedule_grouped(_t(totals), _t(avail), _t(mask), _t(greqs),
                                _t(counts), _t(masks), thr,
                                require_available=require_available)
    want = ref.schedule_grouped(_j(totals), _j(avail), _j(mask), _j(greqs),
                                _j(counts), _j(masks), jnp.int32(thr),
                                require_available=require_available)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_schedule_grouped_np_matches_reference():
    _, totals, avail, mask, _, greqs, counts, _ = _problem(3, n=64)
    got = port.schedule_grouped_np(totals, avail, mask, greqs, counts,
                                   device="cpu")
    want = ref.schedule_grouped_np(totals, avail, mask, greqs, counts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_waterfill_scan_takes_plain_path_only_on_cpu():
    _, totals, avail, mask, _, greqs, counts, masks = _problem(4)
    args = [_t(x) for x in (totals, avail, mask, greqs, counts, masks)]
    before = port.waterfill_scan.launches
    got = port.waterfill_scan(*args, SCALE // 2)
    plain = port.waterfill_scan_plain(*args, SCALE // 2)
    assert port.waterfill_scan.launches == before     # no kernel on CPU
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="unsupported device"):
        port.waterfill_scan(*meta, SCALE // 2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("thr", THRESHOLDS)
def test_full_rescore_bit_exact(seed, thr):
    _, totals, avail, mask, reqs, *_ = _problem(seed)
    got = port.full_rescore(_t(totals), _t(avail), _t(mask), _t(reqs), thr)
    want = ref.full_rescore(_j(totals), _j(avail), _j(mask), _j(reqs),
                            jnp.int32(thr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_dirty_rows_bit_exact(seed):
    rng, totals, avail, mask, reqs, *_ = _problem(seed)
    n, r = totals.shape
    thr = SCALE // 2
    keys = np.asarray(ref.full_rescore(_j(totals), _j(avail), _j(mask),
                                       _j(reqs), jnp.int32(thr)))
    b = 8
    idx = np.full((b,), n, np.int32)             # padding lanes == N
    rows = np.sort(rng.choice(n, size=5, replace=False)).astype(np.int32)
    idx[:5] = rows
    rt = rng.integers(0, 3200, size=(b, r)).astype(np.int32)
    ra = (rt * rng.random((b, r))).astype(np.int32)
    ra[1] -= 700                                 # negative avail row
    rm = rng.random(b) > 0.3
    got = port.apply_dirty_rows(_t(totals), _t(avail), _t(mask), _t(keys),
                                _t(reqs), _t(idx), _t(rt), _t(ra), _t(rm),
                                thr)
    want = ref.apply_dirty_rows(_j(totals), _j(avail), _j(mask), _j(keys),
                                _j(reqs), _j(idx), _j(rt), _j(ra), _j(rm),
                                jnp.int32(thr))
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_dirty_classes_bit_exact(seed):
    rng, totals, avail, mask, reqs, *_ = _problem(seed)
    c, r = reqs.shape
    thr = SCALE // 2
    keys = np.asarray(ref.full_rescore(_j(totals), _j(avail), _j(mask),
                                       _j(reqs), jnp.int32(thr)))
    idx = np.array([3, 7, c, c], np.int32)       # padding slots == C
    vecs = rng.integers(0, 500, size=(4, r)).astype(np.int32)
    vecs[1] = 0
    got = port.apply_dirty_classes(_t(totals), _t(avail), _t(mask),
                                   _t(keys), _t(reqs), _t(idx), _t(vecs),
                                   thr)
    want = ref.apply_dirty_classes(_j(totals), _j(avail), _j(mask),
                                   _j(keys), _j(reqs), _j(idx), _j(vecs),
                                   jnp.int32(thr))
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("require_available", [False, True])
def test_fused_beat_bit_exact(seed, require_available):
    rng, totals, avail, mask, reqs, *_ = _problem(seed)
    n, r = totals.shape
    c = reqs.shape[0]
    thr = SCALE // 2
    keys = np.array(ref.full_rescore(_j(totals), _j(avail), _j(mask),
                                     _j(reqs), jnp.int32(thr)))
    keys[:, 10] = 2**31 - 1                      # an all-INF column
    keys[4] = 2**31 - 1                          # an all-INF row: argmin 0
    gp = 16
    slots = np.full((gp,), c, np.int32)          # padding slots == C
    slots[:10] = rng.integers(0, c, size=10)
    counts = np.zeros((gp,), np.int32)
    counts[:10] = rng.integers(0, 400, size=10)
    counts[3] = 0
    extra = rng.random(n) > 0.2
    ov_idx = np.full((8,), n, np.int32)
    ov_idx[:3] = [2, 11, 40]
    ov_av = rng.integers(-900, 1500, size=(8, r)).astype(np.int32)
    ov_av[1] = -3000                             # a negative-avail override
    got = port.fused_beat(_t(totals), _t(avail), _t(mask), _t(keys),
                          _t(reqs), _t(slots), _t(counts), _t(extra),
                          _t(ov_idx), _t(ov_av), thr,
                          require_available=require_available)
    want = ref.fused_beat(_j(totals), _j(avail), _j(mask), _j(keys),
                          _j(reqs), _j(slots), _j(counts), _j(extra),
                          _j(ov_idx), _j(ov_av), jnp.int32(thr),
                          require_available=require_available)
    assert got[0].shape == (gp + c, n + 1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_schedule_group_host_agrees_with_plain_scan():
    """The numpy host twin, the plain torch scan and the JAX scan agree
    class by class on carried avail (the three-way parity chip_smoke.py
    holds the CUDA kernel to)."""
    _, totals, avail, mask, _, greqs, counts, masks = _problem(5)
    got = port.waterfill_scan_plain(*[_t(x) for x in (
        totals, avail, mask, greqs, counts, masks)], SCALE // 2)
    av = avail.astype(np.int64)
    for g in range(greqs.shape[0]):
        row, av = port.schedule_group_host(av, totals, mask, greqs[g],
                                           counts[g], masks[g], SCALE // 2)
        np.testing.assert_array_equal(got[0][g].numpy(), row)
    np.testing.assert_array_equal(got[1].numpy(), av)

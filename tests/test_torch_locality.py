"""The port's localized water-fill vs the JAX package's, bit for bit.

``ray_tpu_torch.ops.locality_kernel.schedule_grouped_localized`` on CPU
tensors (the plain path: ``waterfill_scan_plain(..., pref_rows=...)``)
against ``ray_tpu.ops.locality_kernel.schedule_grouped_localized`` under
jit on the CPU and against the numpy host twin
``schedule_group_host(pref_row=...)`` class by class, on the same seeded
inputs.  Each problem holds an infeasible preferred row, a preferred row
masked out by its class's avoid row, negative avail at a preferred row,
count-0 padding classes and classes without a preference; half the
cases add a beat-scoped ``extra_mask``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import locality_kernel as ref
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import hybrid_kernel as port_hk
from ray_tpu_torch.ops import locality_kernel as port
from ray_tpu_torch.scheduling.contract import threshold_fp

THR = threshold_fp(None)


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def localized_problem(seed, n, r, g):
    """Seeded (totals, avail, node_mask, reqs, counts, masks, prefs,
    extra) with every localized corner case present.  Overcommit stays
    within one total, where the host twin's int64 arithmetic agrees."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(200, 4000, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    node_mask = rng.random(n) > 0.05
    reqs = rng.integers(0, 300, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.4] = 0
    counts = rng.integers(1, 400, size=g).astype(np.int32)
    masks = rng.random((g, n)) > 0.1
    prefs = np.where(rng.random(g) < 0.5,
                     rng.integers(0, n, size=g), -1).astype(np.int32)
    # the corner cases, on the first classes
    reqs[0, 0] = max(int(reqs[0, 0]), 50)
    prefs[0] = 1
    totals[1, 0] = 10                          # preferred row infeasible
    prefs[1] = 2
    masks[1, 2] = False                        # ... masked by its avoid row
    prefs[2] = 3
    reqs[2, 0] = max(int(reqs[2, 0]), 20)
    totals[3, 0] = max(int(totals[3, 0]), 400)
    avail[3] = -(totals[3] // 2)               # ... negative avail there
    node_mask[[1, 2, 3]] = True
    counts[g // 2:][::3] = 0                   # count-0 padding classes
    prefs[g - 1] = n + 5                       # clipped to the last row
    extra = rng.random(n) > 0.1
    extra[3] = True
    return totals, avail, node_mask, reqs, counts, masks, prefs, extra


def host_localized(totals, avail, node_mask, reqs, counts, masks, prefs):
    av = np.asarray(avail, np.int64)
    rows = []
    for gi in range(reqs.shape[0]):
        pref = int(prefs[gi])
        row, av = port_hk.schedule_group_host(
            av, totals, node_mask, reqs[gi], counts[gi], masks[gi], THR,
            pref_row=min(pref, totals.shape[0] - 1) if pref >= 0 else -1)
        rows.append(row)
    return np.stack(rows), av


SHAPES = [(16, 3, 8), (257, 8, 33), (64, 4, 64)]


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("use_extra", [False, True])
def test_localized_bit_exact(seed, shape, use_extra):
    totals, avail, nmask, reqs, counts, masks, prefs, extra = \
        localized_problem(seed, *shape)
    em = extra if use_extra else None
    t = torch.from_numpy
    got_c, got_a = port.schedule_grouped_localized(
        t(totals), t(avail), t(nmask), t(reqs), t(counts), t(masks),
        t(prefs), THR, None if em is None else t(em))
    want_c, want_a = ref.schedule_grouped_localized(
        jnp.asarray(totals), jnp.asarray(avail), jnp.asarray(nmask),
        jnp.asarray(reqs), jnp.asarray(counts), jnp.asarray(masks),
        jnp.asarray(prefs), jnp.int32(THR),
        None if em is None else jnp.asarray(em))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    host_c, host_a = host_localized(
        totals, avail, nmask if em is None else nmask & em, reqs, counts,
        masks, prefs)
    np.testing.assert_array_equal(got_c.numpy(), host_c)
    np.testing.assert_array_equal(got_a.numpy(), host_a)


def test_corner_cases_do_what_they_say():
    """The problem's corner cases take the branches they are meant to."""
    totals, avail, nmask, reqs, counts, masks, prefs, _ = \
        localized_problem(0, 16, 3, 8)
    c, _ = port.schedule_grouped_localized(
        *(torch.from_numpy(x) for x in (totals, avail, nmask, reqs, counts,
                                        masks, prefs)), THR)
    c = c.numpy()
    # infeasible / masked preferred rows fall through to the water-fill
    assert c[0, 1] == 0 and c[1, 2] == 0
    # a feasible preferred row with negative avail takes the whole class
    assert c[2, 3] >= counts[2] > 0


def test_localized_np_matches_reference():
    totals, avail, nmask, reqs, counts, masks, prefs, extra = \
        localized_problem(11, 64, 4, 16)
    got = port.schedule_grouped_localized_np(
        totals, avail, nmask, reqs, counts, prefs, group_masks=masks,
        extra_mask=extra, device="cpu")
    want = ref.schedule_grouped_localized_np(
        totals, avail, nmask, reqs, counts, prefs, group_masks=masks,
        extra_mask=extra)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert port_hk.waterfill_scan.localized_launches == 0   # plain path


def test_no_preference_is_the_plain_scan():
    """pref_rows all -1 gives exactly the plain water-fill."""
    totals, avail, nmask, reqs, counts, masks, _, _ = \
        localized_problem(3, 64, 4, 16)
    prefs = np.full(16, -1, np.int32)
    t = torch.from_numpy
    got = port.schedule_grouped_localized(
        t(totals), t(avail), t(nmask), t(reqs), t(counts), t(masks),
        t(prefs), THR)
    want = port_hk.waterfill_scan_plain(
        t(totals), t(avail), t(nmask), t(reqs), t(counts), t(masks), THR)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())

"""The water-fill kernel's per-class search, modelled in numpy and held to
the 15-step bisection of the plain version, bit for bit.

``ray_tpu_torch/ops/csrc/waterfill.cu`` finds the water level L* of a
class with 7 levels per round (5 rounds instead of 15 bisection steps),
with ``used * SCALE + 1`` hoisted per (row, requested column) and every
level's floor division done by a per-column reciprocal.  ``model_class``
repeats that arithmetic in numpy (int64 holding int32 values, wrapped
where the kernel wraps) and must return exactly what the 15-step rule of
``hybrid_kernel._slots_at_or_below`` / ``_schedule_group`` returns: L*,
the base and at-level slot counts, and the carried avail — against the
port's plain version and the JAX package's, on contract-bounded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import hybrid_kernel as ref
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import hybrid_kernel as hk

SCALE = 1 << 12
BIG = 1 << 30
TOP = 2 * SCALE + 1          # "no level in [0, 2*SCALE] suffices"
PROBES = 7                   # levels per round
MAX_TOTAL_CU = 1 << 17


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def wrap(x):
    """int32 wrap of int64 values (the kernel's wadd/wsub/wmul)."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def reciprocal(d):
    """The kernel's (m, sh) for a divisor d >= 1 (``setup_class`` in
    waterfill.cu: l = ceil(log2 d), m = ceil(2**(31+l) / d), sh = 31+l)."""
    l = (d - 1).bit_length()                       # ceil(log2 d)
    return -(-(1 << (31 + l)) // d), 31 + l


def floordiv_rcp(x, m, sh):
    """floor(x / d) for int32 x by the reciprocal of d (waterfill.cu's
    ``floordiv_rcp``)."""
    x = np.asarray(x, np.int64)
    u = np.where(x >= 0, x, ~x)                    # < 2**31
    q = (u * m) >> sh                              # u * m < 2**63
    return np.where(x >= 0, q, ~q)


def search_round(lo, hi, ok):
    """One round of the k-level search in waterfill.cu's
    ``waterfill_cluster_kernel``: probe lo + j*step - 1 (j = 1..7, step =
    ceil((hi - lo) / 8), clamped to hi - 1) and keep the first ok
    sub-interval.  ``ok`` maps the 7 levels to 7 booleans."""
    step = (hi - lo + PROBES) // (PROBES + 1)
    probes = [lo + (j + 1) * step - 1 for j in range(PROBES)]
    good = ok([min(p, hi - 1) for p in probes])
    jstar = next((j for j in range(PROBES) if probes[j] >= hi or good[j]),
                 PROBES)
    new_hi = min(probes[jstar], hi) if jstar < PROBES else hi
    return (lo + jstar * step if jstar > 0 else lo), new_hi


def model_class(totals, avail, mask, req, count, thr_fp):
    """The kernel's per-class arithmetic up to the allocation: returns
    (l_star, base, at_level, alloc, rounds)."""
    totals = totals.astype(np.int64)
    avail = avail.astype(np.int64)
    pos = np.flatnonzero(req > 0)
    t, a, q = totals[:, pos], avail[:, pos], req[pos].astype(np.int64)
    feas = mask & (t >= q).all(axis=1)
    caps = (a // q).min(axis=1, initial=BIG)
    m_max = np.where(feas & (pos.size > 0), np.clip(caps, 0, BIG), 0)
    u1 = wrap(wrap(wrap(t - a) * SCALE) + 1)       # hoisted per class
    rcp = [reciprocal(int(max(wrap(qi * SCALE), 1))) for qi in q]

    def m_of(levels):                              # (N, K)
        lv = np.asarray(levels, np.int64)
        lp1 = np.where(lv < thr_fp, thr_fp - 1, lv) + 1
        jc = np.full((t.shape[0], lv.size), BIG, np.int64)
        for p, (m, sh) in enumerate(rcp):
            num = wrap(wrap(lp1[None, :] * t[:, p:p + 1]) - u1[:, p:p + 1])
            jc = np.minimum(jc, np.clip(floordiv_rcp(num, m, sh), 0, BIG))
        return np.where(m_max[:, None] > 0,
                        np.minimum(m_max[:, None], jc), 0)

    n_avail = min(int(count), int(wrap(m_max.sum())))
    lo, hi, rounds = 0, TOP, 0
    while lo < hi:
        lo, hi = search_round(
            lo, hi, lambda lv: wrap(m_of(lv).sum(axis=0)) >= n_avail)
        rounds += 1
    l_star = lo
    both = m_of([max(l_star - 1, 0), l_star])
    base = both[:, 0] if l_star > 0 else np.zeros(t.shape[0], np.int64)
    at_level = both[:, 1]
    extra = wrap(at_level - base)
    rem = wrap(n_avail - wrap(base.sum()))
    prefix = wrap(np.cumsum(extra) - extra)
    give = np.minimum(np.maximum(wrap(rem - prefix), 0), extra)
    return l_star, base, at_level, wrap(base + give), rounds


def reference_class(totals, avail, mask, req, count, thr_fp):
    """The 15-step rule of the port's plain version: (l_star, base,
    at_level, new_avail)."""
    tt, ta, tm, tr = (torch.from_numpy(np.ascontiguousarray(x))
                      for x in (totals, avail, mask, req))
    tc = torch.tensor(count, dtype=torch.int32)
    req_pos = tr > 0
    feas = torch.where(req_pos[None, :], tt >= tr[None, :], True).all(
        dim=1) & tm
    caps = torch.where(req_pos[None, :],
                       hk._floordiv(ta, tr.clamp_min(1)[None, :]), BIG)
    m_max = torch.where(feas & req_pos.any(), caps.amin(dim=1).clamp(0, BIG),
                        0).to(torch.int32)
    n_avail = torch.minimum(tc, hk._i32sum(m_max))

    def m_of(L):
        return hk._slots_at_or_below(torch.tensor(L, dtype=torch.int32), tt,
                                     tt - ta, tr, req_pos, m_max, thr_fp)

    lo, hi = 0, 2 * SCALE
    for _ in range(hk._BISECT_STEPS):
        mid = (lo + hi) // 2
        if int(hk._i32sum(m_of(mid))) >= int(n_avail):
            hi = mid
        else:
            lo = mid + 1
    base = m_of(max(lo - 1, 0)) if lo > 0 else torch.zeros_like(m_max)
    _, new_avail = hk._schedule_group(ta, tt, tm, tr, tc, torch.ones_like(tm),
                                      thr_fp)
    return lo, base.numpy(), m_of(lo).numpy(), new_avail.numpy()


def _problem(seed, n=240, r=6, g=6):
    """Contract-bounded: totals <= MAX_TOTAL_CU, avail <= totals, some rows
    overcommitted below zero (within one total), masked and dead rows."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, MAX_TOTAL_CU + 1, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    neg = rng.random(n) < 0.05
    avail[neg] = -(totals[neg] * rng.random((int(neg.sum()), r))).astype(
        np.int32)
    mask = rng.random(n) > 0.1
    reqs = rng.integers(1, 4000, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.6] = 0
    reqs[np.arange(g), rng.integers(0, r, size=g)] = rng.integers(
        1, 4000, size=g)                           # >= 1 requested column
    return rng, totals, avail, mask, reqs


def _capacity(totals, avail, mask, req):
    """The class's total slot capacity (sum of m_max)."""
    pos = req > 0
    feas = mask & np.where(pos, totals >= req, True).all(axis=1)
    caps = np.where(pos, avail.astype(np.int64) // np.maximum(req, 1),
                    BIG).min(axis=1)
    return int(np.where(feas & pos.any(), np.clip(caps, 0, BIG), 0).sum())


# how many tasks each class asks for, from its capacity
COUNTS = {
    "mixed": lambda rng, cap: int(rng.integers(0, 2 * cap + 2)),
    "n_avail_zero": lambda rng, cap: 0,
    "n_avail_equals_capacity": lambda rng, cap: cap,
    "far_above_capacity": lambda rng, cap: 50 * cap + 10**6,
    "one_task": lambda rng, cap: 1,
}


@pytest.mark.parametrize("thr_fp", [0, SCALE // 2, 2 * SCALE + 1, 5 * SCALE])
@pytest.mark.parametrize("case", sorted(COUNTS))
def test_model_equals_15_step_bisection(case, thr_fp):
    seed = sorted(COUNTS).index(case) * 7 + thr_fp % 97
    rng, totals, avail, mask, reqs = _problem(seed)
    reqs[0] = 0                                    # the empty request
    seen_top = False
    for gi in range(reqs.shape[0]):
        req = reqs[gi]
        count = COUNTS[case](rng, _capacity(totals, avail, mask, req))
        count = min(count, 2**31 - 1)
        l_m, base_m, lvl_m, alloc, rounds = model_class(
            totals, avail, mask, req, count, thr_fp)
        l_r, base_r, lvl_r, new_avail = reference_class(
            totals, avail, mask, req, count, thr_fp)
        assert rounds <= 5
        assert l_m == l_r, (gi, l_m, l_r)
        np.testing.assert_array_equal(base_m, base_r)
        np.testing.assert_array_equal(lvl_m, lvl_r)
        np.testing.assert_array_equal(
            wrap(avail - alloc[:, None] * req[None, :].astype(np.int64)),
            new_avail)
        _, jax_avail = ref._schedule_group(
            jnp.asarray(avail), jnp.asarray(totals), jnp.asarray(mask),
            jnp.asarray(req), jnp.int32(count), jnp.ones_like(mask),
            jnp.int32(thr_fp))
        np.testing.assert_array_equal(np.asarray(jax_avail), new_avail)
        seen_top |= l_m == TOP
        avail = new_avail
    if thr_fp == 5 * SCALE and case == "far_above_capacity":
        # lp1 * t wraps at every level: no level suffices, L* = 2*SCALE+1
        assert seen_top


def test_model_no_level_suffices():
    """A row whose count at every level stays below n_avail (lp1 * t wraps
    negative): both rules answer 2*SCALE + 1."""
    totals = np.full((4, 2), MAX_TOTAL_CU, np.int32)
    avail = totals.copy()
    mask = np.ones(4, bool)
    req = np.array([1000, 0], np.int32)
    for count in (1, 10**6):
        got = model_class(totals, avail, mask, req, count, 5 * SCALE)
        want = reference_class(totals, avail, mask, req, count, 5 * SCALE)
        assert got[0] == want[0] == TOP
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reciprocal_division_is_floor_division(seed):
    rng = np.random.default_rng(seed)
    divisors = np.concatenate([
        np.arange(1, 70), 2 ** np.arange(31), 2 ** np.arange(1, 31) - 1,
        2 ** np.arange(1, 31) + 1, SCALE * rng.integers(1, MAX_TOTAL_CU + 1,
                                                        size=200),
        rng.integers(1, 2**31, size=200)]).astype(np.int64)
    divisors = divisors[(divisors >= 1) & (divisors < 2**31)]
    x = np.concatenate([
        [0, 1, -1, 2**31 - 1, -2**31, -2**31 + 1, 2**30, -2**30],
        rng.integers(-2**31, 2**31, size=400)]).astype(np.int64)
    for d in divisors:
        m, sh = reciprocal(int(d))
        assert m < 2**32
        edges = np.concatenate([x, d * np.arange(-3, 4), d * np.arange(-3, 4)
                                - 1, d * np.arange(-3, 4) + 1])
        edges = edges[(edges >= -2**31) & (edges < 2**31)]
        np.testing.assert_array_equal(floordiv_rcp(edges, m, sh),
                                      edges // d)


@pytest.mark.parametrize("thr_fp", [0, SCALE // 2, 2 * SCALE + 1])
@pytest.mark.parametrize("n, r", [(64, 64), (40, 128), (12, 512)])
def test_wide_classes_equal_the_bisection_and_jax(n, r, thr_fp):
    """The widths where the kernel's rows spill out of shared memory on
    the card (64, 128 and 512 resource kinds), cut in nodes, with classes
    that request 1, 3 and 12 columns: the last goes past the 8 columns
    whose used*SCALE + 1 the kernel keeps on chip when it spills.  The
    model equals the 15-step rule class by class, and the plain scan that
    the card's tests hold the kernel to equals the JAX scan."""
    rng, totals, avail, mask, _ = _problem(n * r + thr_fp % 97, n=n, r=r)
    reqs = np.zeros((3, r), np.int32)
    for gi, k in enumerate((1, 3, 12)):
        cols = rng.choice(r, size=k, replace=False)
        reqs[gi, cols] = rng.integers(1, 4000, size=k)
    counts = rng.integers(1, 200, size=3).astype(np.int32)
    av = avail
    for gi in range(3):
        got = model_class(totals, av, mask, reqs[gi], counts[gi], thr_fp)
        want = reference_class(totals, av, mask, reqs[gi], counts[gi],
                               thr_fp)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        av = want[3]
    masks = np.ones((3, n), bool)
    pc, pa = hk.waterfill_scan(*(torch.from_numpy(x) for x in (
        totals, avail, mask, reqs, counts, masks)), thr_fp)
    jc, ja = ref.schedule_grouped(*(jnp.asarray(x) for x in (
        totals, avail, mask, reqs, counts, masks)), jnp.int32(thr_fp))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pa.numpy(), av)
    assert int(pc[:, :n].sum()) > 0          # something was placed

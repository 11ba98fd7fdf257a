"""The port's top-k rounds vs the JAX function.

``schedule_grouped_topk`` spreads each class evenly over its k best keys
and rotates the remainder by a seeded draw.  The JAX function draws with
``jax.random`` on the device; the port draws on the host (Philox keyed by
(seed, round)), so the two agree on everything except where the
remainder lands (``ray_tpu/ops/locality_kernel.py:17-25``).  Held here,
class by class on the port's own running ``avail``: the same top-k node
set (from a numpy sort of the keys), ``alloc`` in {base, base + 1} on it
with the same multiset of values as the JAX function's, the same
overflow column, consumption capped at availability; bit for bit where
no class has a remainder; determinism per (seed, round).  Then a
runtime burst with ``scheduler_top_k_fraction`` > 0 places through the
raylet's top-k rounds.
"""

import numpy as np
import pytest
import torch

from ray_tpu.ops.locality_kernel import \
    schedule_grouped_topk_np as jax_topk_np
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops.hybrid_kernel import _INF_KEY, _keys_one_req
from ray_tpu_torch.ops.locality_kernel import (schedule_grouped_topk_np,
                                               topk_draws)
from ray_tpu_torch.scheduling.contract import threshold_fp


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _problem(seed, n=48, r=4, g=8):
    rng = np.random.default_rng(seed)
    totals = rng.integers(200, 3000, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.1
    reqs = rng.integers(0, 400, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.4] = 0
    counts = rng.integers(0, 60, size=g).astype(np.int32)
    masks = rng.random((g, n)) > 0.15
    reqs[-1] = 5000                     # feasible nowhere: overflows
    return totals, avail, mask, reqs, counts, masks


def _topk_set(totals, avail, req, mask, k):
    keys = _keys_one_req(torch.tensor(totals), torch.tensor(avail),
                         torch.tensor(req), threshold_fp(None),
                         torch.tensor(mask)).numpy()
    order = np.argsort(keys, kind="stable")
    return set(order[:k].tolist()), int((keys != _INF_KEY).sum())


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("k_abs,k_frac", [(1, 0.25), (3, 0.0), (2, 0.5)])
def test_class_by_class_against_jax(seed, k_abs, k_frac):
    totals, avail, mask, reqs, counts, masks = _problem(seed)
    n = totals.shape[0]
    kw = dict(k_abs=k_abs, k_frac=k_frac)
    got, new_avail = schedule_grouped_topk_np(
        totals, avail, mask, reqs, counts, seed, 3, group_masks=masks,
        device="cpu", **kw)
    av = avail.copy()
    for g in range(reqs.shape[0]):
        one = (totals, av, mask, reqs[g:g + 1], counts[g:g + 1])
        want, _ = jax_topk_np(*one, seed=seed, round_index=3,
                              group_masks=masks[g:g + 1], **kw)
        mine, av_next = schedule_grouped_topk_np(
            *one, seed, 3, group_masks=masks[g:g + 1], device="cpu", **kw)
        # k depends only on feasibility (totals, masks), so the G-class
        # call's row holds the same values as well (its avail, and so its
        # support, may differ where earlier remainders landed elsewhere)
        alloc, w = mine[0, :n], want[0, :n]
        assert mine[0, n] == want[0, n] == got[g, n]        # overflow
        assert sorted(alloc.tolist()) == sorted(w.tolist())
        assert sorted(got[g, :n].tolist()) == sorted(w.tolist())
        c = int(counts[g])
        if want[0, n] == 0 and c:
            from fractions import Fraction
            frac = Fraction(k_frac).limit_denominator(1 << 16)
            topk, nf = _topk_set(totals, av, reqs[g],
                                 mask & masks[g], 1)
            k = min(max(k_abs, -((-nf * frac.numerator)
                                 // frac.denominator)), max(nf, 1))
            k = max(k, 1)
            topk, _ = _topk_set(totals, av, reqs[g], mask & masks[g], k)
            base = c // k
            for a in (alloc, w):
                assert set(np.flatnonzero(a).tolist()) <= topk
                assert all(a[i] in (base, base + 1) for i in topk)
        # consumption capped at availability
        req = reqs[g].astype(np.int64)
        pos = req > 0
        cap = np.where(pos[None, :], av // np.maximum(req, 1)[None, :],
                       1 << 30).min(axis=1).clip(0, 1 << 30)
        consumed = np.minimum(alloc, cap)
        assert np.array_equal(av - consumed[:, None] * req[None, :],
                              av_next)
        av = av_next


@pytest.mark.parametrize("seed", range(4))
def test_bit_exact_without_remainders(seed):
    """k fixed at 4 (k_frac 0, k_abs 4, at least 4 feasible nodes) and
    counts multiples of 4: no remainder, so no draw matters."""
    totals, avail, mask, reqs, counts, masks = _problem(seed)
    reqs[-1] = reqs[0]
    mask[:] = True
    masks[:] = True
    counts = (counts // 4 * 4).astype(np.int32)
    kw = dict(k_abs=4, k_frac=0.0)
    got = schedule_grouped_topk_np(totals, avail, mask, reqs, counts,
                                   seed, 1, device="cpu", **kw)
    want = jax_topk_np(totals, avail, mask, reqs, counts, seed=seed,
                       round_index=1, **kw)
    for x, y in zip(got, want):
        assert np.array_equal(x, np.asarray(y))


def test_deterministic_per_seed_and_round():
    totals, avail, mask, reqs, counts, masks = _problem(11)
    counts[:] = 13                      # remainders everywhere

    def run(seed, rnd):
        return schedule_grouped_topk_np(totals, avail, mask, reqs, counts,
                                        seed, rnd, group_masks=masks,
                                        k_frac=0.3, device="cpu")

    a, b = run(5, 2), run(5, 2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    others = [run(5, r)[0] for r in range(3, 9)] + [run(6, 2)[0]]
    assert any(not np.array_equal(a[0], o) for o in others)
    # a group's draw depends on (seed, round, group), not on how many
    # groups the round has
    assert np.array_equal(topk_draws(5, 2, 3), topk_draws(5, 2, 8)[:3])
    d = topk_draws(5, 2, 1000)
    assert d.dtype == np.int32 and d.min() >= 0


def test_runtime_burst_takes_topk_rounds():
    import ray_tpu_torch as rt
    from ray_tpu_torch import api
    rt.init(resources={"CPU": 4, "memory": 4}, num_workers=2,
            system_config={"scheduler_device": "cpu",
                           "scheduler_device_batch_min": 1,
                           "scheduler_top_k_fraction": 0.5})
    try:
        cluster = api._get_runtime().cluster
        for _ in range(3):
            cluster.add_node(resources={"CPU": 2, "memory": 2},
                             num_workers=1)

        @rt.remote
        def sq(x):
            return x * x

        assert rt.get([sq.remote(i) for i in range(200)], timeout=120) \
            == [i * i for i in range(200)]
        rounds = sum(r.topk_rounds for r in cluster.raylets.values())
        assert rounds >= 1
        assert sum(r.delta_rounds for r in cluster.raylets.values()) == 0
    finally:
        rt.shutdown()

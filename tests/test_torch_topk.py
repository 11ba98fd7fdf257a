"""The port's top-k rounds vs the JAX function, bit for bit.

``schedule_grouped_topk`` spreads each class evenly over its k best keys
and rotates the remainder by ``randint(fold_in(fold_in(PRNGKey(seed),
round), g), (), 0, k)``.  The port computes randint's threefry words on
the host in numpy and finishes its span arithmetic on the device, so
``counts`` and ``new_avail`` equal the JAX function's on every seed,
round and k, including k = 1, k = every feasible node and a class that
fits nowhere; each class is also held on its own, on the running
``avail``.  The words themselves are held to ``jax.random`` over wide
seeds, rounds and spans.  Then a runtime burst with
``scheduler_top_k_fraction`` > 0 places through the raylet's top-k
rounds (the raylet-level parity is in ``test_torch_runtime.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.locality_kernel import \
    schedule_grouped_topk_np as jax_topk_np
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops.locality_kernel import (_randint_offset,
                                               schedule_grouped_topk_np,
                                               topk_draws)

# the draws follow JAX's partitionable threefry (its default since 0.5)
jax.config.update("jax_threefry_partitionable", True)


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


# (k_abs, k_frac): k = 1 always, fractions of the feasible nodes, and
# k = every feasible node
K_CASES = [(1, 0.0), (1, 0.25), (3, 0.0), (2, 0.5), (1, 1.0)]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("k_abs,k_frac", K_CASES)
def test_class_by_class_against_jax(seed, k_abs, k_frac):
    totals, avail, mask, reqs, counts, masks = _problem(seed)
    kw = dict(k_abs=k_abs, k_frac=k_frac)
    rnd = 3 + 977 * seed
    got = schedule_grouped_topk_np(totals, avail, mask, reqs, counts,
                                   seed, rnd, group_masks=masks,
                                   device="cpu", **kw)
    want = jax_topk_np(totals, avail, mask, reqs, counts, seed=seed,
                       round_index=rnd, group_masks=masks, **kw)
    for x, y in zip(got, want):
        assert np.array_equal(x, np.asarray(y))
    assert got[0][-1, -1] == counts[-1]          # the class fits nowhere
    # each class alone on the running avail (as group 0 of its call)
    av = avail.copy()
    for g in range(reqs.shape[0]):
        one = (totals, av, mask, reqs[g:g + 1], counts[g:g + 1])
        w_row, w_av = jax_topk_np(*one, seed=seed, round_index=rnd,
                                  group_masks=masks[g:g + 1], **kw)
        m_row, m_av = schedule_grouped_topk_np(
            *one, seed, rnd, group_masks=masks[g:g + 1], device="cpu", **kw)
        assert np.array_equal(m_row, np.asarray(w_row))
        assert np.array_equal(m_av, np.asarray(w_av))
        av = m_av


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
    assert d.shape == (1000, 2) and d.dtype == np.int64
    assert d.min() >= 0 and d.max() < 1 << 32


@pytest.mark.parametrize("part", range(2))
def test_offsets_equal_jax_randint(part):
    """The host words and the device span arithmetic against
    ``jax.random.randint`` itself: seeds past 2**32 and negative, rounds
    to 2**32, spans 1 to 2**31 - 1 (past 2**16 the multiplier wraps)."""
    rng = np.random.default_rng(100 + part)
    spans = [1, 2, 3, 7, 48, 1000, 65535, 65536, 65537, 100003,
             2 ** 31 - 1]
    for _ in range(12):
        seed = int(rng.integers(-2 ** 31, 2 ** 33))
        rnd = int(rng.integers(0, 2 ** 32))
        words = torch.tensor(topk_draws(seed, rnd, 3))
        key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        for g in range(3):
            gk = jax.random.fold_in(key, jnp.int32(g))
            for k in spans + [int(rng.integers(1, 2 ** 31))]:
                want = jax.random.randint(gk, (), 0, jnp.int32(k))
                got = _randint_offset(words[g], torch.tensor(k, dtype=torch.int32))
                assert int(got) == int(want), (seed, rnd, g, k)


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


# -- the plain version at the edges the kernel's design meets ----------------

def _edge(seed, n, r, g, neg=True):
    """A top-k problem with overcommitted rows (negative avail), dead
    rows, per-class masks and an extra mask."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(400, 1 << 17, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.25] = 0
    avail = totals - (totals * rng.random(totals.shape) * 0.9).astype(
        np.int32)
    if neg:
        rows = rng.random(n) < 0.05
        avail[rows] = -(totals[rows] * rng.random((int(rows.sum()), r))
                        ).astype(np.int32)
    mask = rng.random(n) > 0.02
    reqs = rng.integers(0, 4000, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    counts = rng.integers(1, 5000, size=g).astype(np.int32)
    masks = rng.random((g, n)) > 0.1
    extra = rng.random(n) > 0.05
    return dict(totals=totals, avail=avail, mask=mask, reqs=reqs,
                counts=counts, group_masks=masks, extra_mask=extra)


def _infeasible(p):
    p["reqs"][:] = (1 << 17) + 1        # above every total
    return p


def _count_zero(p):
    p["counts"][::2] = 0
    return p


def _no_masks(p):
    p["group_masks"] = p["extra_mask"] = None
    return p


# name: (problem, k_abs, k_frac)
TOPK_EDGES = {
    "n_8192": (lambda: _edge(1, 8192, 6, 3), 1, 0.25),
    "n_not_a_multiple_of_32": (lambda: _edge(2, 77, 5, 9), 1, 0.3),
    "n_past_1024": (lambda: _edge(3, 1025, 4, 6), 2, 0.5),
    "count_zero": (lambda: _count_zero(_edge(4, 300, 4, 8)), 1, 0.25),
    "every_class_infeasible": (lambda: _infeasible(_edge(5, 200, 3, 5)),
                               1, 0.25),
    "k_abs_past_nf": (lambda: _edge(6, 40, 3, 6), 1000, 0.0),
    "k_frac_one": (lambda: _edge(7, 500, 4, 6), 1, 1.0),
    "negative_avail_no_masks": (lambda: _no_masks(_edge(8, 600, 5, 7)),
                                1, 0.1),
    "positive_avail": (lambda: _edge(9, 333, 4, 6, neg=False), 3, 0.0),
}


@pytest.mark.parametrize("case", sorted(TOPK_EDGES))
def test_plain_edges_against_jax(case):
    """``schedule_grouped_topk_plain`` (what CPU tensors take) against the
    JAX function, bit for bit, where the kernel's design is at its edges:
    the contract's 8192 rows, a row count off the warp and 1024 grids, no
    placement at all, k clipped at the feasible count, every key placed,
    overcommitted rows, and the masks absent and given."""
    make, k_abs, k_frac = TOPK_EDGES[case]
    p = make()
    args = (p["totals"], p["avail"], p["mask"], p["reqs"], p["counts"])
    kw = dict(group_masks=p["group_masks"], extra_mask=p["extra_mask"],
              k_abs=k_abs, k_frac=k_frac)
    got = schedule_grouped_topk_np(*args, 5, 77, device="cpu", **kw)
    want = jax_topk_np(*args, seed=5, round_index=77, **kw)
    for x, y in zip(got, want):
        assert np.array_equal(x, np.asarray(y))
    n = p["totals"].shape[0]
    if case == "every_class_infeasible":
        assert np.array_equal(got[0][:, n], p["counts"])
        assert not got[0][:, :n].any()
    else:
        assert got[0][:, :n].any()

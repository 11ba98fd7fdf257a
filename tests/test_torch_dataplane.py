"""The port's bundle, pull and broadcast programs vs the JAX package's.

``ray_tpu_torch.ops.{bundle,pull,broadcast}_kernel`` in PyTorch on the
CPU against ``ray_tpu.ops``'s jitted functions on the CPU and against the
numpy oracles, on the same seeded inputs.  All three are int32 programs
under the scheduling contract: equal bit for bit."""

import numpy as np
import pytest

from ray_tpu.ops import broadcast_kernel as ref_bc
from ray_tpu.ops import bundle_kernel as ref_bk
from ray_tpu.ops import pull_kernel as ref_pk
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import broadcast_kernel as bc
from ray_tpu_torch.ops import bundle_kernel as bk
from ray_tpu_torch.ops import pull_kernel as pk


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def bundle_problem(seed, n_nodes=24, n_res=4, n_groups=12, max_bundles=5):
    """Random groups of every strategy, padded bundle slots, and a few
    groups that cannot be placed (tests/test_bundles.py's generator)."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 2000, size=(n_nodes, n_res)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n_nodes) > 0.1
    reqs = np.zeros((n_groups, max_bundles, n_res), dtype=np.int32)
    valid = np.zeros((n_groups, max_bundles), dtype=bool)
    strategies = rng.integers(0, 4, size=n_groups)
    for p in range(n_groups):
        nb = rng.integers(1, max_bundles + 1)
        valid[p, :nb] = True
        r = rng.integers(0, 400, size=(nb, n_res))
        r[rng.random(r.shape) < 0.4] = 0
        reqs[p, :nb] = r
    return totals, avail, mask, reqs, valid, strategies


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("thr", [None, 0.5])
def test_bundle_groups_bit_exact(seed, thr):
    prob = bundle_problem(seed)
    got = bk.schedule_bundle_groups_np(*prob, spread_threshold=thr,
                                       device="cpu")
    want = ref_bk.schedule_bundle_groups_np(*prob, spread_threshold=thr)
    oracle = bk.schedule_bundle_groups_oracle(*prob, spread_threshold=thr)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, o)
    assert got[1].any() and not got[1].all(), "want placed and failed groups"


def test_bundle_empty_groups_match_reference():
    """A group with no valid bundle: soft strategies succeed, STRICT_PACK
    needs a masked-in node, as the JAX scan decides."""
    totals, avail, _mask, reqs, valid, _ = bundle_problem(1, n_groups=4)
    valid[:] = False
    strategies = np.array([0, 1, 2, 3])
    for mask in (np.ones(24, bool), np.zeros(24, bool)):
        got = bk.schedule_bundle_groups_np(totals, avail, mask, reqs, valid,
                                           strategies, device="cpu")
        want = ref_bk.schedule_bundle_groups_np(totals, avail, mask, reqs,
                                                valid, strategies)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n,r", [(4, 3), (16, 50), (64, 200), (257, 300)])
def test_choose_sources_bit_exact(n, r):
    rng = np.random.default_rng(n * 1000 + r)
    loc = rng.random((r, n)) < 0.3
    loc[0] = False                          # an object no node holds
    bw = rng.integers(0, 100_000, size=(n, n)).astype(np.int32)
    dest = rng.integers(0, n, size=r).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=r).astype(np.int32)
    infl = rng.integers(0, 200_000, size=n).astype(np.int32)
    got = pk.choose_sources_np(loc, bw, dest, sizes, infl, device="cpu")
    want = ref_pk.choose_sources_np(loc, bw, dest, sizes, infl)
    oracle = pk.choose_sources_oracle(loc, bw, dest, sizes, infl)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)
    assert got[0][0] == -1 and (got[0] >= 0).any()


@pytest.mark.parametrize("seed", range(6))
def test_plan_fanout_bit_exact(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 41))
    member = rng.random(n) < 0.7
    bw = rng.integers(0, 100_000, size=(n, n)).astype(np.int32)
    np.fill_diagonal(bw, 0)
    bw[rng.random((n, n)) < 0.1] = 0
    root = int(rng.integers(0, n))
    member[root] = True
    fanout = int(rng.integers(1, 5))
    infl = rng.integers(0, 200_000, size=n).astype(np.int32)
    got = bc.plan_fanout_np(member, bw, root, fanout, infl, device="cpu")
    want = ref_bc.plan_fanout_np(member, bw, root, fanout, infl)
    oracle = bc.plan_fanout_oracle(member, bw, root, fanout, infl)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


def test_call_sites_take_the_device_program(monkeypatch):
    """Above their thresholds the runtime's call sites run the port's
    device programs (here on the CPU), never the numpy oracle."""
    from ray_tpu_torch.broadcast import plan as bplan
    from ray_tpu_torch.common.config import Config
    Config.reset({"broadcast_device_batch_min": 2})
    calls = []
    monkeypatch.setattr(bc, "plan_fanout_oracle",
                        lambda *a, **k: calls.append("oracle"))
    bw = np.full((6, 6), 1000, np.int32)
    np.fill_diagonal(bw, 0)
    plan = bplan.build_plan([1, 2, 3, 4, 5], bw, 0, fanout=2, device="cpu")
    assert not calls and len(plan.parent) == 5

"""The port's autoscaler: demand packing on the device path vs the JAX one.

``ray_tpu_torch.ops.binpack_kernel.autoscale`` on CPU tensors (phase 1 on
``waterfill_scan_plain``, phase 2 on ``launch_loop_plain``) against the
JAX package's ``autoscale_np`` and the port's numpy oracle
``autoscaler.demand.get_nodes_to_launch``, bit for bit, on the seeded
problems of ``tests/test_autoscaler.py``; the launch loop alone against
the JAX ``_launch_loop``; then the runtime loop
(``Cluster.start_autoscaler``, ``StandardAutoscaler``) on a port
``Cluster`` with its placement programs on the CPU, as
``tests/test_autoscaler_loop.py`` drives the reference's.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import binpack_kernel as jax_bp
from ray_tpu_torch.autoscaler.demand import (get_nodes_to_launch,
                                             pack_one_node)
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import binpack_kernel as bp
from ray_tpu_torch.scheduling.oracle import ClusterState
from test_autoscaler import random_autoscale_problem
from test_torch_cuda import EDGE_DIVISORS, LAUNCH_LOOP_CASES, launch_loop_case


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _empty_state(n_res=1):
    z = np.zeros((1, n_res), dtype=np.int32)
    return ClusterState(z.copy(), z.copy(), np.zeros(1, dtype=bool))


@pytest.mark.parametrize("seed", range(12))
def test_autoscale_bit_exact_vs_jax_and_oracle(seed):
    rng = np.random.default_rng(seed + 100)
    p = random_autoscale_problem(rng)
    got = bp.autoscale_np(*p, device="cpu")
    want = jax_bp.autoscale_np(*p)
    for x, y in zip(got, want):
        assert np.array_equal(x, np.asarray(y)), seed
    st = ClusterState(p[0].copy(), p[1].copy(), p[2].copy())
    launches, fit, unmet = get_nodes_to_launch(st, *p[3:])
    for x, y in zip(got, (launches, fit, unmet, st.avail)):
        assert np.array_equal(x, y), seed


@pytest.mark.parametrize("seed", range(4))
def test_launch_loop_plain_equals_jax_launch_loop(seed):
    rng = np.random.default_rng(seed)
    k, g, r = 6, 12, 5
    caps = rng.integers(0, 3000, size=(k, r)).astype(np.int32)
    caps[rng.random(caps.shape) < 0.2] = 0
    quotas = rng.integers(0, 30, size=k).astype(np.int32)
    reqs = rng.integers(0, 500, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    rem = rng.integers(0, 2000, size=g).astype(np.int32)
    max_iters = g * k + g + k + 2
    j_launch, j_rem = jax_bp._launch_loop(
        jnp.asarray(caps), jnp.asarray(quotas), jnp.asarray(reqs),
        jnp.asarray(rem), max_iters)
    launches, unmet, iters = bp.launch_loop_plain(
        torch.tensor(caps), torch.tensor(quotas), torch.tensor(reqs),
        torch.tensor(rem), max_iters)
    assert np.array_equal(launches.numpy(), np.asarray(j_launch))
    assert np.array_equal(unmet.numpy(), np.asarray(j_rem))
    assert 1 <= int(iters) <= max_iters
    # the iteration bound binds: one iteration launches one type once
    one, _, n = bp.launch_loop_plain(
        torch.tensor(caps), torch.tensor(quotas), torch.tensor(reqs),
        torch.tensor(rem), 1)
    assert int(n) == 1 and int(one.sum()) >= 1


@pytest.mark.parametrize("case", LAUNCH_LOOP_CASES)
def test_launch_loop_plain_equals_jax_on_the_kernel_traps(case):
    # the cases the card tests hold the kernel to, held here between the
    # plain loop and the JAX _launch_loop (on-chip sizes)
    (caps, quotas, reqs, rem), max_iters = launch_loop_case(case, "on_chip")
    j_launch, j_rem = jax_bp._launch_loop(
        jnp.asarray(caps), jnp.asarray(quotas), jnp.asarray(reqs),
        jnp.asarray(rem), max_iters)
    launches, unmet, iters = bp.launch_loop_plain(
        torch.tensor(caps), torch.tensor(quotas), torch.tensor(reqs),
        torch.tensor(rem), max_iters)
    assert np.array_equal(launches.numpy(), np.asarray(j_launch)), case
    assert np.array_equal(unmet.numpy(), np.asarray(j_rem)), case
    assert 1 <= int(iters) <= max_iters


# A model of csrc/binpack.cu's division (magic() and fdiv()): floor(a / d)
# for int32 a and d in 1..2**31-1 as x = a ^ (a >> 31), q = (x * m) >> s
# with s = 31 + ceil(log2 d), m = ceil(2**s / d), then q ^ (a >> 31).
def _magic(d):
    d = d.astype(np.uint64)
    s = 31 + np.array([int(v - 1).bit_length() for v in d], np.uint64)
    m = ((np.uint64(1) << s) + d - np.uint64(1)) // d
    return m, s


def _fdiv(a, m, s):
    neg = (a.astype(np.int32) >> 31).astype(np.uint32)
    x = (a.astype(np.int32).view(np.uint32) ^ neg).astype(np.uint64)
    q = ((x * m) >> s).astype(np.uint32)
    return (q ^ neg).view(np.int32)


@pytest.mark.parametrize("divisors", ["edges", "random"])
def test_kernel_division_is_floor_division(divisors):
    rng = np.random.default_rng(7)
    int_min, int_max = -(1 << 31), (1 << 31) - 1
    if divisors == "edges":
        d = np.array(sorted({*EDGE_DIVISORS, int_max, int_max - 1,
                             *[(1 << j) + e for j in range(31)
                               for e in (-1, 0, 1)]} - {0}), np.int64)
        d = d[(d >= 1) & (d <= int_max)]
    else:
        d = rng.integers(1, int_max, size=400, endpoint=True)
    m, s = _magic(d)
    assert (m < (1 << 32)).all() and (s <= 62).all()
    for di, mi, si in zip(d, m, s):
        a = np.concatenate([
            [int_min, int_min + 1, -1, 0, 1, int_max, int_max - 1],
            [q * di + e for q in (-3, -2, -1, 1, 2, 3) for e in (-1, 0, 1)],
            [int_max - int_max % di, int_min + (-int_min) % di],
            rng.integers(int_min, int_max, size=200, endpoint=True)])
        a = a[(a >= int_min) & (a <= int_max)]
        got = _fdiv(a, mi, si)
        assert np.array_equal(got.astype(np.int64), a // di), int(di)


def test_million_demands_cost_a_few_iterations():
    args = (np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
            np.zeros(1, bool), np.array([[100]], np.int32),
            np.array([1_000_000], np.int32), np.array([[12800]], np.int32),
            np.array([10_000], np.int32))
    launches, _, unmet, _ = bp.autoscale_np(*args, device="cpu")
    assert launches[0] == int(np.ceil(1_000_000 / 128))
    assert unmet.sum() == 0
    for x, y in zip((launches, unmet), (jax_bp.autoscale_np(*args)[0],
                                        jax_bp.autoscale_np(*args)[2])):
        assert np.array_equal(x, np.asarray(y))
    st = _empty_state()
    o_launch, _, o_unmet = get_nodes_to_launch(st, *args[3:])
    assert np.array_equal(launches, o_launch)
    assert np.array_equal(unmet, o_unmet)


def test_oracle_packs_first_fit_and_prefers_utilization():
    packed, used = pack_one_node(
        np.array([800, 400], dtype=np.int32),
        np.array([[200, 100], [100, 0]], dtype=np.int32),
        np.array([2, 10]))
    assert packed.tolist() == [2, 4] and used.tolist() == [800, 200]
    launches, _, unmet = get_nodes_to_launch(
        _empty_state(), np.array([[300]], dtype=np.int32), np.array([4]),
        type_caps=np.array([[400], [1200]], dtype=np.int32),
        type_quotas=np.array([10, 10]))
    assert launches.tolist() == [0, 1] and unmet.sum() == 0


def test_width_contract_and_unported_sharded_twin():
    """The width contract on both entries; the row-sharded twin (ported
    since, on CPU ranks here) equals the single-device call."""
    p = random_autoscale_problem(np.random.default_rng(0))
    caps = p[5].copy()
    caps[0, 0] = (1 << 17) + 1
    with pytest.raises(ValueError, match="MAX_TOTAL_CU"):
        bp.autoscale_np(*p[:5], caps, p[6], device="cpu")
    with pytest.raises(ValueError, match="MAX_TOTAL_CU"):
        bp.autoscale_sharded_np(*p[:5], caps, p[6], devices=["cpu"] * 2)
    for a, b in zip(bp.autoscale_np(*p, device="cpu"),
                    bp.autoscale_sharded_np(*p, n_shards=2,
                                            devices=["cpu"] * 2)):
        np.testing.assert_array_equal(a, b)


def test_cuda_tensors_never_take_the_plain_loop():
    caps = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    before = bp.binpack_launch_loop.launches
    with pytest.raises(ValueError, match="unsupported device"):
        bp.binpack_launch_loop(caps, caps[0], caps, caps[0], 4)
    assert bp.binpack_launch_loop.launches == before


# -- the runtime loop on a port Cluster --------------------------------------

def _wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


@pytest.fixture
def small_cluster():
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    # every autoscaler round on the device route (its plain versions)
    PortConfig.reset({"scheduler_device": "cpu",
                      "autoscaler_device_batch_min": 1})
    c = Cluster()
    c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
    rt.init(cluster=c)
    yield c
    rt.shutdown()
    c.stop()


def _types():
    from ray_tpu_torch.autoscaler import NodeTypeSpec
    return [NodeTypeSpec("cpu4", {"CPU": 4, "memory": 4}, max_workers=4),
            NodeTypeSpec("accel", {"CPU": 2, "accel": 1, "memory": 2},
                         max_workers=8)]


class TestRuntimeLoop:
    def test_infeasible_backlog_launches_and_drains(self, small_cluster):
        import ray_tpu_torch as rt
        from ray_tpu_torch.autoscaler import NODE_TYPE_LABEL
        c = small_cluster
        asc = c.start_autoscaler(_types(), interval_ms=60_000)

        @rt.remote(resources={"CPU": 4})
        def wide(i):
            return i * 7

        refs = [wide.remote(i) for i in range(4)]
        assert rt.get(refs, timeout=60) == [i * 7 for i in range(4)]
        assert asc.num_launched >= 1
        assert asc.stats()["device_rounds"] >= 1
        assert asc.stats()["oracle_rounds"] == 0
        types = [c.crm.labels_of(row).get(NODE_TYPE_LABEL)
                 for row in c.raylets]
        assert "cpu4" in types

    def test_round_launches_what_the_oracle_says(self, small_cluster):
        """One synchronous round over an explicit request: the device
        route's launches by type equal the oracle's on the same
        snapshot."""
        from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
        from ray_tpu_torch.common.resources import ResourceRequest
        c = small_cluster
        asc = StandardAutoscaler(c, _types())
        bundles = [{"CPU": 4}] * 3 + [{"accel": 1, "CPU": 1}] * 2
        reqs = [ResourceRequest(b) for b in bundles]
        for r in reqs:
            c.crm.intern_request(r)
        for t in _types():
            c.crm.intern_request(ResourceRequest(t.resources))
        snap = c.crm.snapshot()
        width = snap.totals.shape[1]
        classes = {}
        for r in reqs:
            classes.setdefault(r.key(), [r, 0])[1] += 1
        want, _, _ = get_nodes_to_launch(
            snap, np.stack([v[0].dense(c.crm.resource_index, width)
                            for v in classes.values()]),
            np.array([v[1] for v in classes.values()]),
            np.stack([ResourceRequest(t.resources).dense(
                c.crm.resource_index, width) for t in _types()]),
            np.array([t.max_workers for t in _types()]))
        asc.request_resources(bundles)
        out = asc.update()
        expect = {t.name: int(n) for t, n in zip(_types(), want) if n}
        assert out["launches"] == expect
        assert asc.device_rounds == 1 and asc.oracle_rounds == 0
        asc.shutdown()

    def test_quota_bounds_launches(self, small_cluster):
        import ray_tpu_torch as rt
        from ray_tpu_torch.autoscaler import NodeTypeSpec
        asc = small_cluster.start_autoscaler(
            [NodeTypeSpec("cpu4", {"CPU": 4, "memory": 4}, max_workers=2)],
            interval_ms=60_000)

        @rt.remote(resources={"CPU": 4})
        def wide(i):
            time.sleep(0.2)
            return i

        refs = [wide.remote(i) for i in range(6)]
        assert sorted(rt.get(refs, timeout=60)) == list(range(6))
        assert asc.num_launched <= 2

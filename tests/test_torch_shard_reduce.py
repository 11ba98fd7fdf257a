"""The port's row-sharded scheduling plane vs the JAX package's.

The reference runs its sharded paths on the conftest's 8 virtual CPU
devices; the port runs them on CPU ranks (``devices=["cpu"] * S``), the
same partition, staging, two-level reduces and overflow to the owning
shard, with the collectives as a stack and a reduce.  Everything here is
under the int32 contract, so every comparison is bit for bit:

- shard resolution, the ("dcn", "ici") grid and the plane cache;
- ``ShardedDeltaScheduler`` at 2/4/8 ranks, flat and two-level, over
  tests/test_oracle.py's randomized churn (a reference CRM carried into
  the port and mutated in lockstep): counts, budgets, key rows and
  argmins equal to the reference's ``ShardedDeltaScheduler``, to the
  port's single-device engine and to the CPU oracle, every beat;
- the four ``*_sharded_np`` wrappers at 2 and 8 shards against the
  reference's (tests/test_sharded_sched.py's workloads);
- the raylet's ``_schedule_sharded`` against the reference raylet's."""

import numpy as np
import pytest

import jax
import ray_tpu.ops.shard_reduce as ref_sr
from ray_tpu.common.ids import NodeID
from ray_tpu.common.resources import NodeResources
from ray_tpu.scheduling import ShardedDeltaScheduler as RefSharded
from ray_tpu.scheduling import schedule_grouped_oracle
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.common.ids import NodeID as PortNodeID
from ray_tpu_torch.common.resources import NodeResources as PortResources
from ray_tpu_torch.ops import shard_reduce as sr
from ray_tpu_torch.scheduling import DeltaScheduler as PortDelta
from ray_tpu_torch.scheduling import ShardedDeltaScheduler as PortSharded
from ray_tpu_torch.scheduling import make_delta_scheduler
from test_torch_delta import Twin, _specs

# the reference's top-k draws follow JAX's partitionable threefry
jax.config.update("jax_threefry_partitionable", True)


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _cpu(n):
    return ["cpu"] * n


# -- resolution, grid, cache ---------------------------------------------------

def test_resolve_shards_equals_the_reference():
    for requested in range(-1, 18):
        for n_devices in range(1, 18):
            assert sr.resolve_shards(requested, n_devices) == \
                ref_sr.resolve_shards(requested, n_devices)
    from ray_tpu_torch.scheduling.sharded_delta import resolve_shards
    assert resolve_shards is sr.resolve_shards          # one copy


@pytest.mark.parametrize("n,mode", [(8, "flat"), (8, "two_level"),
                                    (1, "two_level"), (4, "auto"),
                                    (2, "flat"), (2, "two_level"),
                                    (6, "two_level")])
def test_build_mesh_shapes_equal_the_reference(n, mode):
    mesh = sr.build_mesh(n, mode, devices=_cpu(8))
    assert mesh.devices.shape == ref_sr.build_mesh(n, mode).devices.shape
    assert mesh.axis_names == ("dcn", "ici")
    assert len(mesh.ranks()) == n


def test_plane_cache_is_per_topology():
    assert sr.plane_for(4, "flat", _cpu(8)) is sr.plane_for(4, "flat",
                                                           _cpu(8))
    assert sr.plane_for(4, "flat", _cpu(8)) is not \
        sr.plane_for(4, "two_level", _cpu(8))
    assert sr.plane_for(4, "flat", _cpu(8)).n_shards == 4


def test_ranks_are_one_device_or_distinct_cards():
    with pytest.raises(ValueError, match="distinct CUDA cards"):
        sr.plane_for(2, "flat", ["cpu", "meta"])
    assert sr.local_ranks("cpu") == [sr.torch.device("cpu")]


def test_named_card_is_the_first_rank_and_the_engine_device(monkeypatch):
    """On a host with two cards (CUDA patched in; nothing is allocated),
    a named card leads the ranks and carries the single-device engine;
    an unnamed one keeps the default device, as the factory did before
    it could shard."""
    torch = sr.torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert sr.local_ranks() == cuda
    assert sr.local_ranks("cuda:1") == cuda[::-1]
    tw = Twin(7)
    one = make_delta_scheduler(tw.port, n_shards=1, device="cuda:1")
    assert type(one) is PortDelta and one.device == cuda[1]
    assert make_delta_scheduler(tw.port, n_shards=1).device == \
        torch.device("cuda")
    both = make_delta_scheduler(tw.port, n_shards=0, device="cuda:1")
    assert isinstance(both, PortSharded) and both.device == cuda[1]
    assert both._plane.ranks == cuda[::-1]


# -- the sharded heartbeat -------------------------------------------------------

def _grow(tw, k):
    """Add ``k`` nodes to both CRMs (structural growth)."""
    for _ in range(k):
        cpu = int(tw.rng.integers(2, 32))
        tw.ref.add_node(NodeID.from_random(), NodeResources({"CPU": cpu}))
        tw.port.add_node(PortNodeID.from_random(),
                         PortResources({"CPU": cpu}))
    tw.n += k


def _assert_same_beat(got, ref_eng, port_eng, want, vecs):
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_eng.last_budgets(),
                                  ref_eng.last_budgets())
    for v in vecs:
        np.testing.assert_array_equal(port_eng.keys_row_host(v),
                                      ref_eng.keys_row_host(v))
        assert port_eng.peek_argmin(v) == ref_eng.peek_argmin(v)


@pytest.mark.parametrize("mode", ["flat", "two_level"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_beat_equals_reference_single_device_and_oracle(shards,
                                                                mode):
    tw = Twin(shards)
    vecs = tw.requests(_specs(tw.rng, 6))
    counts = tw.rng.integers(1, 12, size=6).astype(np.int32)
    eng = PortSharded(tw.port, shards, mode, devices=_cpu(8))
    ref = RefSharded(tw.ref, shards, mode)
    single = PortDelta(tw.port, device="cpu")
    assert eng.stats["shards"] == shards
    assert eng._plane.mesh.devices.shape == ref._plane.mesh.devices.shape
    for _ in range(6):
        tw.mutate()
        got = eng.beat(vecs, counts)
        want = ref.beat(vecs, counts)
        _assert_same_beat(got, ref, eng, want, vecs)
        np.testing.assert_array_equal(got, single.beat(vecs, counts))
        np.testing.assert_array_equal(
            got, schedule_grouped_oracle(tw.ref.snapshot(), vecs, counts))
        np.testing.assert_array_equal(eng.last_budgets(),
                                      single.last_budgets())
    assert eng.stats == ref.stats
    assert eng.stats["delta_beats"] > 0
    assert eng.readbacks >= eng.stats["beats"]    # one a beat, + probes


@pytest.mark.parametrize("shards", [4])
def test_structural_growth_rebalances_shards(shards):
    """Capacity growth moves the node axis under the shards: the next
    beat re-pads, re-shards and rescores, bit-exact before and after."""
    tw = Twin(17, capacity=24)
    vecs = tw.requests(_specs(tw.rng, 6))
    counts = tw.rng.integers(1, 12, size=6).astype(np.int32)
    eng = PortSharded(tw.port, shards, devices=_cpu(8))
    ref = RefSharded(tw.ref, shards)
    for grow in (False, True, False, True, False):
        if grow:
            _grow(tw, 40)
        tw.mutate()
        got = eng.beat(vecs, counts)
        np.testing.assert_array_equal(got, ref.beat(vecs, counts))
        np.testing.assert_array_equal(
            got, schedule_grouped_oracle(tw.ref.snapshot(), vecs, counts))
    assert eng.stats["full_rescores"] >= 2
    assert eng.stats == ref.stats


def test_sharded_overrides_and_softmask():
    """Planned-load overrides and the suspect soft mask land on the right
    shards (global row -> the owning rank's local bucket)."""
    tw = Twin(29)
    vecs = tw.requests(_specs(tw.rng, 6))
    counts = tw.rng.integers(1, 12, size=6).astype(np.int32)
    eng = PortSharded(tw.port, 4, devices=_cpu(4))
    ref = RefSharded(tw.ref, 4)
    single = PortDelta(tw.port, device="cpu")
    for e in (eng, ref, single):
        e.beat(vecs, counts)
    n_rows = tw.ref.arrays()[0].shape[0]
    over = {row: tw.ref.arrays()[1][row] - np.int32(150)
            for row in (0, 7, 15, 23)}
    sus = np.ones(n_rows, bool)
    sus[[1, 9]] = False
    for ra in (False, True):
        kw = dict(overrides=over, extra_mask=sus, require_available=ra)
        got = eng.beat(vecs, counts, **kw)
        np.testing.assert_array_equal(got, ref.beat(vecs, counts, **kw))
        np.testing.assert_array_equal(got, single.beat(vecs, counts, **kw))
        np.testing.assert_array_equal(eng.last_budgets(),
                                      ref.last_budgets())


def test_shard_count_one_degenerate():
    tw = Twin(19)
    vecs = tw.requests(_specs(tw.rng, 6))
    counts = tw.rng.integers(1, 12, size=6).astype(np.int32)
    eng = PortSharded(tw.port, 1, devices=_cpu(8))
    assert eng.stats["shards"] == 1
    for _ in range(3):
        tw.mutate()
        np.testing.assert_array_equal(
            eng.beat(vecs, counts),
            schedule_grouped_oracle(tw.ref.snapshot(), vecs, counts))


def test_factory_resolves_knobs():
    tw = Twin(23)
    assert type(make_delta_scheduler(tw.port, devices=_cpu(8))) is PortDelta
    auto = make_delta_scheduler(tw.port, n_shards=0, devices=_cpu(8))
    assert isinstance(auto, PortSharded) and auto.stats["shards"] == 8
    assert make_delta_scheduler(tw.port, n_shards=5,
                                devices=_cpu(8)).stats["shards"] == 4
    PortConfig.reset({"scheduler_shards": 2,
                      "scheduler_shard_reduce": "two_level"})
    eng = make_delta_scheduler(tw.port, devices=_cpu(8))
    assert eng.stats["shards"] == 2
    assert eng._plane.mesh.devices.shape == (2, 1)


# -- the sharded wrappers ----------------------------------------------------------

def _workload(seed=0, n=77, r=4, g=6):
    """tests/test_sharded_sched.py's workload: the node axis is NOT a
    shard multiple, so the padding path always runs."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(4, 64, size=(n, r)).astype(np.int32)
    avail = np.minimum(totals,
                       rng.integers(0, 64, size=(n, r))).astype(np.int32)
    mask = rng.random(n) > 0.1
    reqs = rng.integers(0, 4, size=(g, r)).astype(np.int32)
    counts = rng.integers(1, 30, size=g).astype(np.int32)
    gmask = rng.random((g, n)) > 0.05
    return totals, avail, mask, reqs, counts, gmask, rng


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["auto", "two_level"])
@pytest.mark.parametrize("shards", [2, 8])
def test_hybrid_wrapper_equals_the_reference(shards, mode):
    from ray_tpu.ops.hybrid_kernel import schedule_grouped_sharded_np as ref
    from ray_tpu_torch.ops.hybrid_kernel import (schedule_grouped_np,
                                                 schedule_grouped_sharded_np)
    totals, avail, mask, reqs, counts, gmask, _ = _workload()
    got = schedule_grouped_sharded_np(totals, avail, mask, reqs, counts,
                                      gmask, n_shards=shards,
                                      reduce_mode=mode, devices=_cpu(8))
    _same(got, ref(totals, avail, mask, reqs, counts, gmask,
                   n_shards=shards, reduce_mode=mode))
    _same(got, schedule_grouped_np(totals, avail, mask, reqs, counts, gmask,
                                   device="cpu"))


def test_one_rank_plane_is_the_single_device_call(monkeypatch):
    """A plane of one rank runs ``schedule_grouped_np`` on that rank (on a
    card: ``waterfill_scan``), as the reference's jit over a one-device
    mesh runs the single-device program; the result is unchanged."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    totals, avail, mask, reqs, counts, gmask, _ = _workload()
    want = hk.schedule_grouped_np(totals, avail, mask, reqs, counts, gmask,
                                  device="cpu")
    calls = []
    plain = hk.schedule_grouped_np
    monkeypatch.setattr(hk, "schedule_grouped_np",
                        lambda *a, **kw: calls.append(kw["device"])
                        or plain(*a, **kw))
    _same(hk.schedule_grouped_sharded_np(totals, avail, mask, reqs, counts,
                                         gmask, devices=_cpu(1)), want)
    assert calls == [sr.torch.device("cpu")]


@pytest.mark.parametrize("shards", [2, 8])
def test_localized_and_topk_wrappers_equal_the_reference(shards):
    import ray_tpu.ops.locality_kernel as ref
    import ray_tpu_torch.ops.locality_kernel as port
    totals, avail, mask, reqs, counts, gmask, rng = _workload(1)
    pref = rng.integers(-1, totals.shape[0],
                        size=reqs.shape[0]).astype(np.int32)
    em = rng.random(totals.shape[0]) > 0.1
    got = port.schedule_grouped_localized_sharded_np(
        totals, avail, mask, reqs, counts, pref, gmask, extra_mask=em,
        n_shards=shards, devices=_cpu(8))
    _same(got, ref.schedule_grouped_localized_sharded_np(
        totals, avail, mask, reqs, counts, pref, gmask, extra_mask=em,
        n_shards=shards))
    got = port.schedule_grouped_topk_sharded_np(
        totals, avail, mask, reqs, counts, 7, 3, gmask, k_abs=2, k_frac=0.1,
        extra_mask=em, n_shards=shards, devices=_cpu(8))
    _same(got, ref.schedule_grouped_topk_sharded_np(
        totals, avail, mask, reqs, counts, 7, 3, gmask, k_abs=2, k_frac=0.1,
        extra_mask=em, n_shards=shards))


@pytest.mark.parametrize("shards", [2, 8])
def test_autoscale_wrapper_equals_the_reference(shards):
    from ray_tpu.ops.binpack_kernel import autoscale_sharded_np as ref
    from ray_tpu_torch.ops.binpack_kernel import autoscale_sharded_np
    totals, avail, mask, reqs, counts, _gmask, rng = _workload(2)
    caps = rng.integers(8, 64, size=(3, totals.shape[1])).astype(np.int32)
    quotas = np.array([5, 5, 5], np.int32)
    em = rng.random(totals.shape[0]) > 0.2
    for extra in (None, em):
        _same(autoscale_sharded_np(totals, avail, mask, reqs, counts, caps,
                                   quotas, extra, n_shards=shards,
                                   devices=_cpu(8)),
              ref(totals, avail, mask, reqs, counts, caps, quotas, extra,
                  n_shards=shards))


# -- the raylet's sharded placement call ---------------------------------------------

def test_raylet_schedule_sharded_equals_the_reference_raylet(monkeypatch):
    """``scheduler_sharded_state``: the same seeded batches through each
    package's head raylet give the same rows, the port's rows sharded
    over 8 CPU ranks (its resolver patched, as a host with 8 cards would
    give them) and the reference's over its 8 devices."""
    import ray_tpu
    import ray_tpu.cluster_utils as ref_cluster
    import ray_tpu_torch
    import ray_tpu_torch.cluster_utils as port_cluster
    from ray_tpu.common.config import Config as RefConfig
    from test_torch_runtime import CPU_CONFIG, _raylet_rows
    from test_torch_runtime import _specs as task_specs

    monkeypatch.setattr(sr, "local_ranks", lambda device=None: _cpu(8))
    rng = np.random.default_rng(5)
    node_res = [{"CPU": int(rng.integers(2, 16)),
                 "memory": int(rng.integers(2, 16))} for _ in range(13)]

    def batches_of(pkg):
        brng = np.random.default_rng(6)
        return [(task_specs(pkg, brng, 300, 5), [None] * 300,
                 [False] * 300) for _ in range(2)]

    sharded = {"scheduler_sharded_state": True}
    planes = []
    scan = sr.ShardPlane.schedule_grouped_np
    monkeypatch.setattr(sr.ShardPlane, "schedule_grouped_np",
                        lambda pl, *a: planes.append(pl.n_shards)
                        or scan(pl, *a))
    PortConfig.reset(dict(CPU_CONFIG, **sharded))
    try:
        got, head = _raylet_rows(ray_tpu_torch, port_cluster, node_res,
                                 batches_of)
    finally:
        PortConfig.reset()
    assert planes == [8, 8]
    assert head.delta_rounds == 0 and head.device_rounds == 2
    RefConfig.reset({"scheduler_device_batch_min": 1, **sharded})
    try:
        want, _ = _raylet_rows(ray_tpu, ref_cluster, node_res, batches_of)
    finally:
        RefConfig.reset()
    assert got == want
    assert len(set(got[0])) > 2          # the rounds spread

"""The port's DeltaScheduler vs the JAX package's, beat for beat.

A reference ``ClusterResourceManager`` is carried into the port with
``convert.crm_from_arrays``; both CRMs then take the same seeded churn
(the mutation mix of tests/test_oracle.py) and both engines beat on the
same classes.  Per beat the port (``device="cpu"``, the plain PyTorch
path) must match the reference bit for bit: counts, carried key rows,
lease budgets, stats — with overrides, the soft mask, a width-growth
resync, and class retire/reuse."""

import numpy as np
import pytest

from ray_tpu.common.ids import NodeID
from ray_tpu.common.resources import NodeResources
from ray_tpu.common.resources import ResourceRequest as RefRequest
from ray_tpu.scheduling import ClusterResourceManager as RefCRM
from ray_tpu.scheduling import DeltaScheduler as RefDelta
from ray_tpu.scheduling import compute_keys_batch, schedule_grouped_oracle
from ray_tpu.scheduling.contract import compute_budgets, threshold_fp
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.common.resources import ResourceRequest as PortRequest
from ray_tpu_torch.convert import crm_from_arrays
from ray_tpu_torch.scheduling import DeltaScheduler as PortDelta
from ray_tpu_torch.scheduling import make_delta_scheduler


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


class Twin:
    """A reference CRM and its port copy, mutated in lockstep."""

    def __init__(self, seed, n_nodes=24, capacity=32, slots=16):
        self.rng = np.random.default_rng(seed)
        self.ref = RefCRM(num_resource_slots=slots, capacity=capacity)
        for _ in range(n_nodes):
            self.ref.add_node(NodeID.from_random(), NodeResources(
                {"CPU": int(self.rng.integers(2, 32)),
                 "memory": int(self.rng.integers(1, 64))}))
        t, a, m = self.ref.arrays()
        self.port = crm_from_arrays(t, a, m,
                                    self.ref.resource_index.names())
        self.n = n_nodes
        self.debts: list[int] = []

    def requests(self, specs):
        ref = [RefRequest(s) for s in specs]
        vecs = np.stack([self.ref.intern_request(r) for r in ref])
        pvecs = np.stack([self.port.intern_request(PortRequest(s))
                          for s in specs])
        np.testing.assert_array_equal(vecs, pvecs)
        return vecs

    def both(self, op, row, *args):
        getattr(self.ref, op)(row, *args)
        getattr(self.port, op)(row, *args)

    def mutate(self):
        """test_oracle._mutate's mix, applied to both CRMs."""
        rng = self.rng
        for _ in range(1 + int(rng.integers(0, 5))):
            op = int(rng.integers(0, 5))
            row = int(rng.integers(0, self.n))
            if op == 0:
                self.ref.force_subtract(row, RefRequest({"CPU": 1}))
                self.port.force_subtract(row, PortRequest({"CPU": 1}))
                self.debts.append(row)
            elif op == 1 and self.debts:
                r = self.debts.pop(int(rng.integers(0, len(self.debts))))
                self.ref.add_back(r, RefRequest({"CPU": 1}))
                self.port.add_back(r, PortRequest({"CPU": 1}))
            elif op == 2:
                flag = bool(rng.integers(0, 2))
                self.ref.set_draining(self.ref.id_of(row), flag)
                self.port.set_draining(self.port.id_of(row), flag)
            elif op == 3:
                self.both("set_suspect", row, bool(rng.integers(0, 2)))
            else:
                cpu = {"CPU": int(rng.integers(0, 3200))}
                self.ref.update_node_available(self.ref.id_of(row), cpu)
                self.port.update_node_available(self.port.id_of(row), cpu)

    def assert_same_state(self):
        for a, b in zip(self.ref.arrays(), self.port.arrays()):
            np.testing.assert_array_equal(a, b)


def _specs(rng, k):
    return [{"CPU": int(rng.integers(1, 4)),
             "memory": float(rng.integers(0, 6))} for _ in range(k)]


def _assert_beat_equal(ref_eng, port_eng, vecs, got, want):
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_eng.last_budgets(),
                                  ref_eng.last_budgets())
    assert port_eng.budget_seq == ref_eng.budget_seq
    assert port_eng.stats == ref_eng.stats
    assert port_eng.hit_rate() == ref_eng.hit_rate()
    for v in vecs:
        np.testing.assert_array_equal(port_eng.keys_row_host(v),
                                      ref_eng.keys_row_host(v))
        assert port_eng.peek_argmin(v) == ref_eng.peek_argmin(v)
        np.testing.assert_array_equal(port_eng.budget_row_host(v),
                                      ref_eng.budget_row_host(v))


def test_crm_from_arrays_carries_rows_columns_and_masks():
    tw = Twin(0)
    tw.ref.remove_node(tw.ref.id_of(5))
    t, a, m = tw.ref.arrays()
    port = crm_from_arrays(t, a, m, tw.ref.resource_index.names())
    for x, y in zip(tw.ref.arrays(), port.arrays()):
        np.testing.assert_array_equal(x, y)
    assert port.resource_index.names() == tw.ref.resource_index.names()
    assert port.num_nodes() == tw.ref.num_nodes()
    with pytest.raises(ValueError, match="no resource name"):
        crm_from_arrays(t, a + 1, m, ["CPU"])


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_churned_beats_match_reference(seed):
    tw = Twin(seed)
    vecs = tw.requests(_specs(tw.rng, 6))
    counts = tw.rng.integers(1, 12, size=6).astype(np.int32)
    ref_eng = RefDelta(tw.ref)
    port_eng = PortDelta(tw.port, device="cpu")
    thr = threshold_fp(None)
    for _ in range(10):
        tw.mutate()
        tw.assert_same_state()
        got = port_eng.beat(vecs, counts)
        want = ref_eng.beat(vecs, counts)
        _assert_beat_equal(ref_eng, port_eng, vecs, got, want)
        st = tw.ref.snapshot()
        np.testing.assert_array_equal(
            got, schedule_grouped_oracle(st.copy(), vecs, counts))
        np.testing.assert_array_equal(
            np.stack([port_eng.keys_row_host(v) for v in vecs]),
            compute_keys_batch(st.totals, st.avail, vecs, thr, st.node_mask))
    assert port_eng.stats["delta_beats"] > 0


@pytest.mark.parametrize("seed", [3, 4])
def test_overrides_and_soft_mask_match_reference(seed):
    tw = Twin(seed)
    vecs = tw.requests(_specs(tw.rng, 5))
    counts = tw.rng.integers(1, 30, size=5).astype(np.int32)
    ref_eng = RefDelta(tw.ref)
    port_eng = PortDelta(tw.port, device="cpu")
    for i in range(6):
        tw.mutate()
        rows = tw.rng.choice(tw.n, size=3, replace=False)
        overrides = {int(r): tw.rng.integers(-400, 2000, size=3).astype(
            np.int32) for r in rows}
        overrides[int(rows[0])][0] = -5000          # planned load past zero
        soft = tw.rng.random(tw.ref.arrays()[0].shape[0]) > 0.3
        kw = dict(overrides=overrides if i % 2 == 0 else None,
                  extra_mask=soft if i % 3 else None,
                  require_available=bool(i % 2))
        got = port_eng.beat(vecs, counts, **kw)
        want = ref_eng.beat(vecs, counts, **kw)
        _assert_beat_equal(ref_eng, port_eng, vecs, got, want)


def test_budgets_match_compute_budgets_on_post_fill_state():
    tw = Twin(5)
    vecs = tw.requests(_specs(tw.rng, 4))
    counts = tw.rng.integers(1, 40, size=4).astype(np.int32)
    eng = PortDelta(tw.port, device="cpu")
    for _ in range(3):
        tw.mutate()
        eng.beat(vecs, counts)
        st = tw.port.snapshot()
        post = st.copy()
        schedule_grouped_oracle(post, vecs, counts)     # mutates post.avail
        want = compute_budgets(st.totals, post.avail, vecs, st.node_mask)
        np.testing.assert_array_equal(
            np.stack([eng.budget_row_host(v) for v in vecs]), want)


def test_width_growth_resync_matches_reference():
    tw = Twin(6, slots=6)
    vecs = tw.requests(_specs(tw.rng, 3))
    counts = np.array([5, 7, 9], np.int32)
    ref_eng = RefDelta(tw.ref)
    port_eng = PortDelta(tw.port, device="cpu")
    _assert_beat_equal(ref_eng, port_eng, vecs, port_eng.beat(vecs, counts),
                       ref_eng.beat(vecs, counts))
    # new custom resources grow the column axis under both CRMs
    spec = {"CPU": 1, "accel_x": 1, "accel_y": 2}
    tw.ref.add_node(NodeID.from_random(), NodeResources(
        {"CPU": 8, "accel_x": 4, "accel_y": 4}))
    tw.port.add_node(NodeID.from_random(), NodeResources(
        {"CPU": 8, "accel_x": 4, "accel_y": 4}))
    tw.n += 1
    wide = tw.requests([spec])
    assert wide.shape[1] > vecs.shape[1]
    tw.assert_same_state()
    for batch, cts in ((vecs, counts),
                       (np.concatenate([np.pad(vecs, ((0, 0), (
                           0, wide.shape[1] - vecs.shape[1]))), wide]),
                        np.array([5, 7, 9, 3], np.int32))):
        got = port_eng.beat(batch, cts)
        want = ref_eng.beat(batch, cts)
        np.testing.assert_array_equal(got, want)
        assert port_eng.stats == ref_eng.stats
        np.testing.assert_array_equal(port_eng.last_budgets(),
                                      ref_eng.last_budgets())


def test_retire_and_reuse_class_slots_match_reference():
    tw = Twin(8)
    vecs = tw.requests(_specs(tw.rng, 5))
    counts = tw.rng.integers(1, 12, size=5).astype(np.int32)
    ref_eng = RefDelta(tw.ref)
    port_eng = PortDelta(tw.port, device="cpu")
    port_eng.beat(vecs, counts)
    ref_eng.beat(vecs, counts)
    assert port_eng.retire_class(vecs[1]) and ref_eng.retire_class(vecs[1])
    assert not port_eng.retire_class(vecs[1])
    fresh = tw.requests([{"CPU": 3, "memory": 7}])
    batch = np.concatenate([vecs[[0, 2, 3, 4]], fresh])
    for _ in range(3):
        tw.mutate()
        got = port_eng.beat(batch, counts)
        want = ref_eng.beat(batch, counts)
        _assert_beat_equal(ref_eng, port_eng, batch, got, want)
    assert port_eng.class_vectors().keys() == ref_eng.class_vectors().keys()


def test_dirty_fraction_fallback_knob_matches_reference():
    from ray_tpu.common.config import Config as RefConfig
    RefConfig.reset({"scheduler_delta_max_dirty_fraction": 0.0})
    PortConfig.reset({"scheduler_delta_max_dirty_fraction": 0.0})
    tw = Twin(9)
    vecs = tw.requests(_specs(tw.rng, 4))
    counts = tw.rng.integers(1, 12, size=4).astype(np.int32)
    ref_eng = RefDelta(tw.ref)
    port_eng = PortDelta(tw.port, device="cpu")
    for _ in range(4):
        tw.mutate()
        got = port_eng.beat(vecs, counts)
        want = ref_eng.beat(vecs, counts)
        _assert_beat_equal(ref_eng, port_eng, vecs, got, want)
    assert port_eng.stats["delta_beats"] == 0


def test_make_delta_scheduler_resolves_to_delta_scheduler():
    tw = Twin(10)
    eng = make_delta_scheduler(tw.port, device="cpu")
    assert type(eng) is PortDelta
    assert eng.device.type == "cpu"
    eng = make_delta_scheduler(tw.port, n_shards=4, device="cpu")
    assert type(eng) is PortDelta       # one device: nothing to shard
    vecs = tw.requests(_specs(tw.rng, 3))
    counts = np.array([4, 4, 4], np.int32)
    np.testing.assert_array_equal(
        eng.beat(vecs, counts), RefDelta(tw.ref).beat(vecs, counts))
    assert eng.readbacks == 1           # one device->host copy per beat

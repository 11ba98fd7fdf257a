"""Bundle (placement-group) scheduling: oracle semantics + device parity.

Scenario sources: upstream's bundle policy tests construct synthetic node
resource states and assert chosen nodes / strict-constraint failures
(SURVEY.md §4 C++ unit tier — scenarios re-derived, not copied)."""

import numpy as np
import pytest

from ray_tpu_torch.ops.bundle_kernel import schedule_bundle_groups_np
from ray_tpu_torch.scheduling.bundles import PlacementStrategy, schedule_bundles
from ray_tpu_torch.scheduling.oracle import ClusterState
from torch_ref_fixtures import (  # noqa: F401
    _port_device_module, _port_state, device)

# Port copy of tests/test_bundles.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable);
# - the kernel calls take ``device`` (the fixture of
#   tests/torch_ref_fixtures.py): every case that reaches the bundle
#   kernel runs once with "cpu" (the plain PyTorch version) and once
#   with "cuda" under the ``cuda`` marker, which skips without a GPU.


S = PlacementStrategy


def mk_state(avail_rows, totals_rows=None):
    avail = np.asarray(avail_rows, dtype=np.int32)
    totals = avail.copy() if totals_rows is None \
        else np.asarray(totals_rows, dtype=np.int32)
    return ClusterState(totals, avail)


class TestOracleSemantics:
    def test_strict_pack_one_node(self):
        st = mk_state([[800, 0], [1600, 0], [400, 0]])
        rows = schedule_bundles(st, np.array([[400, 0], [800, 0]]),
                                S.STRICT_PACK)
        assert rows is not None and len(set(rows)) == 1
        assert rows[0] == 1                    # only node 1 fits the sum
        assert st.avail[1, 0] == 400

    def test_strict_pack_infeasible_no_mutation(self):
        st = mk_state([[800, 0], [800, 0]])
        before = st.avail.copy()
        rows = schedule_bundles(st, np.array([[800, 0], [100, 0]]),
                                S.STRICT_PACK)
        assert rows is None
        assert (st.avail == before).all()

    def test_strict_spread_distinct_nodes(self):
        st = mk_state([[800, 0]] * 3)
        rows = schedule_bundles(st, np.array([[100, 0]] * 3),
                                S.STRICT_SPREAD)
        assert rows is not None and len(set(rows)) == 3

    def test_strict_spread_fails_when_fewer_nodes(self):
        st = mk_state([[800, 0], [800, 0]])
        before = st.avail.copy()
        rows = schedule_bundles(st, np.array([[100, 0]] * 3),
                                S.STRICT_SPREAD)
        assert rows is None and (st.avail == before).all()

    def test_pack_prefers_reuse(self):
        # plenty of room everywhere: PACK should co-locate bundles
        st = mk_state([[1600, 0]] * 4)
        rows = schedule_bundles(st, np.array([[100, 0]] * 3), S.PACK)
        assert rows is not None and len(set(rows)) == 1

    def test_pack_overflows_to_second_node(self):
        st = mk_state([[250, 0], [1000, 0]])
        rows = schedule_bundles(st, np.array([[100, 0]] * 3), S.PACK)
        assert rows is not None
        assert len(set(rows)) == 2             # first fills, rest spill

    def test_spread_prefers_distinct_then_reuses(self):
        st = mk_state([[800, 0], [800, 0]])
        rows = schedule_bundles(st, np.array([[100, 0]] * 3), S.SPREAD)
        assert rows is not None
        assert sorted(np.bincount(rows, minlength=2)) == [1, 2]

    def test_commit_false_leaves_state(self):
        st = mk_state([[800, 0]])
        before = st.avail.copy()
        rows = schedule_bundles(st, np.array([[100, 0]]), S.PACK,
                                commit=False)
        assert rows is not None and (st.avail == before).all()

    def test_node_mask_respected(self):
        st = mk_state([[800, 0], [800, 0]])
        rows = schedule_bundles(st, np.array([[100, 0]]), S.PACK,
                                node_mask=np.array([False, True]))
        assert rows is not None and rows[0] == 1


def random_bundle_problem(rng, n_nodes=24, n_res=4, n_groups=12,
                          max_bundles=5):
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


class TestDeviceParity:
    @pytest.mark.parametrize("seed", range(12))
    def test_random_groups_bit_exact(self, seed, device):
        rng = np.random.default_rng(seed)
        totals, avail, mask, reqs, valid, strategies = \
            random_bundle_problem(rng)
        rows_dev, ok_dev, avail_dev = schedule_bundle_groups_np(
            totals, avail, mask, reqs, valid, strategies,
            spread_threshold=0.5, device=device)

        st = ClusterState(totals.copy(), avail.copy(), mask.copy())
        for p in range(reqs.shape[0]):
            nb = int(valid[p].sum())
            want = schedule_bundles(st, reqs[p, :nb],
                                    S(int(strategies[p])),
                                    spread_threshold=0.5)
            if want is None:
                assert not ok_dev[p], (seed, p)
                assert (rows_dev[p] == -1).all()
            else:
                assert ok_dev[p], (seed, p)
                assert (rows_dev[p, :nb] == want).all(), (seed, p)
                assert (rows_dev[p, nb:] == -1).all()
        assert (avail_dev == st.avail).all()

    def test_sequential_consumption_across_groups(self, device):
        # group 0 drains node 0; group 1 must land elsewhere
        totals = np.array([[1000], [1000]], dtype=np.int32)
        avail = totals.copy()
        reqs = np.array([[[1000]], [[600]]], dtype=np.int32)
        valid = np.ones((2, 1), dtype=bool)
        rows, ok, _ = schedule_bundle_groups_np(
            totals, avail, np.ones(2, bool), reqs, valid,
            [S.PACK, S.PACK], spread_threshold=0.5, device=device)
        assert ok.all()
        assert rows[0, 0] == 0 and rows[1, 0] == 1

    def test_failed_group_is_atomic(self, device):
        totals = np.array([[1000]], dtype=np.int32)
        avail = totals.copy()
        # group 0: strict spread of 2 on 1 node -> fails; group 1 still fits
        reqs = np.array([[[400], [400]], [[1000], [0]]], dtype=np.int32)
        valid = np.array([[True, True], [True, False]])
        rows, ok, new_avail = schedule_bundle_groups_np(
            totals, avail, np.ones(1, bool), reqs, valid,
            [S.STRICT_SPREAD, S.PACK], spread_threshold=0.5,
            device=device)
        assert not ok[0] and ok[1]
        assert (rows[0] == -1).all() and rows[1, 0] == 0
        assert new_avail[0, 0] == 0

"""The budget-emitting beat: device/oracle parity + the lease seam.

r17 tentpole gates, same discipline as ``tests/test_oracle.py``:

- randomized delta-sequence parity — the beat's packed readback carries
  per-(class, node) lease budgets bit-identical to
  ``contract.compute_budgets`` on the post-water-fill oracle state, at
  1 shard (plain ``DeltaScheduler``) and 2/8 shards
  (``ShardedDeltaScheduler``), under seeded CRM churn;
- the budget board (beat -> grantor seam) and the grantor's
  revoked-holder skip in ``origin_for`` (the spillback-storm
  regression).
"""

import numpy as np
import pytest

from ray_tpu_torch.scheduling import DeltaScheduler, schedule_grouped_oracle
from ray_tpu_torch.scheduling.contract import BUDGET_CAP, compute_budgets
from torch_ref_fixtures import (  # noqa: F401
    _port_device_module, _port_state, device)

# Port copy of tests/test_budget_beat.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable);
# - the engines take ``device`` (the fixture of
#   tests/torch_ref_fixtures.py): every case that runs the delta engine
#   runs once with "cpu" (the plain PyTorch versions) and once with
#   "cuda" under the ``cuda`` marker, which skips without a GPU.  The
#   sharded engine's ranks are ``shards`` ranks of that one device
#   (``devices=``): the reference's 2 and 8 shards are devices of the
#   virtual CPU mesh;
# - ``_churn_cluster`` and ``_mutate`` are copied from
#   tests/test_oracle.py onto the port's types: importing them would
#   import ``ray_tpu``.


def _churn_cluster(seed, n_nodes=24, n_classes=6, capacity=32):
    """A live ClusterResourceManager + interned class batch for the
    delta-sequence tests (the real mutation surface, not a synthetic
    snapshot)."""
    from ray_tpu_torch.common.ids import NodeID
    from ray_tpu_torch.common.resources import NodeResources, ResourceRequest
    from ray_tpu_torch.scheduling import ClusterResourceManager

    rng = np.random.default_rng(seed)
    crm = ClusterResourceManager(capacity=capacity)
    ids = [crm.id_of(crm.add_node(NodeID.from_random(), NodeResources(
        {"CPU": int(rng.integers(2, 32)),
         "memory": int(rng.integers(1, 64))})))
        for _ in range(n_nodes)]
    class_reqs = [ResourceRequest({"CPU": int(rng.integers(1, 4)),
                                   "memory": float(rng.integers(0, 6))})
                  for _ in range(n_classes)]
    vecs = np.stack([crm.intern_request(r) for r in class_reqs])
    counts = rng.integers(1, 12, size=n_classes).astype(np.int32)
    return rng, crm, ids, vecs, counts


def _mutate(rng, crm, node_ids, debts):
    """One beat's worth of random CRM churn: subtract / add_back /
    drain / suspect / heartbeat-avail updates (>=1 mutation so delta
    beats actually occur at every seed)."""
    from ray_tpu_torch.common.resources import ResourceRequest
    one = ResourceRequest({"CPU": 1})
    for _ in range(1 + int(rng.integers(0, 5))):
        op = int(rng.integers(0, 5))
        row = int(rng.integers(0, len(node_ids)))
        if op == 0:
            crm.force_subtract(row, one)
            debts.append(row)
        elif op == 1 and debts:
            crm.add_back(debts.pop(int(rng.integers(0, len(debts)))), one)
        elif op == 2:
            crm.set_draining(node_ids[row], bool(rng.integers(0, 2)))
        elif op == 3:
            crm.set_suspect(row, bool(rng.integers(0, 2)))
        else:
            crm.update_node_available(
                node_ids[row], {"CPU": int(rng.integers(0, 3200))})


def _oracle_budgets(crm, vecs, counts, extra_mask=None):
    """Replay the beat on a fresh snapshot and price budgets off the
    post-water-fill avail (schedule_grouped_oracle mutates the
    snapshot's avail in place, excluding queued overflow — the same
    state the device scan carries out)."""
    st = crm.snapshot()
    mask = st.node_mask
    if extra_mask is not None:
        mask = mask & extra_mask[:mask.shape[0]]
        st.node_mask = mask
    schedule_grouped_oracle(st, vecs, counts)
    return compute_budgets(st.totals, st.avail, vecs, node_mask=mask)


def _engine(crm, shards, device):
    if shards <= 1:
        return DeltaScheduler(crm, device=device)
    from ray_tpu_torch.scheduling.sharded_delta import ShardedDeltaScheduler
    return ShardedDeltaScheduler(crm, shards, devices=[device] * shards)


class TestBudgetParity:
    """Device-emitted budgets == CPU oracle budgets, bit for bit."""

    @pytest.mark.parametrize("shards", [1, 2, 8])
    def test_randomized_churn_parity(self, shards, device):
        rng, crm, ids, vecs, counts = _churn_cluster(seed=41 + shards)
        eng = _engine(crm, shards, device)
        debts = []
        for _ in range(8):
            _mutate(rng, crm, ids, debts)
            got_counts = eng.beat(vecs, counts)
            want = _oracle_budgets(crm, vecs, counts)
            np.testing.assert_array_equal(
                got_counts, schedule_grouped_oracle(crm.snapshot(),
                                                    vecs, counts))
            for i, v in enumerate(vecs):
                np.testing.assert_array_equal(
                    eng.budget_row_host(v), want[i],
                    err_msg=f"class {i} @ {shards} shards")
        assert eng.budget_seq == eng.stats["beats"]

    def test_overrides_and_softmask_priced_in(self, device):
        """Budgets respect the beat's ephemeral avail overrides and
        suspect soft mask — the same effective state the counts saw."""
        rng, crm, ids, vecs, counts = _churn_cluster(seed=47)
        eng = DeltaScheduler(crm, device=device)
        eng.beat(vecs, counts)                   # warm sync
        over = {}
        for row in (0, 1):
            base = crm.arrays()[1][row].astype(np.int64)
            base -= 150
            over[row] = base.clip(-(2 ** 30), 2 ** 30).astype(np.int32)
        sus = np.ones(crm.arrays()[0].shape[0], bool)
        sus[1] = False
        eng.beat(vecs, counts, overrides=over, extra_mask=sus)
        st = crm.snapshot()
        for row in (0, 1):
            st.avail[row] = over[row]
        mask = st.node_mask & sus
        st.node_mask = mask
        schedule_grouped_oracle(st, vecs, counts)
        want = compute_budgets(st.totals, st.avail, vecs, node_mask=mask)
        for i, v in enumerate(vecs):
            np.testing.assert_array_equal(eng.budget_row_host(v), want[i])
        # the masked-out suspect row prices at 0 for every class
        assert all(int(eng.budget_row_host(v)[1]) == 0 for v in vecs)

    def test_zero_request_class_prices_at_cap(self):
        """The 'zero' lease class (no positive demand) is
        admission-unbounded: cap on masked-in rows, 0 elsewhere."""
        totals = np.full((4, 2), 800, np.int32)
        avail = np.array([[800, 800], [100, 0], [0, 0], [800, 800]],
                         np.int32)
        mask = np.array([True, True, True, False])
        reqs = np.zeros((1, 2), np.int32)
        b = compute_budgets(totals, avail, reqs, node_mask=mask)
        np.testing.assert_array_equal(
            b, [[BUDGET_CAP, BUDGET_CAP, BUDGET_CAP, 0]])

    def test_negative_avail_prices_zero_headroom(self):
        """Overcommitted rows (negative avail after planned-load
        debits) owe 0 budget — clamped BEFORE the floor division, so
        numpy/XLA negative-// divergence can never split the twins."""
        totals = np.full((2, 1), 800, np.int32)
        avail = np.array([[-100], [399]], np.int32)
        reqs = np.array([[200]], np.int32)
        np.testing.assert_array_equal(
            compute_budgets(totals, avail, reqs), [[0, 1]])

    def test_accessors_before_first_beat(self, device):
        _rng, crm, _ids, vecs, _counts = _churn_cluster(seed=53)
        eng = DeltaScheduler(crm, device=device)
        assert eng.last_budgets() is None
        assert eng.budget_row_host(vecs[0]) is None
        assert eng.budget_seq == 0


class TestBudgetBoard:
    """The process-wide beat -> grantor seam."""

    def test_publish_lookup_miss(self):
        from ray_tpu_torch.leasing.board import BudgetBoard
        b = BudgetBoard()
        assert b.budget_for("CPU:100", 0) is None           # empty board
        b.publish(3, {"CPU:100": np.array([5, 0, 7], np.int32)})
        assert b.seq() == 3
        assert b.budget_for("CPU:100", 0) == 5
        assert b.budget_for("CPU:100", 2) == 7
        assert b.budget_for("CPU:100", 9) is None           # out of range
        assert b.budget_for("GPU:100", 0) is None           # unknown class
        s = b.stats()
        assert s["budget_board_hits"] == 2
        assert s["budget_board_misses"] == 3
        b.clear()
        assert b.seq() == 0 and b.budget_for("CPU:100", 0) is None

    def test_raylet_publishes_beat_budgets(self, device):
        """The raylet-side publisher re-keys interned vectors to lease
        class-key strings and lands the beat's rows on the board."""
        from ray_tpu_torch.leasing.board import budget_board
        from ray_tpu_torch.runtime.raylet import Raylet

        board = budget_board()
        board.clear()
        _rng, crm, _ids, vecs, counts = _churn_cluster(seed=59)
        eng = DeltaScheduler(crm, device=device)
        eng.beat(vecs, counts)
        Raylet._publish_beat_budgets.__get__(
            type("R", (), {"crm": crm})())(eng)
        assert board.seq() == 1
        # every interned class landed under its node_agent-format key
        idx = crm.resource_index
        for slot, vec in eng.class_vectors().items():
            parts = sorted((idx.name(int(c)), int(vec[c]))
                           for c in np.flatnonzero(vec))
            ck = ",".join(f"{k}:{v}" for k, v in parts) or "zero"
            row0 = board.budget_for(ck, 0)
            assert row0 == int(eng.last_budgets()[slot][0])
        board.clear()


class TestOriginForRevokedSkip:
    """Satellite regression: origin_for must not route repeat-class
    traffic to a holder whose epoch was bumped since its last grant —
    pre-fix, a revoked node stayed in rotation for a full cycle and
    every routed batch spilled back."""

    def test_revoked_holder_skipped_until_regrant(self):
        from ray_tpu_torch.leasing import LeaseGrantor
        g = LeaseGrantor(budget_per_class=4)
        g.grant("a", "CPU:100")
        g.grant("b", "CPU:100")
        g.revoke("a", "quiet_lease")        # revoke WITHOUT unlink
        # a full rotation never lands on the fenced holder
        for _ in range(4):
            assert g.origin_for("CPU:100") == "b"
        # re-grant re-stamps: 'a' rejoins the rotation
        g.grant("a", "CPU:100")
        assert {g.origin_for("CPU:100") for _ in range(4)} == {"a", "b"}

    def test_all_holders_revoked_falls_back(self):
        from ray_tpu_torch.leasing import LeaseGrantor
        g = LeaseGrantor(budget_per_class=4)
        g.grant("a", "CPU:100")
        g.revoke("a")
        assert g.origin_for("CPU:100") is None

    def test_drop_node_forgets_stamp(self):
        from ray_tpu_torch.leasing import LeaseGrantor
        g = LeaseGrantor(budget_per_class=4)
        g.grant("a", "CPU:100")
        g.drop_node("a")
        assert g.origin_for("CPU:100") is None
        # rejoin after re-register: a fresh grant under the new epoch
        g.grant("a", "CPU:100")
        assert g.origin_for("CPU:100") == "a"

    def test_eligible_filter_still_applies(self):
        from ray_tpu_torch.leasing import LeaseGrantor
        g = LeaseGrantor(budget_per_class=4)
        g.grant("a", "CPU:100")
        g.grant("b", "CPU:100")
        g.revoke("b")
        assert g.origin_for("CPU:100", eligible=lambda n: n != "a") is None

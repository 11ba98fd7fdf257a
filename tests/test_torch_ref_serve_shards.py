"""Sharded serve routers, gossiped load state and capacity loaning.

The request plane scaled out: ``RouterGroup`` shards per controller
with consistent-hash session stickiness, per-replica load digests
folded onto the process gossip board (with membership eviction — the
unbounded-stats regression), and the elastic serve<->batch capacity
loan cycle including the SIGKILL-mid-reclaim chaos path."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.common.config import Config
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_serve_shards.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable);
# - ``_loan_knobs`` depends on ``_port_state`` in place of conftest's
#   ``_fresh_config``: that fixture resets the reference's Config, and
#   the port's per-test reset is ``_port_state``.  Depending on it keeps
#   the reference's order (reset first, then the knobs); without it
#   pytest sets the knobs up first and the reset wipes them, so no loan
#   ever starts (serve_loan_backlog falls back to 8).


pytestmark = pytest.mark.serve


@pytest.fixture(scope="module", autouse=True)
def driver():
    ray_tpu_torch.init(resources={"CPU": 8, "memory": 8}, num_workers=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture(autouse=True)
def _loan_knobs(_port_state):
    # loan knobs tightened so the cycle runs inside test timeouts.
    # Depends on conftest's _fresh_config so its per-test reset runs
    # FIRST (the knobs are read live at every loans.tick()).
    Config.reset({"serve_loan_backlog": 2, "serve_loan_cooldown_s": 0.0,
                  "serve_loan_reclaim_idle_s": 0.5,
                  "serve_loan_drain_timeout_s": 5.0})
    yield


@pytest.fixture(autouse=True)
def cleanup():
    yield
    serve.delete()


def _cluster():
    from ray_tpu_torch.api import _get_runtime
    return _get_runtime().cluster


def _group(num_shards=None):
    """The deployment's RouterGroup, optionally re-created with an
    explicit shard count (the crash-and-recreate model tests use)."""
    from ray_tpu_torch.serve.router import RouterGroup
    ctl = serve.get_deployment_handle()._controller
    if num_shards is not None:
        RouterGroup.discard(ctl)
        return RouterGroup.for_controller(ctl, num_shards=num_shards)
    return RouterGroup.for_controller(ctl)


class TestShardStickiness:
    def test_session_maps_to_one_shard(self):
        """Consistent-hash rendezvous: one session, one shard, and the
        distinct sessions spread across shards instead of piling onto
        one."""
        @serve.deployment
        class Echo:
            def __call__(self, x):
                return x

        serve.run(Echo.bind())
        group = _group(num_shards=4)
        hits = {}
        for k in range(64):
            shard = group.shard_for(f"sess-{k}")
            assert shard is group.shard_for(f"sess-{k}")     # sticky
            hits[shard._shard_id] = hits.get(shard._shard_id, 0) + 1
        assert len(hits) == 4, f"sessions piled onto {hits}"

    def test_sessionless_round_robins(self):
        @serve.deployment
        class Echo:
            def __call__(self, x):
                return x

        serve.run(Echo.bind())
        group = _group(num_shards=3)
        seen = {group.shard_for(None)._shard_id for _ in range(6)}
        assert seen == {0, 1, 2}

    def test_mux_stickiness_survives_resharding(self):
        """The mux->replica rendezvous hashes over replica ids, not
        shards — re-sharding the router must not move a multiplexed
        model off its warm replica."""
        @serve.deployment(num_replicas=3)
        class Who:
            def __call__(self, x):
                return id(self)

        handle = serve.run(Who.bind())
        h = handle.options(multiplexed_model_id="m-stick")
        before = set(ray_tpu_torch.get([h.remote(i) for i in range(6)],
                                 timeout=60))
        assert len(before) == 1, "mux id routed to several replicas"
        _group(num_shards=3)        # discard + re-create: re-shard
        after = set(ray_tpu_torch.get([h.remote(i) for i in range(6)],
                                timeout=60))
        assert after == before, "re-sharding moved the mux replica"

    def test_session_stickiness_survives_shard_restart(self):
        """restart_shard replaces a shard in place; shard ids are
        stable so the session->shard hash still lands on slot i and
        the fresh shard serves the session's calls."""
        @serve.deployment
        class Echo:
            def __call__(self, x):
                return x

        handle = serve.run(Echo.bind())
        group = _group(num_shards=3)
        sid = group.shard_for("sticky-session")._shard_id
        group.restart_shard(sid)
        assert group.shard_for("sticky-session")._shard_id == sid
        h = handle.options(session_id="sticky-session")
        assert ray_tpu_torch.get([h.remote(i) for i in range(4)],
                           timeout=60) == [0, 1, 2, 3]

    def test_flip_stickiness_survives_shard_restart(self):
        """A rolling update is mid-flip (one replica out of routing,
        ``rollout_active`` on) when a shard crashes and is recreated.
        The session's version pin is group-level and the mux->replica
        rendezvous hashes over replica ids — so the session stays on a
        consistent version and the warm mux replica never moves."""
        @serve.deployment(num_replicas=3)
        class Who:
            def __call__(self, x):
                return id(self)

        handle = serve.run(Who.bind())
        group = _group(num_shards=3)
        ctl = serve.get_deployment_handle()._controller
        reps = ray_tpu_torch.get(ctl.get_replicas.remote(), timeout=60)[1]
        key = reps[0]._actor_id.binary().hex()
        ray_tpu_torch.get(ctl.set_rollout_active.remote(True), timeout=30)
        assert ray_tpu_torch.get(ctl.begin_flip.remote(key), timeout=30)
        group._refresh(force=True)
        try:
            h = handle.options(multiplexed_model_id="m-flip")
            # a health-beat refresh racing set_rollout_active can
            # install a stale (pre-rollout) config after our forced
            # one, so the first requests may route unpinned — re-force
            # until the pin engages rather than asserting one shot
            deadline = time.monotonic() + 15
            while True:
                before = set(ray_tpu_torch.get(
                    [h.remote(i) for i in range(6)], timeout=60))
                assert len(before) == 1, \
                    "mux id routed to several replicas"
                pin = group.version_pins().get("m-flip")
                if pin is not None:
                    break
                assert time.monotonic() < deadline, "pin never engaged"
                group._refresh(force=True)
            sid = group.shard_for("m-flip")._shard_id
            group.restart_shard(sid)
            after = set(ray_tpu_torch.get([h.remote(i) for i in range(6)],
                                    timeout=60))
            assert after == before, "re-shard moved the warm mux replica"
            # the pin table lives on the GROUP: the restarted shard
            # sees the same pin, not a fresh (possibly different) one
            assert group.version_pins().get("m-flip") == pin
        finally:
            ray_tpu_torch.get(ctl.commit_flip.remote(key, "v1"), timeout=30)
            ray_tpu_torch.get(ctl.set_rollout_active.remote(False), timeout=30)


class TestGossipBoard:
    def test_fold_evicts_departed_replicas(self):
        """The unbounded per-replica stats regression: entries for
        replicas that left the membership are evicted on fold, not
        retained forever."""
        from ray_tpu_torch.serve.gossip import LoadBoard

        board = LoadBoard()
        board.fold("kv/dep", {0: {b"r1": 3, b"r2": 1}}, {b"r1", b"r2"})
        assert board.digest_size("kv/dep") == 2
        # r2 left the deployment (scale-down / death) but its count is
        # still in the shard digest: the fold must evict, not keep it
        board.fold("kv/dep", {0: {b"r1": 2, b"r2": 1}}, {b"r1"})
        assert board.digest_size("kv/dep") == 1
        assert board.remote_load("kv/dep", 0, b"r2") == 0
        assert board.stats()["evicted_replicas"] >= 1

    def test_live_fold_evicts_ghosts_and_teardown_drops_board(self):
        """End-to-end: a digest entry whose replica left the
        controller's membership (death, scale-down, loan reclaim) is
        evicted on the next fold, and deleting the deployment drops
        its whole board entry."""
        from ray_tpu_torch.serve.gossip import board

        @serve.deployment(num_replicas=3)
        class Echo:
            def __call__(self, x):
                return x

        handle = serve.run(Echo.bind())
        group = _group(num_shards=2)
        ray_tpu_torch.get([handle.remote(i) for i in range(12)], timeout=60)
        group._refresh(force=True)
        group.fold()
        base = group._shards[0]._kv_base
        size = board.digest_size(base)
        assert 1 <= size <= 3

        # plant a digest entry for a replica that is not (any longer)
        # in the membership — the dead-replica residue the fix targets
        shard = group._shards[0]
        with shard._cv:
            shard._inflight[b"ghost-replica"] = 5
        before = board.stats()["evicted_replicas"]
        group.fold()
        assert board.digest_size(base) == size          # ghost dropped
        assert board.remote_load(base, 1, b"ghost-replica") == 0
        assert board.stats()["evicted_replicas"] == before + 1
        with shard._cv:
            shard._inflight.pop(b"ghost-replica", None)

        serve.delete()
        assert board.digest_size(base) == 0             # evicted whole


class _SlowApp:
    """Deployment factory shared by the loan tests: one pinned replica
    (min==max) so extra capacity can only come from a loan."""

    @staticmethod
    def run(sleep_s=0.3):
        @serve.deployment(autoscaling_config={
            "min_replicas": 1, "max_replicas": 1,
            "target_ongoing_requests": 1}, max_ongoing_requests=1)
        class Slow:
            def __init__(self, sleep_s):
                self._sleep = sleep_s

            def __call__(self, x):
                time.sleep(self._sleep)
                return x + 1

        return serve.run(Slow.bind(sleep_s))


def _wait_replicas(n, timeout=15.0):
    """Replica teardown after a reclaim (and after a loaner death) is
    asynchronous in the controller — poll membership, don't snapshot."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if serve.status()["num_replicas"] == n:
            return
        time.sleep(0.1)
    assert serve.status()["num_replicas"] == n


def _drain_loans(cluster, timeout=20.0):
    """Force every active loan through its reclaim before tearing the
    deployment down — a node removed while still loaned would leak a
    loan record into the next test (booked as a phantom loss)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = cluster.loans.stats()
        if st["loans_active"] == 0:
            return
        cluster.loans.tick(unmet=st["loans_active"])
        time.sleep(0.1)


class TestCapacityLoaning:
    def test_loan_and_reclaim_cycle(self):
        """Backlog at max_replicas borrows an idle batch node; idleness
        reclaims it through drain semantics and restores the row's
        availability bit-for-bit."""
        cluster = _cluster()
        base = cluster.loans.stats()        # counters are cumulative
        nid = cluster.add_node(resources={"CPU": 2, "memory": 2},
                               num_workers=2)
        row = cluster.crm.row_of(nid)
        try:
            handle = _SlowApp.run()
            refs = [handle.remote(i) for i in range(8)]
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                cluster.loans.tick()
                if cluster.loans.stats()["loans_active"]:
                    break
                time.sleep(0.1)
            st = cluster.loans.stats()
            assert st["loans_total"] > base["loans_total"]
            assert st["loans_active"] == 1
            assert cluster.crm.loaned_rows() == [row]
            _wait_replicas(2)                              # +loaner
            assert ray_tpu_torch.get(refs, timeout=60) == \
                [i + 1 for i in range(8)]

            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                cluster.loans.tick()
                if cluster.loans.stats()["loans_active"] == 0:
                    break
                time.sleep(0.1)
            st = cluster.loans.stats()
            assert st["reclaims_total"] > base["reclaims_total"]
            assert st["loans_lost"] == base["loans_lost"]
            assert st["last_reclaim_latency_s"] < 5.0
            assert not cluster.crm.loaned_rows()
            assert not cluster.crm.draining_rows()
            _wait_replicas(1)
            totals, avail, _mask = cluster.crm.arrays()
            assert bool((avail[row] == totals[row]).all()), \
                "reclaim did not restore the borrowed availability"
        finally:
            _drain_loans(cluster)
            serve.delete()
            if cluster.crm.row_of(nid) is not None:
                cluster.remove_node(nid)

    def test_batch_pressure_triggers_reclaim(self):
        """tick(unmet=N) — the autoscaler's unmet-demand signal — pulls
        an ACTIVE loan back even while serve traffic continues."""
        cluster = _cluster()
        base = cluster.loans.stats()
        nid = cluster.add_node(resources={"CPU": 2, "memory": 2},
                               num_workers=2)
        try:
            handle = _SlowApp.run()
            refs = [handle.remote(i) for i in range(8)]
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                cluster.loans.tick()
                if cluster.loans.stats()["loans_active"]:
                    break
                time.sleep(0.1)
            assert cluster.loans.stats()["loans_active"] == 1
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                cluster.loans.tick(unmet=1)     # batch wants it back
                if cluster.loans.stats()["reclaims_total"] > \
                        base["reclaims_total"]:
                    break
                time.sleep(0.1)
            st = cluster.loans.stats()
            assert st["reclaims_total"] > base["reclaims_total"]
            assert st["loans_lost"] == base["loans_lost"]
            ray_tpu_torch.get(refs, timeout=60)
        finally:
            _drain_loans(cluster)
            serve.delete()
            if cluster.crm.row_of(nid) is not None:
                cluster.remove_node(nid)

    def _lendable_pool(self, cluster):
        """Two batch nodes exposing a ``lendable`` resource the head
        lacks, so a 2-replica deployment pinned to it lands one replica
        per node — the released (newest) replica's node is then a
        removable non-head row."""
        nids = [cluster.add_node(
            resources={"CPU": 2, "memory": 2, "lendable": 1},
            num_workers=2) for _ in range(2)]

        @serve.deployment(num_replicas=2, max_ongoing_requests=1,
                          ray_actor_options={
                              "resources": {"lendable": 1}})
        class Slow:
            def __call__(self, x):
                time.sleep(0.4)
                return x + 1

        handle = serve.run(Slow.bind())
        # warm up: creates the driver-side RouterGroup the manager
        # reads, and leaves the deployment QUIET (queued=inflight=0)
        assert ray_tpu_torch.get(handle.remote(0), timeout=60) == 1
        return nids, handle

    def _teardown_lend_pool(self, cluster, nids):
        serve.delete()
        for nid in nids:
            if cluster.crm.row_of(nid) is not None:
                cluster.remove_node(nid)
        # book any leftover lend records against the removed nodes NOW
        # so they never surface as phantom losses in the next test
        for _ in range(3):
            cluster.loans.tick()
            time.sleep(0.05)
        # a lend under a long serve_loan_cooldown_s leaves the manager's
        # cooldown clock armed past this test — disarm it
        cluster.loans._cooldown_until = 0.0

    def test_reverse_lend_starts_drains_and_returns_on_pressure(self):
        """The reverse direction: unmet batch demand with no idle batch
        row borrows a quiet deployment's newest replica (drain -> lent);
        serve backlog pressure ends the lend and a fresh replica makes
        serve whole."""
        cluster = _cluster()
        base = cluster.loans.stats()
        nids, handle = self._lendable_pool(cluster)
        try:
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                cluster.loans.tick(unmet=1)
                if cluster.loans.stats()["reverse_lends_active"]:
                    break
                time.sleep(0.1)
            st = cluster.loans.stats()
            assert st["reverse_lends_total"] == \
                base["reverse_lends_total"] + 1
            assert st["reverse_lends_active"] == 1
            assert st["loans_active"] == 0      # never both directions
            _wait_replicas(1)                   # replica out of routing
            rl = cluster.loans._rloans[0]
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                cluster.loans.tick()
                if rl.state == "lent":
                    break
                time.sleep(0.1)
            assert rl.state == "lent", rl.state

            # serve pressure: backlog on the one remaining replica ends
            # the lend and restores a replacement replica
            refs = [handle.remote(i) for i in range(6)]
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                cluster.loans.tick()
                if cluster.loans.stats()["reverse_lends_active"] == 0:
                    break
                time.sleep(0.1)
            st = cluster.loans.stats()
            assert st["reverse_lends_returned"] == \
                base["reverse_lends_returned"] + 1
            assert st["reverse_lends_active"] == 0
            assert st["reverse_lends_lost"] == base["reverse_lends_lost"]
            # an inline dispatch racing the stale routing view may have
            # hit the released replica; queued requests failed over —
            # count the survivors, and NEW traffic must flow
            ok = 0
            for r in refs:
                try:
                    ray_tpu_torch.get(r, timeout=60)
                    ok += 1
                except Exception:   # noqa: BLE001 — stale-view race
                    pass
            assert ok >= len(refs) - 1, f"only {ok}/{len(refs)} served"
            assert ray_tpu_torch.get(handle.remote(50), timeout=60) == 51
            _wait_replicas(2)                   # serve made whole
        finally:
            self._teardown_lend_pool(cluster, nids)

    def test_node_death_mid_reverse_lend_books_loss_once(self):
        """Chaos twin in the NEW direction: the lent node dies while
        batch holds it.  The loss is booked exactly once (popping the
        record IS the bookkeeping — extra beats never double-count) and
        serve keeps serving on its surviving replica."""
        # long cooldown: exactly ONE lend this test, no re-lend racing
        # the death booking
        Config.reset({"serve_loan_backlog": 2,
                      "serve_loan_cooldown_s": 60.0,
                      "serve_loan_reclaim_idle_s": 60.0,
                      "serve_loan_drain_timeout_s": 30.0})
        cluster = _cluster()
        base = cluster.loans.stats()
        nids, handle = self._lendable_pool(cluster)
        try:
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                cluster.loans.tick(unmet=1)
                if cluster.loans.stats()["reverse_lends_active"]:
                    break
                time.sleep(0.1)
            assert cluster.loans.stats()["reverse_lends_active"] == 1
            rl = cluster.loans._rloans[0]
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                cluster.loans.tick()
                if rl.state == "lent":
                    break
                time.sleep(0.1)
            assert rl.state == "lent", rl.state

            # the lent node dies the way the health manager removes it
            cluster.remove_node(rl.node_id)
            for _ in range(3):      # extra beats: booked exactly once
                cluster.loans.tick()
                time.sleep(0.05)
            st = cluster.loans.stats()
            assert st["reverse_lends_lost"] == \
                base["reverse_lends_lost"] + 1, st
            assert st["reverse_lends_active"] == 0
            # the dying lend never returned — the death path booked it
            assert st["reverse_lends_returned"] == \
                base["reverse_lends_returned"]
            # serve still serves on the surviving replica
            assert ray_tpu_torch.get(handle.remote(100), timeout=60) == 101
        finally:
            self._teardown_lend_pool(cluster, nids)

    def test_sigkill_loaned_node_mid_reclaim_books_loss_once(self):
        """Chaos: the loaned node dies while its reclaim drain is in
        flight.  The drain must converge (by death), the router must
        shed the dead replica cleanly, and the loss is booked exactly
        once — extra beats never double-count."""
        # long cooldown + idle threshold: exactly ONE loan this test,
        # and only the explicit tick(unmet=1) below starts a reclaim
        Config.reset({"serve_loan_backlog": 2,
                      "serve_loan_cooldown_s": 60.0,
                      "serve_loan_reclaim_idle_s": 60.0,
                      "serve_loan_drain_timeout_s": 30.0})
        cluster = _cluster()
        base = cluster.loans.stats()
        nid = cluster.add_node(resources={"CPU": 2, "memory": 2},
                               num_workers=2)
        handle = _SlowApp.run(sleep_s=1.0)
        refs = [handle.remote(i) for i in range(8)]
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            cluster.loans.tick()
            if cluster.loans.stats()["loans_active"]:
                break
            time.sleep(0.1)
        assert cluster.loans.stats()["loans_active"] == 1

        # begin the reclaim while the loaner still has work in flight:
        # batch pressure starts the drain, the slow requests hold it
        cluster.loans.tick(unmet=1)
        loans = cluster.loans.active_loans()
        assert loans and loans[0]["state"] == "draining", loans

        # SIGKILL mid-reclaim: the node leaves the cluster the way the
        # health manager removes a dead one
        cluster.remove_node(nid)
        for _ in range(3):          # extra beats: booked exactly once
            cluster.loans.tick()
            time.sleep(0.05)
        st = cluster.loans.stats()
        assert st["loans_lost"] == base["loans_lost"] + 1, st
        assert st["loans_active"] == 0
        # the dying reclaim never completed — the death path booked it
        assert st["reclaims_total"] == base["reclaims_total"]
        assert not cluster.crm.loaned_rows()

        # requests that were on the dead loaner may fail; the survivors
        # and any NEW traffic must be served by the remaining replica
        for r in refs:
            try:
                ray_tpu_torch.get(r, timeout=60)
            except Exception:   # noqa: BLE001 — died with the loaner
                pass
        assert ray_tpu_torch.get(handle.remote(100), timeout=60) == 101
        _wait_replicas(1)

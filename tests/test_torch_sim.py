"""The port's cluster simulator against the JAX package's, byte for byte.

Scenario sources: ``tests/test_sim.py``, ``tests/test_hunt.py``,
``tests/test_invariants.py`` and the simulator cases of
``tests/test_leasing.py`` (``TestDispatchSim``), ``tests/test_broadcast.py``
(``TestSimBroadcast``) and ``tests/test_versioning.py``
(``TestSimRolloutPlane``).  The simulator is host code (a virtual clock,
Philox streams, no device), and its gate is exact: the trace hash is a
sha256 over the canonical JSON of every event, so each scenario runs
through ``ray_tpu``, then through ``ray_tpu_torch``, and the hashes,
violations and stats must be equal.  A difference in the port's copies
of leasing, breakers, chaos streams, the clock or the config moves the
hash.  Artifacts keep the reference's format names, so a trace or a
finding written by one package replays under the other.
"""

from __future__ import annotations

import argparse
import importlib
import itertools
import json
import os
import re
from dataclasses import replace
from types import SimpleNamespace

import pytest

from ray_tpu_torch.common import lockorder as port_lockorder
from ray_tpu_torch.common import locksets as port_locksets
from ray_tpu_torch.common.config import Config as PortConfig

DATA = os.path.join(os.path.dirname(__file__), "data")

# tests/test_sim.py:63-66, the reference's golden seed-7 hashes
SERVE_DIURNAL_SEED7_HASH = \
    "2dd7639cd8f41d9f49093f5b8770245b6bde64cfbff6cca49ae33cef6d5fcf53"
TRAIN_DIURNAL_SEED7_HASH = \
    "ad15237d50274d184db2c3922bbf869c2d3d76e9ccbc34032d81899752766d10"

# The reference's broadcast_storm at 1000 nodes, seed 7, faults=50
# (default duration and autoscale) ends with two live members of waves
# w16 and w21 unreached: a fault of the reference, inherited by the port
# and not repaired there, since a repair would move the port's hashes.
STORM_1000_HASH = \
    "55431af4c1f4cbba2ba533096158f3f9adcb47d4936ac55c2f8ac0fd156295af"
STORM_1000_EVENTS = 1_088_690
STORM_1000_VIOLATIONS = [
    "[final] [inv:bcast-live-replica @t=200.0] broadcast wave w16: 2 "
    "live members without a replica",
    "[final] [inv:bcast-live-replica @t=200.0] broadcast wave w21: 1 "
    "live members without a replica",
]


def _mods(pkg):
    """The simulator's modules of one package (``<pkg>.sim.hunt`` by
    module path: the package re-exports the function over it)."""
    imp = importlib.import_module
    return SimpleNamespace(
        pkg=pkg, sim=imp(f"{pkg}.sim"),
        campaign=imp(f"{pkg}.sim.campaign"),
        cluster=imp(f"{pkg}.sim.cluster"),
        hunt=imp(f"{pkg}.sim.hunt"),
        invariants=imp(f"{pkg}.sim.invariants"),
        minimize=imp(f"{pkg}.sim.minimize"),
        broadcast=imp(f"{pkg}.sim.broadcast"),
        serve=imp(f"{pkg}.sim.serve"),
        rollout=imp(f"{pkg}.sim.rollout"),
        train=imp(f"{pkg}.sim.train"),
        dispatch=imp(f"{pkg}.sim.dispatch_bench"),
        clock=imp(f"{pkg}.common.clock"),
        lockorder=imp(f"{pkg}.common.lockorder"),
        phases=imp(f"{pkg}.versioning.phases"),
        client=imp(f"{pkg}.rpc.client"),
        cli=imp(f"{pkg}.scripts.cli"))


REF, PORT = _mods("ray_tpu"), _mods("ray_tpu_torch")


@pytest.fixture(autouse=True)
def _port_state():
    """The port's process-global state, as ``tests/conftest.py`` keeps
    the reference's: a fresh ``Config``, no chaos or open breakers, the
    real clock and transport seams after each test, and the port's
    runtime recorders when their knobs are on
    (``RT_RTLINT_RUNTIME_LOCK_ORDER=1``, ``RT_RTLINT_RUNTIME_LOCKSETS=1``;
    the reference's are installed by conftest, so both packages' traces
    count the same invariant checks)."""
    from ray_tpu_torch.common import clock
    from ray_tpu_torch.rpc import breaker, chaos, transport
    PortConfig.reset()
    chaos.disable()
    breaker.reset_registry()
    lock_order = port_lockorder.maybe_install_from_config()
    lock_sets = port_locksets.maybe_install_from_config()
    yield
    clock.uninstall()
    transport.uninstall()
    chaos.disable()
    breaker.reset_registry()
    if lock_order:
        try:
            port_lockorder.assert_acyclic()
        finally:
            port_lockorder.reset()
            port_lockorder.uninstall()
    if lock_sets:
        try:
            port_locksets.assert_no_races()
        finally:
            port_locksets.reset()
            port_locksets.uninstall()
    PortConfig.reset()


def _result(r) -> dict:
    """A campaign's result without its wall-clock numbers."""
    d = r.to_dict()
    d.pop("wall_s")
    d.pop("events_per_sec")
    return d


def _both(fn):
    """``fn(mods)`` through the reference, then the port."""
    return fn(REF), fn(PORT)


# -- the virtual clock ---------------------------------------------------------

def test_virtual_clock_fires_in_time_then_seq_order():
    def run(m):
        clk = m.clock.VirtualClock()
        seen = []
        clk.call_later(2.0, lambda: seen.append("b"))
        clk.call_later(1.0, lambda: seen.append("a"))
        clk.call_later(2.0, lambda: seen.append("c"))
        clk.advance(5.0)
        return seen, clk.monotonic()
    want, got = _both(run)
    assert got == want == (["a", "b", "c"], 5.0)


def test_virtual_sleep_inside_callback_advances_time():
    def run(m):
        clk = m.clock.VirtualClock()
        seen = []

        def cb():
            clk.sleep(5.0)
            seen.append(clk.monotonic())

        clk.call_later(1.0, cb)
        clk.call_later(2.0, lambda: seen.append(clk.monotonic()))
        clk.advance(10.0)
        return seen
    want, got = _both(run)
    assert got == want == [2.0, 6.0]


# -- campaigns: the reference's hashes ---------------------------------------

@pytest.mark.parametrize("campaign,nodes,kw,pinned", [
    ("serve_diurnal", 64, dict(faults=10, duration=200.0),
     SERVE_DIURNAL_SEED7_HASH),
    ("train_diurnal", 48, dict(faults=50, duration=400.0),
     TRAIN_DIURNAL_SEED7_HASH),
], ids=["serve_diurnal", "train_diurnal"])
def test_pinned_seed7_hash(campaign, nodes, kw, pinned):
    want, got = _both(lambda m: m.sim.run_campaign(
        nodes, seed=7, campaign=campaign, **kw))
    assert got.trace_hash == pinned
    assert _result(got) == _result(want)
    assert got.ok, got.violations
    if campaign == "serve_diurnal":
        s = got.stats["serve"]
        assert s["accepted"] == s["completed"] > 0
        assert s["outstanding"] == 0
    else:
        t = got.stats["train"]
        assert t["state"] == "done" and t["gang_losses"] > 0
        assert t["acked_epoch"] == t["epochs_committed"] > 0


@pytest.mark.parametrize("campaign", PORT.campaign.CAMPAIGNS)
def test_every_archetype_hashes_as_the_reference(campaign):
    assert PORT.campaign.CAMPAIGNS == REF.campaign.CAMPAIGNS
    want, got = _both(lambda m: m.sim.run_campaign(
        48, seed=11, campaign=campaign, faults=8, duration=200.0))
    assert got.trace_hash == want.trace_hash
    assert _result(got) == _result(want)
    assert got.ok, (campaign, got.violations)
    assert got.jobs_completed == got.jobs_acked


def test_64_node_campaign_replays_bit_for_bit():
    kw = dict(seed=7, campaign="mixed", faults=12, duration=240.0)
    want = REF.sim.run_campaign(64, **kw)
    r1 = PORT.sim.run_campaign(64, **kw)
    r2 = PORT.sim.run_campaign(64, **kw)
    assert r1.ok, r1.violations
    assert r1.trace_hash == r2.trace_hash == want.trace_hash
    assert r1.events_fired == r2.events_fired == want.events_fired
    assert r1.invariant_checks == want.invariant_checks > 0
    assert r1.jobs_completed == r1.jobs_acked > 0
    assert r1.faults_injected >= 12


def test_different_seeds_diverge():
    kw = dict(campaign="mixed", faults=8, duration=200.0)
    h = [PORT.sim.run_campaign(64, seed=s, **kw).trace_hash
         for s in (1, 2)]
    assert h[0] != h[1]
    assert h[1] == REF.sim.run_campaign(64, seed=2, **kw).trace_hash


def test_events_equal_the_reference_one_by_one():
    """Where a hash differs, the first differing event names the module:
    here every event of a 64-node mixed campaign with the lease plane
    and the standby on is the reference's."""
    def events(m):
        params = replace(m.cluster.SimParams.from_config(),
                         lease_plane=True, standby=True)
        with m.cluster.SimCluster(64, seed=5, params=params) as c:
            driver = c.transport.connect(m.cluster.HEAD_ADDR,
                                         _sim_src="driver")
            c.clock.run_until(10.0)
            for k in range(6):
                driver.call("job_submit", f"j{k}",
                            {f"j{k}.t{i}": 4.0 for i in range(16)})
            c.clock.run_until(30.0)
            c.kill_head()
            c.clock.run_until(120.0)
            return c.trace.events, c.trace.hash()
    (ev_want, h_want), (ev_got, h_got) = _both(events)
    assert len(ev_got) == len(ev_want) > 10
    for a, b in zip(ev_want, ev_got):
        assert b == a
    assert h_got == h_want
    assert "standby_promote" in [e["kind"] for e in ev_got]


# -- inherited faults of the reference ---------------------------------------

def test_broadcast_storm_fault_is_inherited_at_34_nodes():
    """The smallest cluster at which the reference's broadcast_storm
    (seed 7, faults=50) leaves a live member without a replica."""
    want, got = _both(lambda m: m.sim.run_campaign(
        34, seed=7, campaign="broadcast_storm", faults=50))
    assert _result(got) == _result(want)
    assert got.violations == [
        "[final] [inv:bcast-live-replica @t=200.0] broadcast wave w13: "
        "1 live members without a replica"]


def test_broadcast_storm_fault_is_inherited_at_1000_nodes():
    r = PORT.sim.run_campaign(1000, seed=7, campaign="broadcast_storm",
                              faults=50)
    assert r.trace_hash == STORM_1000_HASH
    assert r.events_fired == STORM_1000_EVENTS
    assert r.violations == STORM_1000_VIOLATIONS
    assert PORT.invariants.violation_names(r.violations) == \
        {"bcast-live-replica"}


def test_serve_rolling_update_mixed_sessions_are_inherited():
    """At 48 nodes, seed 11 and the default 50 faults the reference's
    serve_rolling_update serves requests off their session's pinned
    version; the port does exactly the same."""
    want, got = _both(lambda m: m.sim.run_campaign(
        48, seed=11, campaign="serve_rolling_update"))
    assert _result(got) == _result(want)
    assert PORT.invariants.violation_names(got.violations) == \
        {"version-mixed-session"}


# -- trace artifacts cross between the packages --------------------------------

@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port_to_reference", "reference_to_port"])
def test_trace_artifact_replays_under_the_other(writer, reader, tmp_path):
    out = tmp_path / "trace.json"
    sched = [(20.0, "kill_node", {"node": "n00001"}),
             (40.0, "partition",
              {"pairs": [["sim://head", "sim://n00002"]]}),
             (55.0, "heal",
              {"pairs": [["sim://head", "sim://n00002"]]})]
    r = writer.sim.run_campaign(32, seed=5, campaign="rolling_kill",
                                faults=6, duration=180.0,
                                schedule=sched, out=str(out))
    doc = json.loads(out.read_text())
    assert doc["format"] == "ray_tpu-sim-trace/1"
    assert doc["result"]["trace_hash"] == r.trace_hash
    assert doc["events_total"] == len(doc["events"])
    assert doc["events"][0]["kind"] == "cluster_start"
    assert doc["params"]["heartbeat_period_s"] == \
        doc["knobs"]["sim_heartbeat_period_s"]
    assert doc["knobs"] == reader.campaign.knob_snapshot()
    rp = doc["replay"]
    out2 = tmp_path / "replayed.json"
    r2 = reader.sim.run_campaign(
        rp["nodes"], seed=rp["seed"], campaign=rp["campaign"],
        faults=rp["faults"], duration=rp["duration"],
        schedule=[(t, op, kw) for t, op, kw in rp["schedule"]],
        params=reader.cluster.SimParams(**doc["params"]), out=str(out2))
    assert r2.trace_hash == r.trace_hash
    doc2 = json.loads(out2.read_text())
    for d in (doc, doc2):
        d["result"].pop("wall_s")
        d["result"].pop("events_per_sec")
    assert doc2 == doc


def test_verify_replay_mismatch_prints_hashes_and_fails(monkeypatch,
                                                        capsys):
    hashes = itertools.count()

    def fake_run_campaign(*a, **kw):
        return PORT.campaign.CampaignResult(
            nodes=8, seed=0, campaign="mixed", faults_injected=1,
            jobs_acked=1, jobs_completed=1, events_fired=10,
            invariant_checks=5, violations=[],
            trace_hash=f"deadbeef{next(hashes)}")

    monkeypatch.setattr(PORT.sim, "run_campaign", fake_run_campaign)
    args = argparse.Namespace(
        nodes=8, seed=0, campaign="mixed", faults=1, duration=60.0,
        no_autoscale=False, out=None, verify_replay=True)
    assert PORT.cli.cmd_simulate(args) == 1
    cap = capsys.readouterr()
    assert "deadbeef0" in cap.err and "deadbeef1" in cap.err
    summary = json.loads(cap.out)
    assert summary["replay_matches"] is False
    assert any("replay hash mismatch" in v for v in summary["violations"])


def test_cli_simulate_prints_the_reference_summary(capsys):
    def run(m):
        args = argparse.Namespace(
            nodes=16, seed=3, campaign="partitions", faults=4,
            duration=120.0, no_autoscale=False, out=None,
            verify_replay=True)
        rc = m.cli.cmd_simulate(args)
        summary = json.loads(capsys.readouterr().out)
        summary.pop("wall_s")
        summary.pop("events_per_sec")
        return rc, summary
    want, got = _both(run)
    assert got == want
    assert got[0] == 0 and got[1]["replay_matches"] is True


def test_campaign_violation_report_is_self_describing():
    sched = [(30.0, "partition",
              {"pairs": [["sim://head", "sim://n00001"],
                         ["sim://n00001", "sim://head"]]}),
             (45.0, "kill_node", {"node": "n00002"})]

    def run(m):
        return m.sim.run_campaign(
            8, seed=3, campaign="mixed", faults=4, duration=120.0,
            schedule=sched, params=replace(
                m.cluster.SimParams.from_config(), canary=True))
    want, got = _both(run)
    assert _result(got) == _result(want)
    assert "job-incomplete" in PORT.invariants.violation_names(
        got.violations)
    for v in got.violations:
        assert re.search(r"\[inv:[a-z0-9-]+ @t=\d+", v), v


# -- recovery scenarios ---------------------------------------------------------

def _head_kill_mid_job(m):
    with m.cluster.SimCluster(8, seed=1) as c:
        driver = c.transport.connect(m.cluster.HEAD_ADDR,
                                     _sim_src="driver")
        c.clock.run_until(10.0)
        assert driver.call("job_submit", "j1",
                           {f"j1.t{i}": 12.0 for i in range(6)}) == "ack"
        c.clock.run_until(14.0)
        c.kill_head()
        with pytest.raises(m.client.RpcConnectionError):
            driver.call("ping")
        c.clock.run_until(30.0)
        c.start_head()
        c.clock.run_until(180.0)
        kinds = [e["kind"] for e in c.trace.events]
        return (c.head.jobs["j1"]["status"], "head_restore" in kinds,
                m.invariants.check_invariants(c, ["j1"], strict=True),
                c.trace.hash())


def _node_kill_requeues(m):
    with m.cluster.SimCluster(4, seed=3) as c:
        driver = c.transport.connect(m.cluster.HEAD_ADDR,
                                     _sim_src="driver")
        c.clock.run_until(10.0)
        assert driver.call("job_submit", "j1",
                           {f"j1.t{i}": 15.0 for i in range(8)}) == "ack"
        c.clock.run_until(12.0)
        assert c.kill_node("n00001")
        c.clock.run_until(240.0)
        kinds = [e["kind"] for e in c.trace.events]
        return (c.head.jobs["j1"]["status"], "node_dead" in kinds,
                m.invariants.check_invariants(c, ["j1"], strict=True),
                c.trace.hash())


def _partition_quarantine_heal(m):
    head_addr = m.cluster.HEAD_ADDR
    with m.cluster.SimCluster(4, seed=2) as c:
        driver = c.transport.connect(head_addr, _sim_src="driver")
        c.clock.run_until(10.0)
        c.chaos.partitions.add((head_addr, "sim://n00001"))
        for k in range(10):
            driver.call("job_submit", f"j{k}",
                        {f"j{k}.t{i}": 6.0 for i in range(4)})
        c.clock.run_until(120.0)
        ev = [(e["kind"], e.get("node")) for e in c.trace.events]
        row = dict(c.head.nodes["n00001"])
        mid = (("quarantine", "n00001") in ev,
               "node_dead" in [k for k, _ in ev],
               row["state"], bool(row["suspect"]))
        c.chaos.partitions.clear()
        c.clock.run_until(240.0)
        ev = [(e["kind"], e.get("node")) for e in c.trace.events]
        acked = [f"j{k}" for k in range(10)]
        return (mid, ("unquarantine", "n00001") in ev,
                bool(c.head.nodes["n00001"]["suspect"]),
                m.invariants.check_invariants(c, acked, strict=True),
                c.trace.hash())


def _drain_converges(m):
    with m.cluster.SimCluster(4, seed=4) as c:
        driver = c.transport.connect(m.cluster.HEAD_ADDR,
                                     _sim_src="driver")
        c.clock.run_until(10.0)
        driver.call("job_submit", "j1",
                    {f"j1.t{i}": 8.0 for i in range(8)})
        c.clock.run_until(12.0)
        assert c.head.start_drain("n00002", "test")
        c.clock.run_until(120.0)
        ev = [(e["kind"], e.get("node")) for e in c.trace.events]
        return (("drain_start", "n00002") in ev,
                ("node_removed", "n00002") in ev,
                c.nodes["n00002"].alive, c.head.jobs["j1"]["status"],
                m.invariants.check_invariants(c, ["j1"], strict=True),
                c.trace.hash())


@pytest.mark.parametrize("scenario,expect", [
    (_head_kill_mid_job, ("succeeded", True)),
    (_node_kill_requeues, ("succeeded", True)),
    (_partition_quarantine_heal,
     ((True, False, "alive", True), True, False)),
    (_drain_converges, (True, True, False, "succeeded")),
], ids=lambda x: getattr(x, "__name__", ""))
def test_recovery_scenario_as_the_reference(scenario, expect):
    want, got = _both(scenario)
    assert got == want
    *facts, (violations, checks), _hash = got
    assert tuple(facts) == expect
    assert violations == [] and checks > 0


# -- the hunt ------------------------------------------------------------------

CANARY_KW = dict(nodes=24, seed=3, faults=40, duration=200.0,
                 campaigns=("mixed", "partitions"))


def _canary(m):
    return replace(m.cluster.SimParams.from_config(), canary=True)


def test_genomes_and_keys_equal_the_reference():
    def run(m):
        gs = m.hunt.seed_genomes(24, 7, 8, 100.0)
        g = gs[0]
        g2 = m.hunt.Genome.from_dict(json.loads(json.dumps(g.to_dict())))
        assert g2.key() == g.key()
        return [(x.canonical(), x.key()) for x in gs]
    want, got = _both(run)
    assert got == want
    assert len(got) == len(PORT.campaign.CAMPAIGNS)


def test_mutator_sequence_equals_the_reference():
    def run(m):
        corpus = m.hunt.seed_genomes(24, 1, 8, 100.0,
                                     campaigns=("mixed", "partitions"))
        mut = m.hunt.Mutator(42, 24)
        out = []
        for _ in range(12):
            g = mut.mutate(mut.pick_parent(corpus), corpus,
                           hot_times=(40.0, 60.0))
            times = [t for t, _, _ in g.ops]
            assert times == sorted(times)
            out.append((g.canonical(), g.mutation))
        return out
    want, got = _both(run)
    assert got == want


def test_coverage_sink_never_perturbs_the_trace_hash():
    def run(m):
        g = m.hunt.seed_genomes(24, 4, 6, 100.0, campaigns=("mixed",))[0]
        bare = m.hunt.run_genome(g)
        cov = m.hunt.RunCoverage()
        observed = m.hunt.run_genome(g, coverage=cov)
        assert bare.trace_hash == observed.trace_hash
        return bare.trace_hash, sorted(map(repr, cov.keys)), cov.hot_times
    want, got = _both(run)
    assert got == want


@pytest.mark.parametrize("items,need", [
    (12, {3, 7}), (16, {2, 9, 13}), (8, {1})])
def test_ddmin_equals_the_reference(items, need):
    def run(m):
        calls = []

        def probe(xs):
            calls.append(tuple(xs))
            return need <= set(xs)
        mini, stats = m.minimize.ddmin(list(range(items)), probe)
        assert len(calls) == len(set(calls))
        return mini, stats, calls
    want, got = _both(run)
    assert got == want
    assert set(got[0]) == need


def test_ddmin_rejects_passing_input():
    with pytest.raises(ValueError):
        PORT.minimize.ddmin([1, 2, 3], lambda xs: False)


def _hunt_report(r):
    d = r.to_dict()
    for f in d["findings"]:
        f.pop("artifact")
        f.pop("repro")
    return d


def test_hunt_finds_what_the_reference_finds():
    kw = dict(budget=6, nodes=24, seed=1, faults=12, duration=120.0,
              campaigns=("mixed", "rolling_kill"))
    want, got = _both(lambda m: m.hunt.hunt(**kw))
    assert _hunt_report(got) == _hunt_report(want)
    assert got.runs == 6 and got.coverage > 0


def test_hunt_without_canary_is_clean_at_smoke_budget():
    kw = dict(budget=8, nodes=24, seed=7, faults=16, duration=140.0,
              campaigns=("mixed", "drain_churn"))
    want, got = _both(lambda m: m.hunt.hunt(**kw))
    assert _hunt_report(got) == _hunt_report(want)
    assert got.findings == [] and got.runs == 8


def test_canary_findings_cross_between_the_packages(tmp_path):
    """The planted canary is found, minimized and written by both
    packages alike, and each package's finding artifact reproduces
    under the other's ``replay_finding`` with the same hash."""
    found = {}
    for m in (REF, PORT):
        r = m.hunt.hunt(budget=12, params=_canary(m),
                        out_dir=str(tmp_path / m.pkg), **CANARY_KW)
        f = next(x for x in r.findings
                 if x.signature == ("job-incomplete",))
        assert len(f.minimized.ops) <= max(2, len(f.genome.ops) // 10)
        found[m.pkg] = (_hunt_report(r), f)
    (rep_ref, f_ref), (rep_port, f_port) = found["ray_tpu"], \
        found["ray_tpu_torch"]
    assert rep_port == rep_ref
    for f, reader in ((f_port, REF), (f_ref, PORT)):
        doc = reader.hunt.load_finding(f.artifact)
        assert doc["format"] == "ray_tpu-hunt-finding/1"
        res, reproduced = reader.hunt.replay_finding(doc)
        assert reproduced and res.trace_hash == f.trace_hash


def test_object_copies_regression_artifact_no_longer_reproduces():
    doc = PORT.hunt.load_finding(os.path.join(
        DATA, "hunt_finding_object_copies_r16.json"))
    assert doc["signature"] == ["object-copies"]
    res, reproduced = PORT.hunt.replay_finding(doc)
    want, _ = REF.hunt.replay_finding(doc)
    assert not reproduced
    assert res.ok, res.violations
    assert res.trace_hash == want.trace_hash


# -- invariants: fire on corrupted state, quiet on a healthy one ---------------

class _StubWave:
    """Duck-typed stand-in for ``SimBroadcastWave``: the surface the
    invariant checkers read."""

    def __init__(self, wave_id="w0", members=("a", "b", "c"), root="a",
                 parent_of=None, t_done=None, terminal=True,
                 unreached=()):
        self.wave_id = wave_id
        self.members = list(members)
        self.root = root
        self.parent_of = dict(parent_of or {})
        self.t_done = t_done
        self.terminal = terminal
        self._unreached = list(unreached)

    def _alive(self, nid):
        return True

    def unreached_live(self):
        return list(self._unreached)


def _healthy_cluster(m):
    """Every checker active and quiet: a completed job, the lease plane
    on, balanced serve counters, a sealed and an in-flight rollout, a
    quiet training plane, legal revocation history, one finished and
    one in-flight acyclic broadcast wave."""
    c = m.cluster.SimCluster(4, seed=1, params=replace(
        m.cluster.SimParams.from_config(), lease_plane=True))
    c.__enter__()
    driver = c.transport.connect(m.cluster.HEAD_ADDR, _sim_src="driver")
    c.clock.run_until(10.0)
    assert driver.call("job_submit", "j1",
                       {f"j1.t{i}": 5.0 for i in range(4)}) == "ack"
    c.clock.run_until(80.0)
    assert c.head.jobs["j1"]["status"] == "succeeded"

    plane = m.serve.SimServePlane(c, seed=0, duration=50.0)
    plane.started = True
    plane.accepted = plane.completed = 2
    plane.loans_total = plane.reclaims_total = 1
    c.serve_plane = plane

    rplane = m.rollout.SimRolloutPlane(c, plane)

    def _ro(rid, frm, to, phase, t_done):
        return {"id": rid, "from": frm, "to": to, "phase": phase,
                "flipped": 1, "replicas": 2, "old_retained": True,
                "probe_fail_at": -1, "t_start": 1.0, "t_done": t_done,
                "error": "", "pre_p99_s": 0.1, "during_p99_s": 0.1}

    rplane.rollouts = [_ro("r2", "v1", "v2", "SEALED", 4.0),
                       _ro("r3", "v2", "v3", "FLIPPING", None)]
    rplane.active = rplane.rollouts[1]

    tplane = m.train.SimTrainPlane(c, duration=50.0, serve=plane)
    tplane.started = True
    tplane.state = "forming"
    tplane.acked_epoch = tplane._hwm_epoch = 2
    tplane.epochs_committed = 2
    tplane.samples_committed = 256
    tplane.ckpts[2] = {"copies": {"n00001", "n00002"}, "t_write": 5.0,
                       "t_degraded": None, "acked": True, "repl": 0}
    c.persist["train"] = {"epoch": 2, "samples": 256, "gang": 2}
    c.train_plane = tplane

    c.revocation_log["n00003"] = [(1, 5.0), (2, 6.0)]
    c.broadcast_waves = [
        _StubWave("w0", t_done=5.0, terminal=True),
        _StubWave("w1", t_done=None, terminal=False,
                  parent_of={"b": "a", "c": "b"}),
    ]
    return c, ["j1"]


def _now(c):
    return c.clock.monotonic()


def _finish_waves(c):
    """The campaign's quiesce: waves, rollouts and the run wrap up."""
    for w in c.broadcast_waves:
        if w.t_done is None:
            w.t_done, w.terminal = _now(c), True
    rp = getattr(c, "rollout_plane", None)
    if rp is not None:
        for ro in rp.rollouts:
            if ro["phase"] not in ("SEALED", "ROLLED_BACK"):
                ro["phase"], ro["t_done"] = "SEALED", _now(c)
        rp.active = None
        rp.queued.clear()
    tp = getattr(c, "train_plane", None)
    if tp is not None and tp.state != "done":
        tp.state = "done"
        tp.gang = []
        tp.reserved.clear()
        tp.borrowed = []
        tp._pending_borrows = []


def _lease_stuck(c, acked, m):
    t = c.head.tasks["j1.t0"]
    t["state"], t["node"] = "running", "n00001"
    t["granted_at"] = _now(c) - 100.0
    c.head.nodes["n00001"]["running"]["j1.t0"] = True


def _drain_stuck(c, acked, m):
    row = c.head.nodes["n00001"]
    row["state"] = "draining"
    row["drain_started"] = _now(c) - 1000.0


def _lineage_hole(c, acked, m):
    c.head.jobs["j1"]["status"] = "running"
    c.head.objects[c.head.tasks["j1.t0"]["oid"]]["copies"].clear()


def _job_incomplete(c, acked, m):
    c.head.jobs["j1"]["status"] = "running"
    t = c.head.tasks["j1.t1"]
    t["state"], t["node"] = "pending", None


def _lock_order_cycle(c, acked, m):
    m.lockorder.install()
    m.lockorder._edges[("siteA:1", "siteB:2")] = 1
    m.lockorder._edges[("siteB:2", "siteA:1")] = 1


def _loan_drain_stuck(c, acked, m):
    p = c.serve_plane
    p.loans["n00001"] = {"state": "draining", "t0": 0.0,
                         "t_drain": _now(c) - 1000.0}
    p.loans_total += 1


def _serve_incomplete(c, acked, m):
    p = c.serve_plane
    p.accepted += 1
    p.outstanding += 1
    p.shards[0].queue.append((99, 0.0))


def _loans_outstanding(c, acked, m):
    p = c.serve_plane
    p.loans["n00001"] = {"state": "active", "t0": 0.0, "t_drain": 0.0}
    p.loans_total += 1


def _lease_double_exec(c, acked, m):
    c.revocation_log["n00002"] = [(5, 10.0)]
    c.exec_log.append(("ghost-task", "n00002", 4, _now(c)))


def _object_copies(c, acked, m):
    oid = c.head.tasks["j1.t0"]["oid"]
    c.head.objects[oid]["copies"]["n00002"] = True
    c.head.nodes["n00002"]["state"] = "removed"


def _budget_conservation(c, acked, m):
    nid = "n00001"
    ep = c.head.grantor.epoch(nid)
    c.head.grantor.grant(nid, "CPU:100", 2)
    c.nodes[nid].lease.install({"CPU:100": 2}, ep)
    c.nodes[nid].lease._classes["CPU:100"][1] = 3


def _bcast_live_replica(c, acked, m):
    _finish_waves(c)
    c.broadcast_waves.append(_StubWave(
        "w-gap", t_done=6.0, terminal=True, unreached=("b",)))


def _noop(c, acked, m):
    """strict final with the in-flight wave, rollout or run still not
    terminal"""


def _bump(obj, attr, by):
    def corrupt(c, acked, m):
        o = getattr(c, obj)
        setattr(o, attr, getattr(o, attr) + by)
    return corrupt


CORRUPTIONS = {   # name -> (corrupt(cluster, acked, mods), strict)
    "acked-job-lost": (lambda c, acked, m: acked.append("ghost-job"),
                       False),
    "lease-stuck": (_lease_stuck, False),
    "leased-quiet": (lambda c, acked, m: c.head.nodes["n00001"][
        "leased"].__setitem__("j1.t0", _now(c) - 100.0), False),
    "drain-stuck": (_drain_stuck, False),
    "lineage-hole": (_lineage_hole, True),
    "job-incomplete": (_job_incomplete, True),
    "lock-order-cycle": (_lock_order_cycle, False),
    "serve-accounting": (_bump("serve_plane", "outstanding", 3), False),
    "serve-conservation": (_bump("serve_plane", "accepted", 3), False),
    "loan-drain-stuck": (_loan_drain_stuck, False),
    "loan-conservation": (_bump("serve_plane", "loans_total", 1), False),
    "serve-incomplete": (_serve_incomplete, True),
    "loans-outstanding": (_loans_outstanding, True),
    "lease-double-exec": (_lease_double_exec, False),
    "object-copies": (_object_copies, False),
    "bcast-reparent-cycle": (lambda c, acked, m: c.broadcast_waves.append(
        _StubWave("w-cyc", t_done=None, terminal=False,
                  parent_of={"b": "c", "c": "b"})), False),
    "revocation-epoch-monotonic": (
        lambda c, acked, m: c.revocation_log.__setitem__(
            "n00001", [(3, 1.0), (3, 2.0)]), False),
    "bcast-wave-terminal": (_noop, True),
    "bcast-live-replica": (_bcast_live_replica, True),
    "budget-conservation": (_budget_conservation, False),
    "version-mixed-session": (_bump("rollout_plane", "mixed_served", 1),
                              False),
    "rollout-terminal": (_noop, True),
    "old-version-retained": (
        lambda c, acked, m: c.rollout_plane.active.__setitem__(
            "old_retained", False), False),
    "goodput-accounting": (_bump("train_plane", "samples_committed", 64),
                           False),
    "ckpt-durable": (lambda c, acked, m: c.train_plane.ckpts[2].__setitem__(
        "copies", {"n-gone"}), False),
    "gang-terminal": (_noop, True),
}
_NOT_FINISHED = ("bcast-wave-terminal", "rollout-terminal",
                 "gang-terminal")


def test_every_invariant_has_a_twin():
    assert set(PORT.invariants.INVARIANTS) == \
        set(REF.invariants.INVARIANTS) == set(CORRUPTIONS)


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_invariant_fires_as_the_reference(name):
    corrupt, strict = CORRUPTIONS[name]

    def run(m):
        c, acked = _healthy_cluster(m)
        try:
            corrupt(c, acked, m)
            if strict and name not in _NOT_FINISHED:
                _finish_waves(c)
            return m.invariants.check_invariants(c, acked, strict=strict)
        finally:
            if name == "lock-order-cycle":
                m.lockorder.reset()
                m.lockorder.uninstall()
            c.close()
    want, got = _both(run)
    assert got == want
    v, checks = got
    assert name in PORT.invariants.violation_names(v), (name, v)
    assert any(f"[inv:{name} @t=" in msg for msg in v)
    assert checks > 0


@pytest.mark.parametrize("strict", [False, True], ids=["live", "final"])
def test_invariants_quiet_on_a_healthy_cluster(strict):
    def run(m):
        c, acked = _healthy_cluster(m)
        try:
            if strict:
                _finish_waves(c)
            return m.invariants.check_invariants(c, acked, strict=strict)
        finally:
            c.close()
    want, got = _both(run)
    assert got == want
    assert got[0] == [] and got[1] > 0


# -- the lease plane, the broadcast wave and rollouts in the simulator --------

def test_dispatch_comparison_equals_the_reference():
    kw = dict(num_nodes=200, jobs=120, tasks_per_job=8, seed=0)
    want, got = _both(
        lambda m: m.dispatch.run_dispatch_comparison(**kw))
    for rec in (want, got):
        for side in ("lease", "head_only"):
            rec[side].pop("wall_s", None)
    assert got == want
    assert got["speedup"] >= 2.0
    assert got["lease"]["lease_hit_rate"] >= 0.9
    assert got["lease"]["jobs_completed"] == \
        got["head_only"]["jobs_completed"] == 120


def test_head_kill_promotes_standby_within_heartbeat():
    kw = dict(num_nodes=200, jobs=120, tasks_per_job=8, seed=0,
              lease_plane=True, standby=True, kill_head_at=20.0,
              heartbeat_period_s=5.0)
    want, got = _both(lambda m: m.dispatch.run_dispatch_storm(**kw))
    got.pop("wall_s", None)
    want.pop("wall_s", None)
    assert got == want
    assert got["promotions"] == 1 and got["jobs_completed"] == 120
    assert got["failover_ms"] and got["failover_ms"][0] <= 5000.0


def test_failover_storm_campaign_with_promotions():
    kw = dict(seed=0, campaign="head_failover_storm", faults=10,
              duration=120.0, autoscale=False)
    want, got = _both(lambda m: m.sim.run_campaign(48, **kw))
    assert _result(got) == _result(want)
    assert got.ok, got.violations
    assert got.stats["leasing"]["promotions"] >= 1


def _wave(m, num_nodes, seed, **kw):
    kills = kw.pop("kills", ())
    with m.cluster.SimCluster(num_nodes, seed=seed) as c:
        members = [f"n{i:05d}" for i in range(num_nodes)]
        w = m.broadcast.SimBroadcastWave(c, "w0", members, **kw)
        w.start()
        for t, nid in kills:
            c.clock.call_later(t, lambda nid=nid: (
                c.kill_node(nid), w.on_node_killed(nid)))
        c.clock.run_until(300.0)
        return (c.trace.hash(), w.time_to_all, sorted(w.completed),
                sorted(w.unreachable), w.reparents, w.terminal,
                dict(w.have), w.nchunks)


def test_1k_node_wave_equals_the_reference():
    kw = dict(size_mb=1024, chunk_mb=8, fanout=2, uplink_mbps=1000.0)
    want, got = _both(lambda m: _wave(m, 1000, 3, **dict(kw)))
    assert got == want
    _h, time_to_all, completed, unreachable, *_ = got
    assert len(completed) == 1000 and not unreachable
    assert time_to_all < 1000 * 1024 / 1000.0 / 50


def test_mid_tree_kills_reparent_as_the_reference():
    kw = dict(size_mb=256, chunk_mb=8, fanout=2,
              kills=((0.3, "n00000"), (0.6, "n00001")))
    want, got = _both(lambda m: _wave(m, 64, 11, **dict(kw)))
    assert got == want
    _h, _t, completed, _u, reparents, terminal, have, nchunks = got
    assert terminal and reparents >= 1 and len(completed) == 62
    assert all(have[n] == nchunks for n in completed)


def test_broadcast_storm_campaign_green_and_as_the_reference():
    kw = dict(seed=7, campaign="broadcast_storm", faults=12,
              duration=200.0)
    want, got = _both(lambda m: m.sim.run_campaign(48, **kw))
    assert _result(got) == _result(want)
    assert got.ok, got.violations


def test_rollout_schedule_replays_as_the_reference():
    sched = [(60.0, "rollout", {"artifact": "w-001",
                                "probe_fail_at": -1}),
             (95.0, "rollout", {"artifact": "w-002",
                                "probe_fail_at": 0})]
    kw = dict(seed=7, campaign="serve_rolling_update", faults=0,
              duration=130.0, schedule=sched)
    want, got = _both(lambda m: m.sim.run_campaign(40, **kw))
    assert _result(got) == _result(want)
    assert got.ok, got.violations
    ro = got.stats["rollout"]
    assert ro["sealed"] == 1 and ro["rolled_back"] == 1
    assert ro["per_rollout"][1]["phase"] == PORT.phases.ROLLED_BACK
    assert ro["serving"] == "v2" and ro["mixed_served"] == 0


def test_generated_rollout_campaign_under_chaos():
    kw = dict(seed=3, campaign="serve_rolling_update", faults=12,
              duration=150.0)
    want, got = _both(lambda m: m.sim.run_campaign(120, **kw))
    assert _result(got) == _result(want)
    assert got.ok, got.violations
    ro = got.stats["rollout"]
    assert ro["rollouts"] >= 1 and ro["mixed_served"] == 0
    assert ro["sealed"] + ro["rolled_back"] == ro["rollouts"]

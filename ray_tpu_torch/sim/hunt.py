"""Coverage-guided adversarial campaign search over the simulator.

``simulate`` replays a hand-scripted archetype; ``hunt`` *searches*.
A fault schedule is a first-class, serializable genome — typed fault
ops over nodes/links/head/standby/loans/drains with virtual-clock
timestamps — and because a campaign is a pure function of
``(nodes, seed, campaign, faults, duration, schedule)``, any genome
replays bit-identically.  The hunt mutates genomes under one seeded
Philox stream (splice, retime, retarget, drop, duplicate, insert,
densify-around-prior-near-misses), keeps the ones that reach new
coverage, and on any invariant violation delta-debugs the failing
schedule with :func:`minimize.ddmin` down to a 1-minimal genome,
emitting a ``ray_tpu-hunt-finding/1`` artifact with the minimized
genome, its trace hash and a repro command
(``ray_tpu_torch hunt --repro <artifact>``).

The coverage signal is cheap by construction: a :class:`RunCoverage`
sink attached to the trace observes every event (including past the
storage cap) but never feeds the replay hash, so instrumented and
uninstrumented runs share fingerprints.  Coverage keys are invariant-
check sites reached plus state-machine edges exercised — lease epoch
bumps, broadcast re-parent depth, loan/reclaim phases, standby
promotion gates, node life-cycle transitions.

Everything here draws from Philox streams keyed by the hunt seed: the
same ``(seed, budget, nodes)`` finds the same failures in the same
order.  No wall-clock reads — callers time the hunt themselves.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field, fields, replace

from .campaign import (CAMPAIGNS, build_schedule, knob_snapshot,
                       run_campaign)
from .cluster import SimParams
from .invariants import violation_names
from .minimize import ddmin

__all__ = ["Genome", "RunCoverage", "Mutator", "HuntFinding",
           "HuntResult", "hunt", "seed_genomes", "run_genome",
           "minimize_genome", "load_finding", "replay_finding",
           "FINDING_FORMAT"]

FINDING_FORMAT = "ray_tpu-hunt-finding/1"

# Philox lane for mutation draws, distinct from the campaign stream
_HUNT_KEY = 0x48554E54             # "HUNT"

_MUTATIONS = ("retime", "retarget", "drop", "duplicate", "insert",
              "splice", "densify")

# ops that carry a node-id / link-addr target (retarget candidates)
_NODE_OPS = ("kill_node", "drain")
_ADDR_OPS = ("gray_slow", "gray_heal")


# ---------------------------------------------------------------------------
# genome


@dataclass
class Genome:
    """One fault schedule plus the base args that derive its job load.

    ``ops`` is ``[(t, op, kwargs), ...]`` in virtual seconds — exactly
    the ``schedule`` override :func:`campaign.run_campaign` accepts.
    The base ``(nodes, seed, campaign, faults, duration)`` tuple pins
    the background job schedule (job draws precede fault draws on the
    campaign Philox stream), so a genome replays bit-identically
    regardless of how far its ops have mutated from the archetype."""

    nodes: int
    seed: int
    campaign: str
    faults: int
    duration: float
    ops: list = field(default_factory=list)
    parent: str | None = None       # key() of the mutated-from genome
    mutation: str | None = None     # "+"-joined mutation kinds applied

    def canonical(self) -> dict:
        # kwargs pass through JSON so in-memory tuples (partition
        # pair lists) and their round-tripped list forms are identical
        return {
            "nodes": self.nodes, "seed": self.seed,
            "campaign": self.campaign, "faults": self.faults,
            "duration": self.duration,
            "ops": [[round(float(t), 6), op,
                     json.loads(json.dumps(kw))]
                    for t, op, kw in self.ops],
        }

    def key(self) -> str:
        """Short content hash — corpus identity and artifact naming."""
        blob = json.dumps(self.canonical(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def to_dict(self) -> dict:
        doc = self.canonical()
        if self.parent:
            doc["parent"] = self.parent
        if self.mutation:
            doc["mutation"] = self.mutation
        return doc

    @classmethod
    def from_dict(cls, doc: dict) -> "Genome":
        return cls(nodes=int(doc["nodes"]), seed=int(doc["seed"]),
                   campaign=doc["campaign"], faults=int(doc["faults"]),
                   duration=float(doc["duration"]),
                   ops=[(float(t), op, dict(kw))
                        for t, op, kw in doc["ops"]],
                   parent=doc.get("parent"),
                   mutation=doc.get("mutation"))


def seed_genomes(nodes: int, seed: int, faults: int, duration: float,
                 campaigns=None) -> list:
    """The hand-scripted archetypes as seed genomes: each campaign's
    deterministic fault schedule, lifted into an explicit ops list the
    mutator can splice across archetype boundaries."""
    import numpy as np

    out = []
    for campaign in (campaigns or CAMPAIGNS):
        rng = np.random.Generator(np.random.Philox(
            key=[int(seed) & (2 ** 64 - 1), 0xC0FFEE]))
        _jobs, sched = build_schedule(campaign, rng, nodes, faults,
                                      duration)
        # times rounded to the canonical 6dp at creation, so the
        # in-memory schedule and its JSON round-trip replay identically
        ops = [(round(float(t), 6), op, kw) for t, op, kw in sched]
        out.append(Genome(nodes=nodes, seed=seed, campaign=campaign,
                          faults=faults, duration=duration, ops=ops))
    return out


def run_genome(genome: Genome, params: SimParams | None = None,
               coverage=None, out: str | None = None):
    """One deterministic sim run of a genome; returns the
    :class:`campaign.CampaignResult`."""
    return run_campaign(genome.nodes, seed=genome.seed,
                        campaign=genome.campaign, faults=genome.faults,
                        duration=genome.duration, params=params,
                        schedule=genome.ops, coverage=coverage, out=out)


# ---------------------------------------------------------------------------
# coverage


def _bucket(n: int) -> int:
    """Log2 bucket, capped — depth-ish signals stay low-cardinality."""
    return min(max(int(n), 0).bit_length(), 8)


class RunCoverage:
    """Coverage sink for one run, attached via ``Trace.cov``.

    ``keys`` is the run's coverage set: invariant-check sites reached,
    fault ops actually applied, state-machine edges exercised (lease
    epoch bumps bucketed log2, broadcast re-parent volume, loan and
    reclaim phases, promotion/restore gates, node life-cycle).
    ``hot_times`` collects virtual timestamps where something
    interesting happened — mid-run violations, node deaths, standby
    promotions — the mutator's densify target list."""

    _EDGE_KINDS = frozenset((
        "node_dead", "node_removed", "drain_start", "quarantine",
        "unquarantine", "reconstruct", "scale_up", "head_restore",
        "standby_promote", "lease_requeued", "loan_started",
        "loan_reclaim_started", "loan_reclaimed", "loan_lost",
        "serve_replica_dead", "bcast_start", "bcast_complete",
    ))
    _HOT_KINDS = frozenset(("node_dead", "standby_promote"))
    _HOT_CAP = 64

    def __init__(self):
        self.keys: set = set()
        self.hot_times: list = []
        self._reparents = 0

    def note(self, ev: dict) -> None:
        kind = ev["kind"]
        if kind == "fault":
            self.keys.add(("fault", ev.get("op")))
        elif kind == "invariant_check":
            self.keys.add(("site", ev.get("stage")))
            if ev.get("violations"):
                self.keys.add(("violated", ev.get("stage")))
                self._hot(ev["t"])
        elif kind == "lease_revoked":
            self.keys.add(("epoch", _bucket(ev.get("epoch", 0))))
        elif kind == "bcast_reparent":
            self._reparents += 1
            self.keys.add(("reparent", _bucket(self._reparents)))
        elif kind in self._EDGE_KINDS:
            self.keys.add(("edge", kind))
            if kind in self._HOT_KINDS:
                self._hot(ev["t"])

    def _hot(self, t: float) -> None:
        if len(self.hot_times) < self._HOT_CAP:
            self.hot_times.append(float(t))


# ---------------------------------------------------------------------------
# mutation


class Mutator:
    """All schedule mutations, drawn from one Philox stream keyed by
    the hunt seed — the whole search replays from ``(seed, budget)``."""

    def __init__(self, seed: int, nodes: int):
        import numpy as np

        self._rng = np.random.Generator(np.random.Philox(
            key=[int(seed) & (2 ** 64 - 1), _HUNT_KEY]))
        self.nodes = nodes

    # -- draws ---------------------------------------------------------------
    def pick_parent(self, corpus: list) -> Genome:
        return corpus[int(self._rng.integers(0, len(corpus)))]

    def _node(self) -> str:
        return f"n{int(self._rng.integers(0, self.nodes)):05d}"

    def _time(self, duration: float) -> float:
        return round(float(self._rng.uniform(
            duration * 0.05, duration * 0.85)), 3)

    def _fresh_op(self, duration: float) -> list:
        """One new fault (plus its heal twin where the op has one) —
        the same vocabulary :func:`campaign.build_schedule` emits."""
        rng = self._rng
        kind = ("kill_node", "drain", "gray_slow", "partition",
                "kill_head", "broadcast")[int(rng.integers(0, 6))]
        t = self._time(duration)
        heal = round(float(rng.uniform(8.0, 25.0)), 3)
        if kind == "kill_node" or kind == "drain":
            return [(t, kind, {"node": self._node()})]
        if kind == "gray_slow":
            addr = f"sim://{self._node()}"
            return [(t, "gray_slow", {"addr": addr}),
                    (t + heal, "gray_heal", {"addr": addr})]
        if kind == "partition":
            addr = f"sim://{self._node()}"
            shape = int(rng.integers(0, 4))
            if shape == 0:
                pairs = [["sim://head", addr]]
            elif shape == 1:
                pairs = [[addr, "sim://head"]]
            elif shape == 2:
                pairs = [["sim://standby", "sim://head"]]
            else:
                pairs = [["sim://head", addr], [addr, "sim://head"]]
            return [(t, "partition", {"pairs": pairs}),
                    (t + heal, "heal", {"pairs": pairs})]
        if kind == "kill_head":
            return [(t, "kill_head", {}),
                    (t + heal, "restart_head", {})]
        count = int(rng.integers(2, max(3, self.nodes // 2)))
        rows = sorted(int(x) for x in rng.choice(
            self.nodes, size=min(count, self.nodes), replace=False))
        return [(t, "broadcast", {
            "members": [f"n{r:05d}" for r in rows],
            "size_mb": int(rng.integers(64, 1025)),
            "fanout": int(rng.integers(2, 5))})]

    # -- mutations -----------------------------------------------------------
    def mutate(self, genome: Genome, corpus: list,
               hot_times=()) -> Genome:
        rng = self._rng
        ops = [(float(t), op, dict(kw)) for t, op, kw in genome.ops]
        applied = []
        for _ in range(1 + int(rng.integers(0, 3))):
            kind = _MUTATIONS[int(rng.integers(0, len(_MUTATIONS)))]
            if kind == "densify" and not hot_times:
                kind = "insert"
            if kind in ("retime", "retarget", "drop", "duplicate") \
                    and not ops:
                kind = "insert"
            if kind == "retime":
                i = int(rng.integers(0, len(ops)))
                t, op, kw = ops[i]
                jitter = float(rng.normal(0.0, 12.0))
                t2 = min(max(t + jitter, 0.5),
                         genome.duration * 0.95)
                ops[i] = (round(t2, 3), op, kw)
            elif kind == "retarget":
                idx = [i for i, (_, op, kw) in enumerate(ops)
                       if op in _NODE_OPS or op in _ADDR_OPS
                       or op == "partition" or op == "heal"]
                if not idx:
                    continue
                i = idx[int(rng.integers(0, len(idx)))]
                t, op, kw = ops[i]
                nid = self._node()
                if op in _NODE_OPS:
                    kw = {"node": nid}
                elif op in _ADDR_OPS:
                    kw = {"addr": f"sim://{nid}"}
                else:               # partition/heal: rewrite node ends
                    addr = f"sim://{nid}"
                    kw = {"pairs": [
                        [addr if a.startswith("sim://n") else a,
                         addr if b.startswith("sim://n") else b]
                        for a, b in kw["pairs"]]}
                ops[i] = (t, op, kw)
            elif kind == "drop":
                del ops[int(rng.integers(0, len(ops)))]
            elif kind == "duplicate":
                t, op, kw = ops[int(rng.integers(0, len(ops)))]
                ops.append((self._time(genome.duration), op,
                            dict(kw)))
            elif kind == "insert":
                ops.extend(self._fresh_op(genome.duration))
            elif kind == "splice":
                donor = self.pick_parent(corpus)
                if donor.ops:
                    n = int(rng.integers(1, min(6, len(donor.ops) + 1)))
                    lo = int(rng.integers(
                        0, len(donor.ops) - n + 1))
                    ops.extend((float(t), op, dict(kw)) for t, op, kw
                               in donor.ops[lo:lo + n])
            else:                   # densify around a prior near-miss
                t0 = float(hot_times[int(rng.integers(
                    0, len(hot_times)))])
                for t, op, kw in self._fresh_op(genome.duration):
                    t2 = min(max(t0 + float(rng.uniform(-4.0, 4.0)),
                                 0.5), genome.duration * 0.95)
                    ops.append((round(t2, 3), op, kw))
            applied.append(kind)
        ops.sort(key=lambda e: e[0])
        return replace(genome, ops=ops, parent=genome.key(),
                       mutation="+".join(applied))


# ---------------------------------------------------------------------------
# minimization + findings


def minimize_genome(genome: Genome, signature,
                    params: SimParams | None = None,
                    progress=None) -> tuple:
    """ddmin the genome's ops to a 1-minimal schedule that still
    reproduces ``signature`` (every named invariant still fires — the
    minimized run may surface MORE, never fewer).  Returns
    ``(minimized_genome, stats)``."""
    sig = frozenset(signature)

    def still_fails(ops: list) -> bool:
        res = run_genome(replace(genome, ops=ops), params=params)
        return sig <= violation_names(res.violations)

    min_ops, stats = ddmin(genome.ops, still_fails, progress=progress)
    return (replace(genome, ops=min_ops, parent=genome.key(),
                    mutation="ddmin"), stats)


@dataclass
class HuntFinding:
    """One deduped failure signature with its minimized reproduction."""

    signature: tuple            # sorted invariant names that fired
    genome: Genome              # as found
    minimized: Genome           # after ddmin (== genome if not run)
    found_after_runs: int
    ddmin_probes: int
    violations: list            # from the minimized replay
    trace_hash: str             # fingerprint of the minimized replay
    artifact: str | None = None

    def to_dict(self) -> dict:
        return {
            "format": FINDING_FORMAT,
            "signature": list(self.signature),
            "found_after_runs": self.found_after_runs,
            "fault_ops": len(self.genome.ops),
            "minimized_ops": len(self.minimized.ops),
            "ddmin_probes": self.ddmin_probes,
            "genome": self.genome.to_dict(),
            "minimized": self.minimized.to_dict(),
            "violations": list(self.violations),
            "trace_hash": self.trace_hash,
            "knobs": knob_snapshot(),
            "params": None,     # filled by _write_finding
            "artifact": self.artifact,
            "repro": "ray_tpu_torch hunt --repro <this artifact>",
        }


@dataclass
class HuntResult:
    runs: int
    budget: int
    nodes: int
    seed: int
    findings: list = field(default_factory=list)
    coverage: int = 0
    coverage_keys: list = field(default_factory=list)
    corpus: int = 0
    new_cov_runs: int = 0

    def to_dict(self) -> dict:
        return {
            "runs": self.runs, "budget": self.budget,
            "nodes": self.nodes, "seed": self.seed,
            "findings": [f.to_dict() for f in self.findings],
            "signatures": [list(f.signature) for f in self.findings],
            "coverage": self.coverage,
            "coverage_keys": self.coverage_keys,
            "corpus": self.corpus,
            "new_cov_runs": self.new_cov_runs,
        }


def _write_finding(finding: HuntFinding, out_dir: str,
                   params: SimParams | None) -> str:
    import os

    path = os.path.join(out_dir,
                        f"finding-{finding.minimized.key()}.json")
    finding.artifact = path
    doc = finding.to_dict()
    doc["params"] = asdict(params or SimParams.from_config())
    doc["repro"] = f"ray_tpu_torch hunt --repro {path}"
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path


def load_finding(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("format") != FINDING_FORMAT:
        raise ValueError(f"{path}: not a {FINDING_FORMAT} artifact "
                         f"(format={doc.get('format')!r})")
    return doc


def replay_finding(doc: dict, out: str | None = None) -> tuple:
    """Replay a finding's minimized genome under the artifact's own
    knobs and params — reproduction is a pure function of the
    artifact.  Returns ``(result, reproduced)`` where ``reproduced``
    means the trace hash matched AND every signature invariant fired
    again."""
    from ..common.config import Config, get_config

    snapshot = get_config().to_dict()
    Config.reset(doc.get("knobs") or {})
    try:
        params = None
        if doc.get("params"):
            names = {f.name for f in fields(SimParams)}
            params = SimParams(**{k: v for k, v in doc["params"].items()
                                  if k in names})
        genome = Genome.from_dict(doc["minimized"])
        res = run_genome(genome, params=params, out=out)
    finally:
        Config.reset(snapshot)
    reproduced = (res.trace_hash == doc["trace_hash"] and
                  frozenset(doc["signature"]) <=
                  violation_names(res.violations))
    return res, reproduced


# ---------------------------------------------------------------------------
# the hunt


def hunt(budget: int = 120, nodes: int = 24, seed: int = 0,
         faults: int = 24, duration: float = 160.0,
         campaigns=None, params: SimParams | None = None,
         out_dir: str | None = None, minimize: bool = True,
         progress=None) -> HuntResult:
    """Coverage-guided search for invariant violations.

    Evaluates the archetype seed genomes, then spends the remaining
    ``budget`` on mutants of coverage-increasing corpus members.  Each
    distinct failure signature (the set of invariant names that fired)
    is recorded once, ddmin-minimized, and — when ``out_dir`` is set —
    written as a ``ray_tpu-hunt-finding/1`` artifact.  Deterministic:
    the same arguments replay the same search, finding for finding.
    """
    seeds = seed_genomes(nodes, seed, faults, duration,
                         campaigns=campaigns)
    mut = Mutator(seed, nodes)
    corpus: list = []
    global_cov: set = set()
    hot_times: list = []
    found_sigs: set = set()
    result = HuntResult(runs=0, budget=budget, nodes=nodes, seed=seed)

    while result.runs < budget:
        if result.runs < len(seeds):
            genome = seeds[result.runs]
        elif corpus:
            genome = mut.mutate(mut.pick_parent(corpus), corpus,
                                hot_times=hot_times)
        else:                   # every archetype crashed the signature
            genome = mut.mutate(seeds[result.runs % len(seeds)],
                                seeds, hot_times=hot_times)
        cov = RunCoverage()
        res = run_genome(genome, params=params, coverage=cov)
        result.runs += 1
        for t in cov.hot_times:
            if len(hot_times) < 256:
                hot_times.append(t)

        new = cov.keys - global_cov
        if new:
            global_cov |= new
            result.new_cov_runs += 1
            if not res.violations:
                corpus.append(genome)
            if progress and result.runs % 20 == 0:
                progress(f"run {result.runs}: corpus {len(corpus)}, "
                         f"coverage {len(global_cov)}")

        if res.violations:
            sig = tuple(sorted(violation_names(res.violations))) or \
                ("unstructured",)
            if sig not in found_sigs:
                found_sigs.add(sig)
                if progress:
                    progress(f"run {result.runs}: violation "
                             f"{'+'.join(sig)} "
                             f"({len(genome.ops)} ops) — minimizing")
                mini, stats = genome, {"probes": 0}
                if minimize and len(genome.ops) > 1:
                    mini, stats = minimize_genome(
                        genome, sig, params=params, progress=progress)
                final = run_genome(mini, params=params)
                finding = HuntFinding(
                    signature=sig, genome=genome, minimized=mini,
                    found_after_runs=result.runs,
                    ddmin_probes=stats["probes"],
                    violations=final.violations,
                    trace_hash=final.trace_hash)
                if out_dir:
                    finding.artifact = _write_finding(
                        finding, out_dir, params)
                result.findings.append(finding)
                if progress:
                    progress(f"minimized {'+'.join(sig)}: "
                             f"{len(genome.ops)} -> "
                             f"{len(mini.ops)} ops "
                             f"({stats['probes']} probes)")

    result.coverage = len(global_cov)
    result.coverage_keys = sorted(f"{a}:{b}" for a, b in global_cov)
    result.corpus = len(corpus)
    return result

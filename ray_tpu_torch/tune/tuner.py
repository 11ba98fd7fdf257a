"""Tuner: trial execution, FIFO + ASHA scheduling, result grid.

Reference parity: ``ray.tune.Tuner``/``tune.run`` — trials run as
cluster tasks, function trainables report per-iteration metrics through
the session (``tune.report``), ASHA promotes the top ``1/eta`` of each
rung to the next iteration budget using trial checkpoints, and the
ResultGrid exposes ``get_best_result`` (``python/ray/tune/``,
SURVEY.md §1 layer 14; mount empty).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from ..train.checkpoint import Checkpoint

_session = threading.local()


class _TrialSession:
    def __init__(self, checkpoint: Checkpoint | None):
        self.reports: list[dict] = []
        self.checkpoint_in = checkpoint
        self.checkpoint_out: Checkpoint | None = None


def report(metrics: dict, checkpoint: Checkpoint | None = None) -> None:
    s = getattr(_session, "value", None)
    if s is None:
        raise RuntimeError("tune.report called outside a trial")
    s.reports.append(dict(metrics))
    if checkpoint is not None:
        s.checkpoint_out = checkpoint


def get_checkpoint() -> Checkpoint | None:
    s = getattr(_session, "value", None)
    if s is None:
        raise RuntimeError("tune.get_checkpoint called outside a trial")
    return s.checkpoint_in


def _run_trial(fn_bytes: bytes, config: dict,
               ckpt_state: dict | None) -> tuple:
    """Task body: execute the trainable under a session."""
    from ..runtime.serialization import deserialize
    s = _TrialSession(Checkpoint(ckpt_state)
                      if ckpt_state is not None else None)
    _session.value = s
    try:
        deserialize(fn_bytes)(config)
    finally:
        _session.value = None
    out_state = s.checkpoint_out.to_dict() \
        if s.checkpoint_out is not None else None
    return s.reports, out_state


@dataclass
class TrialResult:
    config: dict
    metrics: dict
    history: list[dict]
    checkpoint: Checkpoint | None

    def metric(self, name: str):
        return self.metrics.get(name)


class ResultGrid:
    def __init__(self, results: list[TrialResult], metric: str,
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self) -> int:
        return len(self._results)

    def get_best_result(self, metric: str | None = None,
                        mode: str | None = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]           # noqa: E731
        return max(scored, key=key) if mode == "max" \
            else min(scored, key=key)

    def get_dataframe(self) -> list[dict]:
        """Rows of config+final metrics (list of dicts — no pandas
        dependency)."""
        return [{**{f"config/{k}": v for k, v in r.config.items()},
                 **r.metrics} for r in self._results]


@dataclass
class FIFOScheduler:
    """Run every trial to completion (the reference default)."""


@dataclass
class ASHAScheduler:
    """Async successive halving: rung ``i`` runs
    ``grace_period * eta**i`` iterations, the top ``1/eta`` by metric
    promote (resumed from their rung checkpoint)."""
    max_t: int = 32
    grace_period: int = 1
    reduction_factor: int = 4


@dataclass
class PopulationBasedTraining:
    """PBT (reference ``tune.schedulers.PopulationBasedTraining``): the
    population trains in intervals; after each interval the bottom
    quantile EXPLOITS a top-quantile peer (copies its checkpoint and
    config) and EXPLORES by mutating the listed hyperparameters —
    resample from the domain with ``resample_probability``, else scale
    numeric values by 0.8/1.2 (the reference's perturbation factors).

    ``hyperparam_mutations``: name -> ``Domain`` / list of choices.
    Total iterations = ``perturbation_interval * num_intervals``, the
    same cumulative ``tune_iterations`` contract as ASHA."""

    perturbation_interval: int = 1
    num_intervals: int = 4
    quantile_fraction: float = 0.25
    resample_probability: float = 0.25
    hyperparam_mutations: dict = field(default_factory=dict)


@dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    scheduler: Any = field(default_factory=FIFOScheduler)
    seed: int = 0
    resources_per_trial: dict = field(
        default_factory=lambda: {"CPU": 1})


class Tuner:
    def __init__(self, trainable: Callable[[dict], None], *,
                 param_space: dict,
                 tune_config: TuneConfig | None = None):
        self._fn = trainable
        self._space = dict(param_space)
        self._cfg = tune_config or TuneConfig()

    def fit(self, timeout: float = 600.0) -> ResultGrid:
        from ..runtime.serialization import serialize
        from .search import expand
        configs = expand(self._space, self._cfg.num_samples,
                         self._cfg.seed)
        fn_bytes = serialize(self._fn)
        sched = self._cfg.scheduler
        if isinstance(sched, ASHAScheduler):
            results = self._fit_asha(fn_bytes, configs, sched, timeout)
        elif isinstance(sched, PopulationBasedTraining):
            results = self._fit_pbt(fn_bytes, configs, sched, timeout)
        else:
            results = self._fit_fifo(fn_bytes, configs, timeout)
        return ResultGrid(results, self._cfg.metric, self._cfg.mode)

    # -- schedulers ----------------------------------------------------------
    def _task(self):
        import ray_tpu_torch
        res = self._cfg.resources_per_trial
        return ray_tpu_torch.remote(_run_trial).options(
            num_cpus=res.get("CPU", 1), resources=dict(res))

    def _fit_fifo(self, fn_bytes, configs, timeout) -> list[TrialResult]:
        import ray_tpu_torch
        task = self._task()
        refs = [task.remote(fn_bytes, dict(cfg), None)
                for cfg in configs]
        outs = ray_tpu_torch.get(refs, timeout=timeout)
        return [self._result(cfg, reports, state)
                for cfg, (reports, state) in zip(configs, outs)]

    @staticmethod
    def _run_round(task, fn_bytes, trials, budget, timeout) -> None:
        """One synchronized round: every trial resumes from its
        checkpoint, runs to ``budget`` TOTAL iterations, and folds its
        reports/checkpoint back in (shared by ASHA rungs and PBT
        intervals)."""
        import ray_tpu_torch
        refs = []
        for trial in trials:
            cfg = dict(trial.config)
            cfg["tune_iterations"] = budget
            state = trial.checkpoint.to_dict() \
                if trial.checkpoint is not None else None
            refs.append(task.remote(fn_bytes, cfg, state))
        outs = ray_tpu_torch.get(refs, timeout=timeout)
        for trial, (reports, state) in zip(trials, outs):
            trial.history.extend(reports)
            if reports:
                trial.metrics = reports[-1]
            if state is not None:
                trial.checkpoint = Checkpoint(state)

    def _fit_asha(self, fn_bytes, configs, sched,
                  timeout) -> list[TrialResult]:
        """Rung r: survivors run ``grace*eta**r`` TOTAL iterations
        (resumed from their previous rung's checkpoint via
        ``tune.get_checkpoint``); the top 1/eta promote."""
        metric, mode = self._cfg.metric, self._cfg.mode
        task = self._task()
        alive = [TrialResult(dict(cfg), {}, [], None) for cfg in configs]
        finished: list[TrialResult] = []
        budget = min(sched.grace_period, sched.max_t)
        while alive:
            self._run_round(task, fn_bytes, alive, budget, timeout)
            if budget >= sched.max_t:
                finished.extend(alive)      # final rung ran at max_t
                break
            scored = [t for t in alive if metric in t.metrics]
            # trials that never reported the metric cannot compete for
            # promotion but MUST stay in the result grid — silently
            # vanishing configs would look like they never ran
            finished.extend(t for t in alive if metric not in t.metrics)
            scored.sort(key=lambda t: t.metrics[metric],
                        reverse=(mode == "max"))
            keep = max(len(scored) // sched.reduction_factor, 1)
            finished.extend(scored[keep:])  # stopped at this rung
            alive = scored[:keep]
            # the ladder clamps to max_t so the survivors' last rung
            # always runs the full budget
            budget = min(budget * sched.reduction_factor, sched.max_t)
        return finished + [t for t in alive if t not in finished]

    def _fit_pbt(self, fn_bytes, configs, sched,
                 timeout) -> list[TrialResult]:
        """Interval k: every trial resumes from its checkpoint and runs
        to ``perturbation_interval * k`` total iterations; then the
        bottom quantile exploits + explores (see scheduler docstring)."""
        import numpy as np
        if not 0.0 < sched.quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]: "
                             f"{sched.quantile_fraction}")
        metric, mode = self._cfg.metric, self._cfg.mode
        task = self._task()
        pop = [TrialResult(dict(cfg), {}, [], None) for cfg in configs]
        for k in range(1, sched.num_intervals + 1):
            self._run_round(task, fn_bytes, pop,
                            sched.perturbation_interval * k, timeout)
            if k == sched.num_intervals:
                continue
            # quantiles over the trials that actually REPORTED, sized so
            # top and bottom never overlap (an overlap would exploit a
            # well-performing trial with its own mutated copy)
            scored = [t for t in pop if metric in t.metrics]
            q = max(1, int(len(scored) * sched.quantile_fraction))
            if len(scored) < 2 * q or len(scored) < 2:
                continue
            scored.sort(key=lambda t: t.metrics[metric],
                        reverse=(mode == "max"))
            top, bottom = scored[:q], scored[-q:]
            rng = np.random.default_rng(self._cfg.seed * 1000 + k)
            for trial in bottom:
                peer = top[int(rng.integers(len(top)))]
                # exploit: the peer's weights and hyperparameters
                trial.checkpoint = peer.checkpoint
                trial.config = self._explore(dict(peer.config), sched,
                                             rng)
        return pop

    @staticmethod
    def _explore(config: dict, sched, rng) -> dict:
        """Mutate the listed hyperparameters of an exploited config.
        Continuous domains perturb by 0.8/1.2 (or resample); list
        domains step to an ADJACENT entry (or resample) — a perturbed
        value must stay inside the candidate set, the reference's PBT
        list-mutation rule."""
        from .search import Domain
        for name, domain in sched.hyperparam_mutations.items():
            if name not in config:
                continue
            resample = rng.random() < sched.resample_probability
            if isinstance(domain, Domain):
                if resample:
                    config[name] = domain.sample(rng)
                    continue
            elif isinstance(domain, (list, tuple)):
                choices = list(domain)
                cur = config[name]
                if resample or cur not in choices:
                    config[name] = choices[int(rng.integers(
                        len(choices)))]
                else:
                    i = choices.index(cur)
                    step = 1 if rng.random() < 0.5 else -1
                    config[name] = choices[min(max(i + step, 0),
                                               len(choices) - 1)]
                continue
            value = config[name]
            if isinstance(value, (int, float)) and \
                    not isinstance(value, bool):
                factor = 1.2 if rng.random() < 0.5 else 0.8
                config[name] = type(value)(value * factor) \
                    if isinstance(value, int) else value * factor
        return config

    @staticmethod
    def _result(cfg, reports, state) -> TrialResult:
        return TrialResult(
            dict(cfg), reports[-1] if reports else {}, reports,
            Checkpoint(state) if state is not None else None)


def run(trainable: Callable[[dict], None], *, param_space: dict,
        **tune_kwargs) -> ResultGrid:
    """``tune.run`` convenience wrapper over ``Tuner``."""
    return Tuner(trainable, param_space=param_space,
                 tune_config=TuneConfig(**tune_kwargs)).fit()

"""The port's tune against the JAX package's, on the same inputs.

Scenario sources: ``tests/test_tune.py``.  ``expand`` and PBT's
``_explore`` are host code drawing from numpy, so the port's configs
must equal the reference's dict for dict.  The Tuner scenarios (FIFO,
the ``run`` wrapper, ASHA, checkpoint resume, PBT) run once through each
package's runtime (the port with ``scheduler_device="cpu"``), one after
the other; their rounds are synchronous, so every trial's config,
metrics, history and checkpoint must be the same in both.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _tune(pkg):
    return importlib.import_module(f"{pkg}.tune")


# -- search spaces: host code, equal dict for dict ----------------------------

def _spaces(t):
    return [
        ({"a": t.grid_search([1, 2]), "b": t.grid_search(["x", "y"]),
          "c": 7}, 1),
        ({"lr": t.loguniform(1e-4, 1e-1), "n": t.randint(1, 10),
          "opt": t.choice(["sgd", "adam"])}, 20),
        ({"lr": t.uniform(-1.0, 2.0), "g": t.grid_search([0.1, 0.2, 0.3]),
          "bs": t.choice([16, 32, 64]), "fixed": "z"}, 4),
    ]


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("space", range(3))
def test_expand_equals_the_reference(space, seed):
    ref, port = (importlib.import_module(f"{p}.tune.search") for p in PKGS)
    (rs, n), (ps, _n) = _spaces(_tune("ray_tpu"))[space], \
        _spaces(_tune("ray_tpu_torch"))[space]
    want = ref.expand(rs, num_samples=n, seed=seed)
    got = port.expand(ps, num_samples=n, seed=seed)
    assert got == want
    assert [[type(v) for v in c.values()] for c in got] == \
        [[type(v) for v in c.values()] for c in want]


def test_what_expand_gives():
    t = _tune("ray_tpu_torch")
    from ray_tpu_torch.tune.search import expand
    cfgs = expand(_spaces(t)[0][0], num_samples=1, seed=0)
    assert {(c["a"], c["b"]) for c in cfgs} == \
        {(1, "x"), (1, "y"), (2, "x"), (2, "y")}
    assert all(c["c"] == 7 for c in cfgs)
    cfgs = expand(_spaces(t)[1][0], num_samples=20, seed=1)
    assert len(cfgs) == 20
    assert all(1e-4 <= c["lr"] <= 1e-1 and 1 <= c["n"] < 10 for c in cfgs)
    assert {c["opt"] for c in cfgs} <= {"sgd", "adam"}


@pytest.mark.parametrize("case", [
    ("mutates_only_listed", 0.0, {"lr": ("loguniform", 1e-4, 1.0),
                                  "mode": ["a", "b"]},
     {"lr": 0.1, "mode": "a", "frozen": 5}),
    ("resamples_from_domain", 1.0, {"lr": ("uniform", 10.0, 20.0)},
     {"lr": 0.1}),
    ("list_steps_to_a_neighbour", 0.0, {"bs": [16, 32, 64]}, {"bs": 32}),
    ("list_clamps_at_the_edge", 0.0, {"bs": [16, 32, 64]}, {"bs": 16}),
], ids=lambda c: c[0])
def test_pbt_explore_equals_the_reference(case):
    _name, resample, mutations, config = case
    outs = []
    for pkg in PKGS:
        t = _tune(pkg)
        tuner = importlib.import_module(f"{pkg}.tune.tuner")
        muts = {k: getattr(t, v[0])(*v[1:]) if isinstance(v, tuple) else v
                for k, v in mutations.items()}
        sched = tuner.PopulationBasedTraining(
            resample_probability=resample, hyperparam_mutations=muts)
        outs.append([tuner.Tuner._explore(dict(config), sched,
                                          np.random.default_rng(seed))
                     for seed in range(6)])
    assert outs[1] == outs[0]
    if "bs" in config:
        allowed = (16, 64) if config["bs"] == 32 else (16, 32)
        assert all(c["bs"] in allowed for c in outs[1])


# -- Tuner scenarios through each runtime ------------------------------------

def _quadratic(pkg):
    def trainable(config):
        tune = importlib.import_module(f"{pkg}.tune")
        tune.report({"loss": (config["x"] - 3.0) ** 2, "x": config["x"]})
    return trainable


def _iterative(pkg):
    """SGD on x^2, resumable from a checkpoint (a closure: shipped by
    value, so a worker never imports this file)."""
    def trainable(config):
        tune = importlib.import_module(f"{pkg}.tune")
        ckpt = tune.get_checkpoint()
        state = ckpt.to_dict() if ckpt is not None else \
            {"x": 10.0, "iter": 0}
        x, start = state["x"], state["iter"]
        for i in range(start, config["tune_iterations"]):
            x = x - config["lr"] * 2.0 * x
            tune.report({"loss": x * x, "iteration": i + 1})
        tune.report({"loss": x * x,
                     "iteration": config["tune_iterations"]},
                    checkpoint=tune.Checkpoint(
                        {"x": x, "iter": config["tune_iterations"]}))
    return trainable


def _grid(grid):
    return [(r.config, r.metrics, r.history,
             r.checkpoint.to_dict() if r.checkpoint is not None else None)
            for r in grid]


def fifo_grid_finds_minimum(t, pkg):
    grid = t.Tuner(_quadratic(pkg),
                   param_space={"x": t.grid_search([0.0, 1.0, 2.0, 3.0,
                                                    4.0])},
                   tune_config=t.TuneConfig(metric="loss", mode="min")
                   ).fit()
    best = grid.get_best_result()
    return len(grid), best.config, best.metrics, _grid(grid)


def run_wrapper_and_dataframe(t, pkg):
    grid = t.run(_quadratic(pkg),
                 param_space={"x": t.grid_search([1.0, 5.0])},
                 metric="loss", mode="min")
    return grid.get_dataframe()


def asha_promotes_best_and_stops_worst(t, pkg):
    grid = t.Tuner(_iterative(pkg),
                   param_space={"lr": t.grid_search([0.001, 0.01, 0.1,
                                                     0.4])},
                   tune_config=t.TuneConfig(
                       metric="loss", mode="min",
                       scheduler=t.ASHAScheduler(
                           max_t=16, grace_period=2, reduction_factor=4))
                   ).fit()
    budgets = {r.config["lr"]: r.metrics.get("iteration", 0) for r in grid}
    return grid.get_best_result().config, budgets, _grid(grid)


def checkpoint_resume_continues(t, pkg):
    grid = t.Tuner(_iterative(pkg),
                   param_space={"lr": t.grid_search([0.1, 0.2])},
                   tune_config=t.TuneConfig(
                       metric="loss", mode="min",
                       scheduler=t.ASHAScheduler(
                           max_t=8, grace_period=2, reduction_factor=4))
                   ).fit()
    best = grid.get_best_result()
    return ([r["iteration"] for r in best.history if "iteration" in r],
            best.config, best.checkpoint.to_dict())


def pbt_population_converges(t, pkg):
    def trainable(config):
        tune = importlib.import_module(f"{pkg}.tune")
        ckpt = tune.get_checkpoint()
        state = ckpt.to_dict() if ckpt is not None else {"x": 0.0, "it": 0}
        x, it = state["x"], state["it"]
        for i in range(it, config["tune_iterations"]):
            x -= config["lr"] * 2 * (x - 3.0)
            tune.report({"loss": (x - 3.0) ** 2},
                        checkpoint=tune.Checkpoint({"x": x, "it": i + 1}))

    grid = t.Tuner(
        trainable,
        param_space={"lr": t.grid_search([1e-6, 1e-6, 0.3, 0.3])},
        tune_config=t.TuneConfig(
            metric="loss", mode="min",
            scheduler=t.PopulationBasedTraining(
                perturbation_interval=4, num_intervals=4,
                quantile_fraction=0.25,
                hyperparam_mutations={"lr": t.loguniform(1e-2, 1.0)}))
    ).fit(timeout=300)
    return sorted(r.metrics["loss"] for r in grid), _grid(grid)


def quantile_fraction_validated(t, pkg):
    try:
        t.Tuner(lambda cfg: None, param_space={"x": 1},
                tune_config=t.TuneConfig(
                    scheduler=t.PopulationBasedTraining(
                        quantile_fraction=0.8))).fit(timeout=30)
    except ValueError as e:
        return str(e)
    return None


SCENARIOS = [fifo_grid_finds_minimum, run_wrapper_and_dataframe,
             asha_promotes_best_and_stops_worst, checkpoint_resume_continues,
             pbt_population_converges, quantile_fraction_validated]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name in PKGS:
        rt = importlib.import_module(name)
        importlib.import_module(f"{name}.api")
        t = _tune(name)
        port = name == "ray_tpu_torch"
        rt.init(resources={"CPU": 8, "memory": 8}, num_workers=4,
                system_config={"scheduler_device": "cpu"} if port else None)
        res = out[name] = {}
        try:
            for sc in SCENARIOS:
                try:
                    res[sc.__name__] = sc(t, name)
                except Exception as e:      # noqa: BLE001 — compared
                    res[sc.__name__] = e
        finally:
            rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_same_as_reference(runs, scenario):
    want = runs["ray_tpu"][scenario.__name__]
    got = runs["ray_tpu_torch"][scenario.__name__]
    for v in (want, got):
        if isinstance(v, Exception):
            raise v
    assert got == want


def test_what_the_runs_show(runs):
    got = runs["ray_tpu_torch"]
    n, best_cfg, best_metrics, _ = got["fifo_grid_finds_minimum"]
    assert n == 5 and best_cfg["x"] == 3.0 and best_metrics["loss"] == 0.0
    rows = got["run_wrapper_and_dataframe"]
    assert len(rows) == 2 and {r["config/x"] for r in rows} == {1.0, 5.0}
    best, budgets, _ = got["asha_promotes_best_and_stops_worst"]
    assert best["lr"] == 0.4 and budgets[0.4] == 16
    assert sum(1 for v in budgets.values() if v < 16) >= 2
    iters, cfg, ckpt = got["checkpoint_resume_continues"]
    assert max(iters) == 8
    np.testing.assert_allclose(ckpt["x"], 10.0 * (1 - 2 * cfg["lr"]) ** 8,
                               rtol=1e-10)
    losses, _ = got["pbt_population_converges"]
    assert losses[0] < 1e-3 and sum(v < 1.0 for v in losses) >= 3
    assert "quantile_fraction" in got["quantile_fraction_validated"]

"""The port's RLlib against the JAX package's.

Scenario sources: ``tests/test_rllib.py``.  The update math is held to
the reference on fixed seeded inputs: the PG update, PPO's step and a
learner's SUM-gradient update, ``torch.func`` against ``jax.grad``, agree
within ``UPDATE_TOL``.  Then the algorithms run through the runtimes
(the port with ``scheduler_device="cpu"`` and ``device="cpu"``): the
first iteration of PG, PPO and the learner gang in both packages, whose
rollouts start from the same numpy init and so must report the same
episodes and end at params within ``UPDATE_TOL``; and every scenario of
the reference file in the port, held to the reference test's bar.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")
UPDATE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _envs():
    """The reference test's environments, built in a function so that
    cloudpickle ships them by value: a rollout worker never imports this
    file (nor the torch and JAX it imports)."""

    class TwoArmBandit:
        """Arm 1 pays 1.0, arm 0 pays 0.1; one-step episodes."""

        def reset(self):
            return np.array([1.0], dtype=np.float32)

        def step(self, action):
            reward = 1.0 if action == 1 else 0.1
            return np.array([1.0], dtype=np.float32), reward, True

    class Corridor:
        """Walk right to the goal at x=4; -0.05 per step, +1 at goal."""

        def reset(self):
            self.x = 0
            return self._obs()

        def _obs(self):
            return np.array([self.x / 4.0, 1.0], dtype=np.float32)

        def step(self, action):
            self.x += 1 if action == 1 else -1
            self.x = max(self.x, 0)
            if self.x >= 4:
                return self._obs(), 1.0, True
            return self._obs(), -0.05, False

    return TwoArmBandit, Corridor


TwoArmBandit, Corridor = _envs()


# -- the update math on fixed seeded inputs -----------------------------------

def _batch(seed, n=96, obs_dim=3, num_actions=4):
    rng = np.random.default_rng(seed)
    params = {"w": (0.3 * rng.normal(size=(obs_dim, num_actions))
                    ).astype(np.float32),
              "b": (0.1 * rng.normal(size=num_actions)).astype(np.float32),
              "vw": (0.2 * rng.normal(size=obs_dim)).astype(np.float32),
              "vb": np.float32(0.05)}
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    actions = rng.integers(0, num_actions, size=n).astype(np.int32)
    returns = rng.normal(size=n).astype(np.float32)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    return params, obs, actions, returns, mask


def _bare(pkg, cls, **config):
    """An algorithm object with only its config (and device), to reach
    its update builders without rollout workers."""
    rllib = importlib.import_module(f"{pkg}.rllib")
    obj = getattr(rllib, cls).__new__(getattr(rllib, cls))
    obj.config = getattr(rllib, "PPOConfig" if cls == "PPO"
                         else "PGConfig")(**config)
    obj.device = torch.device("cpu")
    return obj


def _port_tensors(*arrays):
    return [torch.from_numpy(np.asarray(a, np.int64 if a.dtype.kind == "i"
                                        else np.float32)) for a in arrays]


@pytest.mark.parametrize("seed", range(4))
def test_pg_update_equals_the_reference(seed):
    params, obs, actions, returns, mask = _batch(seed)
    pg = {k: params[k] for k in ("w", "b")}
    want = _bare("ray_tpu", "Algorithm", lr=0.3)._make_update()(
        pg, obs, actions, returns, mask)
    got = _bare("ray_tpu_torch", "Algorithm", lr=0.3)._make_update()(
        {k: torch.from_numpy(v) for k, v in pg.items()},
        *_port_tensors(obs, actions, returns, mask))
    for k in pg:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **UPDATE_TOL)
        assert not np.allclose(np.asarray(want[k]), pg[k])


@pytest.mark.parametrize("seed", range(4))
def test_ppo_step_equals_the_reference(seed):
    params, obs, actions, returns, mask = _batch(seed)
    rng = np.random.default_rng(100 + seed)
    logp_old = (np.log(0.25) + 0.1 * rng.normal(size=len(obs))
                ).astype(np.float32)
    adv = returns
    vtarg = (returns + mask).astype(np.float32)
    cfg = dict(lr=0.05, clip_param=0.2, vf_coef=0.5, entropy_coef=0.01)
    want, wpl, wvl = _bare("ray_tpu", "PPO", **cfg)._make_ppo_step()(
        params, obs, actions, logp_old, adv, vtarg)
    got, gpl, gvl = _bare("ray_tpu_torch", "PPO", **cfg)._make_ppo_step()(
        {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
        *_port_tensors(obs, actions, logp_old, adv, vtarg))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **UPDATE_TOL)
    np.testing.assert_allclose([float(gpl), float(gvl)],
                               [float(wpl), float(wvl)], **UPDATE_TOL)


def test_learner_update_equals_the_reference():
    _params, obs, actions, returns, _mask = _batch(9, obs_dim=2,
                                                   num_actions=3)
    adv = returns - returns.mean()
    out = []
    for pkg in PKGS:
        alg = importlib.import_module(f"{pkg}.rllib.algorithm")
        learner = alg.LearnerWorker(2, 3, lr=0.2, seed=4, rank=0, world=1,
                                    group="unused")
        assert learner.update_shard(obs, actions, adv, 120) == 120
        learner.update_shard(obs[:0], actions[:0], adv[:0], 120)
        out.append(learner.params())
    for k in ("w", "b"):
        assert isinstance(out[1][k], np.ndarray)
        np.testing.assert_allclose(out[1][k], out[0][k], **UPDATE_TOL)


def test_no_device_means_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None lands on it")
    from ray_tpu_torch.rllib import PPO, Algorithm, PGConfig, PPOConfig
    for cls, cfg in ((Algorithm, PGConfig), (PPO, PPOConfig)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cfg(env_creator=TwoArmBandit, obs_dim=1, num_actions=2))


# -- through the runtimes -----------------------------------------------------

def _algo(pkg, cls, config_cls, **cfg):
    rllib = importlib.import_module(f"{pkg}.rllib")
    kw = {"device": "cpu"} if pkg == "ray_tpu_torch" else {}
    return getattr(rllib, cls)(getattr(rllib, config_cls)(**cfg), **kw)


def _first_iteration(pkg, cls, config_cls, **cfg):
    algo = _algo(pkg, cls, config_cls, **cfg)
    try:
        metrics = algo.train()
        return metrics, algo.get_policy_params()
    finally:
        algo.stop()


FIRST = {
    "pg_bandit": ("Algorithm", "PGConfig", dict(
        env_creator=TwoArmBandit, obs_dim=1, num_actions=2, num_workers=2,
        episodes_per_worker=16, horizon=1, lr=0.5, seed=0)),
    "multi_learner": ("Algorithm", "PGConfig", dict(
        env_creator=TwoArmBandit, obs_dim=1, num_actions=2, num_workers=2,
        episodes_per_worker=6, horizon=1, lr=0.2, seed=7, num_learners=3)),
    "ppo_corridor": ("PPO", "PPOConfig", dict(
        env_creator=Corridor, obs_dim=2, num_actions=2, num_workers=2,
        episodes_per_worker=8, horizon=16, lr=0.03, minibatch_size=64,
        num_epochs=4, gae_lambda=0.9, seed=0)),
}


def _runtime(name):
    rt = importlib.import_module(name)
    importlib.import_module(f"{name}.api")
    port = name == "ray_tpu_torch"
    rt.init(resources={"CPU": 8, "memory": 8}, num_workers=4,
            system_config={"scheduler_device": "cpu"} if port else None)
    return rt


@pytest.fixture(scope="module")
def first():
    out = {}
    for name in PKGS:
        rt = _runtime(name)
        res = out[name] = {}
        try:
            for key, (cls, cfg_cls, cfg) in FIRST.items():
                try:
                    res[key] = _first_iteration(name, cls, cfg_cls, **cfg)
                except Exception as e:      # noqa: BLE001 — compared
                    res[key] = e
        finally:
            rt.shutdown()
            (PortConfig if name == "ray_tpu_torch" else RefConfig).reset()
    return out


@pytest.mark.parametrize("key", FIRST)
def test_first_iteration_same_as_reference(first, key):
    want, got = first["ray_tpu"][key], first["ray_tpu_torch"][key]
    for v in (want, got):
        if isinstance(v, Exception):
            raise v
    (wm, wp), (gm, gp) = want, got
    # the same episodes from the same init: the rollout metrics are
    # equal, PPO's losses within the tolerance
    losses = ("policy_loss", "vf_loss")
    assert {k: v for k, v in gm.items() if k not in losses} == \
        {k: v for k, v in wm.items() if k not in losses}
    np.testing.assert_allclose([gm.get(k, 0.0) for k in losses],
                               [wm.get(k, 0.0) for k in losses],
                               **UPDATE_TOL)
    assert sorted(gp) == sorted(wp)
    for k in wp:
        assert gp[k].dtype == np.asarray(wp[k]).dtype
        np.testing.assert_allclose(gp[k], np.asarray(wp[k]), **UPDATE_TOL)


# -- the reference file's scenarios in the port, at its bars ------------------

@pytest.fixture(scope="module")
def port_rt(first):
    rt = _runtime("ray_tpu_torch")
    yield rt
    rt.shutdown()
    PortConfig.reset()


def _port(cls, config_cls, **cfg):
    return _algo("ray_tpu_torch", cls, config_cls, **cfg)


def test_learners_stay_identical_and_match_single(port_rt):
    cfg = dict(env_creator=TwoArmBandit, obs_dim=1, num_actions=2,
               num_workers=2, episodes_per_worker=6, horizon=1, lr=0.2,
               seed=7)
    single = _port("Algorithm", "PGConfig", num_learners=1, **cfg)
    multi = _port("Algorithm", "PGConfig", num_learners=3, **cfg)
    try:
        single.train()
        multi.train()
        p1, pm = single.get_policy_params(), multi.get_policy_params()
        for k in ("w", "b"):
            np.testing.assert_allclose(pm[k], p1[k], rtol=1e-4, atol=1e-5)
        all_params = port_rt.get(
            [ln.params.remote() for ln in multi._learners], timeout=60)
        for p in all_params[1:]:
            for k in ("w", "b"):
                np.testing.assert_array_equal(p[k], all_params[0][k])
    finally:
        single.stop()
        multi.stop()


def test_multi_learner_learns(port_rt):
    algo = _port("Algorithm", "PGConfig", env_creator=TwoArmBandit,
                 obs_dim=1, num_actions=2, num_workers=2,
                 episodes_per_worker=6, horizon=1, lr=0.2, seed=3,
                 num_learners=2)
    try:
        for _ in range(25):
            metrics = algo.train()
        assert metrics["episode_reward_mean"] > 0.8, metrics
    finally:
        algo.stop()


def test_ppo_rejects_multi_learner(port_rt):
    with pytest.raises(ValueError, match="single learner"):
        _port("PPO", "PPOConfig", env_creator=TwoArmBandit, obs_dim=1,
              num_actions=2, num_learners=2)


def test_bandit_learns_best_arm(port_rt):
    algo = _port("Algorithm", "PGConfig", **FIRST["pg_bandit"][2])
    try:
        first_it = algo.train()
        assert first_it["training_iteration"] == 1
        assert first_it["episodes_this_iter"] == 32
        for _ in range(14):
            last = algo.train()
        assert last["episode_reward_mean"] > 0.9
        picks = [algo.compute_single_action(np.array([1.0]),
                                            np.random.default_rng(i))
                 for i in range(20)]
        assert sum(picks) >= 18
    finally:
        algo.stop()


def test_corridor_improves(port_rt):
    algo = _port("Algorithm", "PGConfig", env_creator=Corridor, obs_dim=2,
                 num_actions=2, num_workers=2, episodes_per_worker=8,
                 horizon=30, lr=0.2, gamma=0.95, seed=1)
    try:
        rewards = [algo.train()["episode_reward_mean"] for _ in range(20)]
        assert np.mean(rewards[-5:]) > np.mean(rewards[:5])
        assert np.mean(rewards[-5:]) > 0.5
    finally:
        algo.stop()


def test_config_validation():
    from ray_tpu_torch.rllib import Algorithm, PGConfig
    with pytest.raises(ValueError, match="needs env_creator"):
        Algorithm(PGConfig(), device="cpu")


def test_ppo_bandit_learns_best_arm(port_rt):
    algo = _port("PPO", "PPOConfig", env_creator=TwoArmBandit, obs_dim=1,
                 num_actions=2, num_workers=2, episodes_per_worker=16,
                 horizon=1, lr=0.05, minibatch_size=16, num_epochs=4,
                 seed=3)
    try:
        first_it = algo.train()
        assert {"policy_loss", "vf_loss",
                "episode_reward_mean"} <= set(first_it)
        for _ in range(14):
            last = algo.train()
        assert last["episode_reward_mean"] > 0.9, last
        assert algo.compute_single_action([1.0]) == 1
    finally:
        algo.stop()


def test_ppo_corridor_improves(port_rt):
    algo = _port("PPO", "PPOConfig", **FIRST["ppo_corridor"][2])
    try:
        rewards = [algo.train()["episode_reward_mean"] for _ in range(18)]
        assert np.mean(rewards[-3:]) > np.mean(rewards[:3]), rewards
    finally:
        algo.stop()


def test_value_head_trains_and_tight_clip_slows_policy(port_rt):
    def policy_shift(clip, iters=3):
        a = _port("PPO", "PPOConfig", env_creator=TwoArmBandit, obs_dim=1,
                  num_actions=2, num_workers=1, episodes_per_worker=32,
                  horizon=1, lr=0.05, minibatch_size=32, num_epochs=4,
                  seed=1, clip_param=clip)
        try:
            w0 = a.get_policy_params()["w"].copy()
            for _ in range(iters):
                a.train()
            return float(np.abs(a.get_policy_params()["w"] - w0).max())
        finally:
            a.stop()

    assert policy_shift(1e-4) < policy_shift(10.0)
    algo = _port("PPO", "PPOConfig", env_creator=TwoArmBandit, obs_dim=1,
                 num_actions=2, num_workers=1, episodes_per_worker=32,
                 horizon=1, lr=0.05, minibatch_size=32, num_epochs=2,
                 seed=1)
    try:
        v0 = algo.train()["vf_loss"]
        for _ in range(6):
            v1 = algo.train()["vf_loss"]
        assert np.isfinite(v1) and v1 < v0, (v0, v1)
        assert all(np.isfinite(p).all()
                   for p in algo.get_policy_params().values())
    finally:
        algo.stop()

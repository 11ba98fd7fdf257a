"""Rollout workers + REINFORCE-with-baseline on a softmax policy.

The rollout plane mirrors the reference (worker actors step envs with
policy weights broadcast each iteration, samples return through the
object store).  The learner plane scales: ``num_learners`` > 1 runs a
gang of gradient-synchronized learner actors — each computes SUM
gradients on its shard of the batch, allreduces them through the
collective process group (``ray_tpu_torch.util.collective``), and applies the
identical averaged update, so every learner holds the same params
(upstream's multi-learner + NCCL allreduce shape — SURVEY.md §1 layer
14; mount empty).  The multi-learner update is numerically equivalent
to the single-learner one (global baseline computed driver-side, SUM
gradients divided by the global count), not bitwise: float reduction
order differs.

The gradient steps are ``torch.func`` gradients.  The driver's
single-learner update and PPO's step run on the algorithm's device (the
GPU unless the caller passes ``device="cpu"``); rollout workers and
learners run in workers, which see no GPU, so learners compute on the
CPU and everything sent to a worker is numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np


def _softmax_logits(params, obs):
    return obs @ params["w"] + params["b"]


def _init_params(obs_dim: int, num_actions: int, seed: int) -> dict:
    """THE policy init — driver and every learner call this, so the
    gang and the rollout broadcast can never diverge by a drifted copy
    of the init (scale/dtype/rng order)."""
    rng = np.random.default_rng(seed)
    return {
        "w": (0.01 * rng.normal(size=(obs_dim, num_actions))
              ).astype(np.float32),
        "b": np.zeros(num_actions, dtype=np.float32)}


def _chosen_logp(params, obs, actions):
    """log pi(a|s) for the taken actions — shared by the single-learner
    objective and the learner gang's gradient (tensors; ``actions``
    int64)."""
    import torch
    logp = torch.log_softmax(_softmax_logits(params, obs), dim=1)
    return logp.gather(1, actions[:, None])[:, 0]


def _host(params: dict) -> dict:
    """numpy copies of the params (tensors on any device, or arrays):
    what goes to a worker, which cannot unpickle a CUDA tensor."""
    import torch
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in params.items()}


def _sample_action(params, obs, rng: np.random.Generator) -> int:
    logits = np.asarray(_softmax_logits(
        {k: np.asarray(v) for k, v in params.items()}, obs))
    z = logits - logits.max()
    p = np.exp(z) / np.exp(z).sum()
    return int(rng.choice(len(p), p=p))


class RolloutWorker:
    """Actor: steps its own env copies with the broadcast policy."""

    def __init__(self, env_creator_bytes: bytes, seed: int):
        from ..runtime.serialization import deserialize
        self._env = deserialize(env_creator_bytes)()
        self._rng = np.random.default_rng(seed)

    def sample(self, params: dict, num_episodes: int,
               horizon: int) -> list[dict]:
        """Roll ``num_episodes`` episodes; returns per-episode
        {obs, actions, rewards} arrays."""
        episodes = []
        for _ in range(num_episodes):
            obs_list, act_list, rew_list = [], [], []
            obs = self._env.reset()
            for _ in range(horizon):
                a = _sample_action(params, np.asarray(obs), self._rng)
                nxt, r, done = self._env.step(a)
                obs_list.append(np.asarray(obs))
                act_list.append(a)
                rew_list.append(r)
                obs = nxt
                if done:
                    break
            episodes.append({
                "obs": np.asarray(obs_list, dtype=np.float32),
                "actions": np.asarray(act_list, dtype=np.int32),
                "rewards": np.asarray(rew_list, dtype=np.float32)})
        return episodes


@dataclass
class PGConfig:
    env_creator: Callable = None
    obs_dim: int = 0
    num_actions: int = 0
    num_workers: int = 2
    episodes_per_worker: int = 8
    horizon: int = 64
    gamma: float = 0.99
    lr: float = 0.05
    seed: int = 0
    # > 1: gradient-synchronized learner gang (collective allreduce)
    num_learners: int = 1
    extra: dict = field(default_factory=dict)


class LearnerWorker:
    """One of N gradient-synchronized learners: SUM gradients on its
    shard, allreduce across the gang, identical averaged update."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 seed: int, rank: int, world: int, group: str):
        from torch.func import grad
        self._params = _init_params(obs_dim, num_actions, seed)
        self._lr = lr
        self._world = world
        self._group = group
        if world > 1:
            from ..util.collective import init_collective_group
            init_collective_group(world, rank, group_name=group)

        def grad_sum(params, obs, actions, adv):
            def neg_objective(p):
                return -(_chosen_logp(p, obs, actions) * adv).sum()
            return grad(neg_objective)(params)

        self._grad_sum = grad_sum

    def update_shard(self, obs, actions, adv, global_count: int) -> int:
        """Gradient on THIS shard, allreduced, applied; returns the
        global count for sanity.  Empty shards contribute zeros (every
        rank must join the allreduce)."""
        if len(adv):
            import torch
            # on the CPU: a worker sees no GPU
            grads = self._grad_sum(
                {k: torch.from_numpy(np.asarray(v))
                 for k, v in self._params.items()},
                torch.from_numpy(np.asarray(obs, np.float32)),
                torch.from_numpy(np.asarray(actions, np.int64)),
                torch.from_numpy(np.asarray(adv, np.float32)))
            gw = grads["w"].numpy()
            gb = grads["b"].numpy()
        else:
            gw = np.zeros_like(self._params["w"])
            gb = np.zeros_like(self._params["b"])
        flat = np.concatenate([gw.ravel(), gb.ravel()])
        if self._world > 1:
            from ..util.collective import allreduce
            flat = np.asarray(allreduce(flat, group_name=self._group))
        flat /= max(global_count, 1)
        k = self._params["w"].size
        self._params = {
            "w": self._params["w"] - self._lr
            * flat[:k].reshape(self._params["w"].shape),
            "b": self._params["b"] - self._lr * flat[k:]}
        return int(global_count)

    def params(self) -> dict:
        return {k: np.asarray(v) for k, v in self._params.items()}


class Algorithm:
    def __init__(self, config: PGConfig, *, device=None):
        """``device``: where the driver's update runs (None: the GPU, a
        ``RuntimeError`` without one; ``"cpu"`` on request)."""
        import ray_tpu_torch

        from ..convert import params_from_arrays
        from ..device import resolve_device
        from ..runtime.serialization import serialize
        if config.env_creator is None or config.obs_dim <= 0 \
                or config.num_actions <= 0:
            raise ValueError(
                "PGConfig needs env_creator, obs_dim, num_actions")
        self.config = config
        self.device = resolve_device(device)
        self._params = params_from_arrays(
            _init_params(config.obs_dim, config.num_actions, config.seed),
            self.device)
        worker_cls = ray_tpu_torch.remote(RolloutWorker)
        env_bytes = serialize(config.env_creator)
        self._workers = [worker_cls.remote(env_bytes, config.seed + i)
                         for i in range(config.num_workers)]
        self._update = self._make_update()
        self._learners: list = []
        if getattr(config, "num_learners", 1) > 1:
            import os
            learner_cls = ray_tpu_torch.remote(LearnerWorker)
            group = f"rllib-learners-{os.urandom(4).hex()}"
            world = config.num_learners
            self._learners = [
                learner_cls.remote(config.obs_dim, config.num_actions,
                                   config.lr, config.seed, rank, world,
                                   group)
                for rank in range(world)]
        self.iteration = 0

    def _make_update(self):
        import torch
        from torch.func import grad
        lr = self.config.lr

        def update(params, obs, actions, returns, mask):
            def neg_objective(p):
                chosen = _chosen_logp(p, obs, actions)
                # advantage = return - batch baseline (variance cut)
                denom = torch.clamp(mask.sum(), min=1.0)
                baseline = (returns * mask).sum() / denom
                adv = (returns - baseline) * mask
                return -(chosen * adv).sum() / denom
            grads = grad(neg_objective)(params)
            return {k: p - lr * grads[k] for k, p in params.items()}

        return update

    def _on_device(self, *arrays) -> list:
        """numpy batches as tensors on the update's device (actions,
        the integer arrays, as int64 indices)."""
        import torch
        return [torch.from_numpy(np.asarray(
            a, np.int64 if np.issubdtype(np.asarray(a).dtype, np.integer)
            else np.float32)).to(self.device) for a in arrays]

    def _collect_episodes(self, policy_params: dict) -> tuple:
        """Parallel rollouts: broadcast the policy, gather episodes.
        Returns ``(episodes, ep_rewards)``."""
        import ray_tpu_torch
        cfg = self.config
        batches = ray_tpu_torch.get(
            [w.sample.remote(policy_params, cfg.episodes_per_worker,
                             cfg.horizon) for w in self._workers],
            timeout=300)
        episodes = [ep for b in batches for ep in b]
        return episodes, [float(ep["rewards"].sum()) for ep in episodes]

    def _iter_metrics(self, episodes, ep_rewards, n_steps: int,
                      **extra) -> dict:
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "episodes_this_iter": len(episodes),
                "timesteps_this_iter": int(n_steps),
                "episode_reward_mean": float(np.mean(ep_rewards)),
                "episode_reward_max": float(np.max(ep_rewards)),
                "episode_reward_min": float(np.min(ep_rewards)),
                **extra}

    def train(self) -> dict:
        """One iteration: parallel rollouts -> batched PG update."""
        cfg = self.config
        episodes, ep_rewards = self._collect_episodes(_host(self._params))
        # flatten all timesteps; per-step discounted return-to-go
        obs, acts, rets = [], [], []
        for ep in episodes:
            r = ep["rewards"]
            g = np.zeros_like(r)
            acc = 0.0
            for t in range(len(r) - 1, -1, -1):
                acc = r[t] + cfg.gamma * acc
                g[t] = acc
            obs.append(ep["obs"])
            acts.append(ep["actions"])
            rets.append(g)
        obs = np.concatenate(obs)
        acts = np.concatenate(acts)
        rets = np.concatenate(rets).astype(np.float32)
        if self._learners:
            self._train_multi_learner(obs, acts, rets)
        else:
            mask = np.ones(len(rets), dtype=np.float32)
            self._params = self._update(
                self._params, *self._on_device(obs, acts, rets, mask))
        return self._iter_metrics(episodes, ep_rewards, len(rets))

    def _train_multi_learner(self, obs, acts, rets) -> None:
        """Shard the batch across the learner gang; each computes SUM
        gradients, allreduces, applies the identical update.  The
        baseline is GLOBAL (computed here) so the summed shard
        gradients equal the single-learner batch gradient."""
        import ray_tpu_torch
        adv = (rets - rets.mean()).astype(np.float32)
        n = len(adv)
        world = len(self._learners)
        bounds = [round(i * n / world) for i in range(world + 1)]
        refs = [
            learner.update_shard.remote(
                obs[bounds[r]:bounds[r + 1]],
                acts[bounds[r]:bounds[r + 1]],
                adv[bounds[r]:bounds[r + 1]], n)
            for r, learner in enumerate(self._learners)]
        ray_tpu_torch.get(refs, timeout=300)
        # every learner holds identical params; mirror rank 0's for the
        # rollout broadcast
        from ..convert import params_from_arrays
        self._params = params_from_arrays(
            ray_tpu_torch.get(self._learners[0].params.remote(),
                              timeout=60), self.device)

    def get_policy_params(self) -> dict:
        return _host(self._params)

    def compute_single_action(self, obs,
                              rng: np.random.Generator | None = None) \
            -> int:
        rng = rng or np.random.default_rng(0)
        return _sample_action(self.get_policy_params(),
                              np.asarray(obs), rng)

    def stop(self) -> None:
        import ray_tpu_torch
        for w in self._workers:
            ray_tpu_torch.kill(w)
        self._workers = []
        for ln in getattr(self, "_learners", []):
            ray_tpu_torch.kill(ln)
        self._learners = []


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

@dataclass
class PPOConfig(PGConfig):
    """Reference ``PPOConfig`` essentials: clipped surrogate objective,
    GAE advantages, a linear value head, multi-epoch minibatch SGD over
    each iteration's batch."""

    clip_param: float = 0.2
    num_epochs: int = 4
    minibatch_size: int = 128
    vf_coef: float = 0.5
    entropy_coef: float = 0.0
    gae_lambda: float = 0.95


def _value(params, obs):
    return obs @ params["vw"] + params["vb"]


class PPO(Algorithm):
    """Proximal Policy Optimization on the shared rollout plane.

    Rollout workers are identical to PG's (they only need the softmax
    policy weights); the learner recomputes behavior log-probs from the
    unchanged sampling params, builds GAE advantages from its value
    head, then runs clipped-surrogate minibatch epochs, one gradient
    step per minibatch on the algorithm's device (reference
    ``rllib/algorithms/ppo``)."""

    def __init__(self, config: PPOConfig, *, device=None):
        if getattr(config, "num_learners", 1) > 1:
            raise ValueError(
                "num_learners > 1 is implemented for the policy-"
                "gradient Algorithm; PPO runs a single learner")
        super().__init__(config, device=device)
        from ..convert import params_from_arrays
        self._params = dict(self._params)
        self._params.update(params_from_arrays(
            {"vw": np.zeros(config.obs_dim, dtype=np.float32),
             "vb": np.float32(0.0)}, self.device))
        self._ppo_step = self._make_ppo_step()

    @staticmethod
    def _logp_host(params, obs, actions):
        """Behavior log-probs on HOST numpy, as the reference computes
        them (its full-batch shape varies per iteration)."""
        logits = obs @ params["w"] + params["b"]
        z = logits - logits.max(axis=1, keepdims=True)
        lp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
        return lp[np.arange(len(actions)), actions].astype(np.float32)

    def _make_ppo_step(self):
        import torch
        from torch.func import grad
        cfg = self.config

        def step(params, obs, actions, logp_old, adv, vtarg):
            def loss_fn(p):
                lp_all = torch.log_softmax(_softmax_logits(p, obs), dim=1)
                lp = lp_all.gather(1, actions[:, None])[:, 0]
                ratio = torch.exp(lp - logp_old)
                clipped = torch.clamp(ratio, 1 - cfg.clip_param,
                                      1 + cfg.clip_param)
                policy_loss = -torch.mean(
                    torch.minimum(ratio * adv, clipped * adv))
                v = _value(p, obs)
                value_loss = torch.mean((v - vtarg) ** 2)
                entropy = -torch.mean(
                    torch.sum(torch.exp(lp_all) * lp_all, dim=1))
                return (policy_loss + cfg.vf_coef * value_loss
                        - cfg.entropy_coef * entropy), \
                    (policy_loss, value_loss)

            grads, (pl, vl) = grad(loss_fn, has_aux=True)(params)
            new = {k: p - cfg.lr * grads[k] for k, p in params.items()}
            return new, pl, vl
        return step

    def train(self) -> dict:
        cfg = self.config
        host = _host(self._params)
        policy = {k: host[k] for k in ("w", "b")}
        episodes, ep_rewards = self._collect_episodes(policy)
        obs_l, act_l, adv_l, vt_l = [], [], [], []
        for ep in episodes:
            o, r = ep["obs"], ep["rewards"]
            v = np.asarray(_value(host, o), dtype=np.float32)
            # GAE(λ): delta_t = r_t + γV(s_{t+1}) - V(s_t), terminal
            # bootstrap 0 (episodes end by done or horizon truncation —
            # truncation bootstrapping is a known simplification)
            v_next = np.append(v[1:], 0.0).astype(np.float32)
            delta = r + cfg.gamma * v_next - v
            adv = np.zeros_like(r)
            acc = 0.0
            for t in range(len(r) - 1, -1, -1):
                acc = delta[t] + cfg.gamma * cfg.gae_lambda * acc
                adv[t] = acc
            obs_l.append(o)
            act_l.append(ep["actions"])
            adv_l.append(adv)
            vt_l.append(adv + v)            # value targets
        obs = np.concatenate(obs_l)
        acts = np.concatenate(act_l)
        adv = np.concatenate(adv_l).astype(np.float32)
        vtarg = np.concatenate(vt_l).astype(np.float32)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        logp_old = self._logp_host(policy, obs, acts)
        n = len(acts)
        mbs = cfg.minibatch_size
        rng = np.random.default_rng(cfg.seed + self.iteration)
        pls, vls = [], []
        # the batch goes to the device once; minibatches index it there
        batch = self._on_device(obs, acts, logp_old, adv, vtarg)
        for _ in range(cfg.num_epochs):
            # fixed minibatch shape (the reference's: one XLA program):
            # full batches from a permutation, remainder refilled by
            # re-sampling (or the whole batch bootstrapped when it is
            # smaller than mbs)
            if n >= mbs:
                order = rng.permutation(n)
                starts = range(0, n - n % mbs, mbs)
                batches = [order[lo:lo + mbs] for lo in starts]
                if n % mbs:
                    batches.append(rng.choice(n, size=mbs,
                                              replace=False))
            else:
                batches = [rng.choice(n, size=mbs, replace=True)]
            for idx in batches:
                idx_t, = self._on_device(idx)
                self._params, pl, vl = self._ppo_step(
                    self._params, *(b[idx_t] for b in batch))
                pls.append(float(pl))
                vls.append(float(vl))
        return self._iter_metrics(
            episodes, ep_rewards, n,
            policy_loss=float(np.mean(pls)),
            vf_loss=float(np.mean(vls)))

"""ray_tpu_torch.rllib — RL training: parallel rollouts + policy optimization.

Reference parity: ``ray.rllib`` — an ``Algorithm`` owns a set of rollout
worker ACTORS that step gym-style environments with the current policy,
gathers their sample batches each iteration, and applies a policy
update; ``train()`` returns iteration metrics like
``episode_reward_mean`` (``python/ray/rllib/`` — SURVEY.md §1 layer 14;
mount empty).

Rollouts are Python-on-actors (environment stepping is host-bound
everywhere) and stay on the CPU; the POLICY update — softmax policy
gradient with baseline, or PPO's clipped surrogate with GAE and a value
head, batched over all collected episodes — is a ``torch.func``
gradient step on the driver's device (the GPU unless the caller asks
for the CPU), and a learner gang computes on the CPU of its workers.
"""

from .algorithm import PPO, Algorithm, PGConfig, PPOConfig, RolloutWorker

__all__ = ["Algorithm", "PGConfig", "PPO", "PPOConfig", "RolloutWorker"]

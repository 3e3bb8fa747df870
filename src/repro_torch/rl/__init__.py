"""repro_torch.rl: learned RRM policies over the CRRM engine.

The port of ``repro.rl``.  Two pillars:

* **PPO baselines** -- an MLP actor-critic over the per-cell/subband
  transmit-power action (optionally plus the PF alpha-fairness scalar),
  trained on batched ``CrrmEnv`` rollouts: ``policy`` (network + action
  squash), ``rollout`` (auto-resetting collection), ``ppo`` (GAE, the
  clipped surrogate and a checkpointed loop).
* **Differentiable CRRM** -- ``diffopt`` differentiates the engine's
  ``rollout`` with respect to the power-action trajectory through the
  flag-gated relaxations of ``repro_torch.sim.radio.RelaxConfig`` and runs
  first-order power-plan optimisation.
"""
from repro_torch.rl.policy import (PolicyConfig, init_policy, policy_apply,
                                   features, feature_dim, sample_action,
                                   logp_entropy, mean_action, squash_power,
                                   squash_fairness)
from repro_torch.rl.rollout import Trajectory, make_collect_fn
from repro_torch.rl.ppo import (PPOConfig, TrainState, ppo_init,
                                make_train_step, train, evaluate_uplift)
from repro_torch.rl.diffopt import (make_power_objective, optimize_power_plan,
                                    plan_to_power)

__all__ = [
    "PolicyConfig", "init_policy", "policy_apply", "features",
    "feature_dim", "sample_action", "logp_entropy", "mean_action",
    "squash_power", "squash_fairness",
    "Trajectory", "make_collect_fn",
    "PPOConfig", "TrainState", "ppo_init", "make_train_step", "train",
    "evaluate_uplift",
    "make_power_objective", "optimize_power_plan", "plan_to_power",
]

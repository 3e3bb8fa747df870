"""Population-batched, auto-resetting rollout collection.

The port of ``repro.rl.rollout``.  One call collects a PPO batch: a loop
over the decision steps of ``n_envs`` episode streams held as one batched
env state, each stream restarting itself at its horizon through the env's
``step_autoreset_batch`` (terminal transitions stay visible for GAE; the
carried state jumps to a fresh seed).  The loop carries the policy
features beside the env states, so the behaviour policy always acts on the
previous window's KPIs.

The env must be built with ``telemetry=True`` (the per-cell reward
components are the policy's features) and ``resample_topology=False``
(the auto-reset contract).  An env on a mesh (``CrrmEnv(mesh=)``) is
collected unbatched only: ``n_envs == 1``, its one stream stepped through
``step_autoreset`` (the sharded program already spans the ranks).

Randomness: the reference splits a PRNG key per step; here every draw of
a collection step -- the action noise and the reset seeds of the
``n_envs`` streams -- comes from :class:`RolloutDraws`, keyed on (run
seed, iteration, step) under a lineage of its own, so any iteration
replays on its own and a restored run continues bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.env.crrm_env import EnvObs
from repro_torch.mac.engine import _M64, _splitmix64
from repro_torch.rl import policy as pol

#: the draw lineage of the RL stack (the engine's ``Draws`` take 0-3)
_RL = 4
_INIT, _RESET0 = _M64, _M64 - 1     # the two draws that precede iteration 0


class RolloutDraws:
    """The random draws of a PPO run from its seed.

    Each (iteration, step) of collection has one ``torch.Generator`` on
    ``device`` for the (n_envs, action_dim) action noise, keyed by
    ``splitmix64(splitmix64(root + iteration) + step)`` with ``root`` the
    run seed mixed with the RL lineage; the streams' reset seeds are
    further splitmix64 values of that key, computed on the host (no device
    read).  ``init_generator`` and ``initial_seeds`` give the policy's
    initial weights and the first resets.  A subclass may replay other
    draws by overriding the methods.
    """

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._root = _splitmix64((_splitmix64(self.seed & _M64)
                                  + (_RL << 32)) & _M64)

    def _key(self, *path) -> int:
        k = self._root
        for x in path:
            k = _splitmix64((k + x) & _M64)
        return k

    def _generator(self, key: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(key)
        return g

    def _seeds(self, key: int, n: int) -> list:
        """``n`` non-negative int64 episode seeds from ``key``."""
        return [_splitmix64((key + 1 + b) & _M64) >> 1 for b in range(n)]

    def init_generator(self) -> torch.Generator:
        return self._generator(self._key(_INIT))

    def initial_seeds(self, n: int) -> list:
        return self._seeds(self._key(_RESET0), n)

    def action_noise(self, iteration: int, step: int, shape):
        """Standard normals of shape ``shape`` for one collection step."""
        return torch.randn(shape, generator=self._generator(
            self._key(iteration, step)), dtype=torch.float32,
            device=self.device)

    def reset_seeds(self, iteration: int, step: int, n: int) -> list:
        """The ``n`` streams' replacement-episode seeds at one step."""
        return self._seeds(self._key(iteration, step), n)


class Trajectory(NamedTuple):
    """One collection batch, time-major: every leaf (n_steps, n_envs, ...)."""

    feat: Any     # (T, B, feature_dim) what the behaviour policy saw
    u: Any        # (T, B, action_dim) unconstrained action samples
    logp: Any     # (T, B) behaviour log-probs of u
    value: Any    # (T, B) critic estimates
    reward: Any   # (T, B)
    done: Any     # (T, B) bool episode boundaries (pre-reset)


def _next_features(cfg, obs, info, done, feat0):
    rc = info["reward_components"]
    nf = pol.features(cfg, obs, rc["cell_tput_mbps"],
                      rc["cell_granted_rb"])
    # a finished stream restarts: its first decision of the fresh episode
    # sees the reset features, not the dead episode's terminal KPIs
    return torch.where(done[:, None], feat0, nf)


def make_collect_fn(env, cfg: pol.PolicyConfig, n_steps: int):
    """Build ``collect(params, env_states, feats, draws, iteration)``.

    Returns ``(env_states', feats', Trajectory, last_value)``: the batch
    axis of ``env_states``/``feats`` is ``n_envs``, ``draws`` a
    :class:`RolloutDraws` (or a replay of its interface) and
    ``last_value`` the critic's bootstrap at the post-rollout features.
    Pair it with ``env.reset_batch`` and :func:`initial_features` for the
    first call, then thread the returned carry (collection is one stream
    across iterations, as PPO has it).  Runs without autograd.  On a mesh
    env ``env_states`` is one unbatched state (``env.reset``) and
    ``feats`` is (1, feature_dim).
    """
    if not env.telemetry:
        raise ValueError("rollout collection needs CrrmEnv(telemetry="
                         "True): the per-cell reward components are the "
                         "policy's input features")
    if env.resample_topology:
        raise ValueError("rollout collection auto-resets in the loop, "
                         "which requires resample_topology=False")

    # the reset observation is seed-independent under a fixed topology
    # (zero tput, template backlog), so the reset features are a constant
    _, obs0 = env.reset(0)
    feat0 = pol.features(cfg, obs0)
    n_act = pol.action_dim(cfg)

    def mesh_step(state, power, seeds, fair):
        """The one stream of a mesh env, with its outputs given a batch
        axis of 1."""
        state, obs, reward, done, info = env.step_autoreset(
            state, power[0], seeds[0], None if fair is None else fair[0])
        info = {"telemetry": type(info["telemetry"])(*(
                    None if x is None else x[None]
                    for x in info["telemetry"])),
                "reward_components": {k: v[None] for k, v in
                                      info["reward_components"].items()}}
        return (state, EnvObs(obs.tput[None], obs.backlog[None]),
                reward[None], done[None], info)

    @torch.no_grad()
    def collect(params, env_states, feats, draws, iteration: int):
        n_envs = feats.shape[0]
        if env.mesh is not None and n_envs != 1:
            raise ValueError(
                f"a mesh env is collected unbatched only (n_envs == 1); "
                f"got {n_envs} streams")
        step_fn = env.step_autoreset_batch if env.mesh is None else mesh_step
        outs = []
        for step in range(n_steps):
            noise = draws.action_noise(iteration, step, (n_envs, n_act))
            u, power, fair, logp, value = pol.sample_action(
                cfg, params, feats, noise=noise)
            env_states, obs, reward, done, info = step_fn(
                env_states, power, draws.reset_seeds(iteration, step, n_envs),
                fair)
            outs.append((feats, u, logp, value, reward, done))
            feats = _next_features(cfg, obs, info, done, feat0)
        traj = Trajectory(*(torch.stack(x) for x in zip(*outs)))
        last_value = pol.policy_apply(cfg, params, feats)[2]
        return env_states, feats, traj, last_value

    return collect


def initial_features(env, cfg: pol.PolicyConfig, obs_batch):
    """Features for a fresh ``reset_batch`` observation (zero KPI block)."""
    return pol.features(cfg, obs_batch)

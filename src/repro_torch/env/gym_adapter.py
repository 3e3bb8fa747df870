"""Optional gymnasium adapter for :class:`~repro_torch.env.crrm_env.CrrmEnv`.

Wraps one episode stream of the functional env in the stateful
``gymnasium.Env`` protocol (``reset``/``step`` with numpy i/o and Box
spaces).  gymnasium is not a dependency of the port: importing this module
is cheap, and :func:`make_gym_env` raises a clear ``ImportError`` only when
called without gymnasium installed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.env.crrm_env import CrrmEnv

#: stand-in for +inf in observation bounds (throughput, backlog are
#: unbounded above; full-buffer backlog is genuinely inf and is clamped)
_OBS_HIGH = np.float32(3.4e38)


def flatten_obs(obs) -> np.ndarray:
    """EnvObs -> flat (2 * n_ues,) float32 vector (backlog inf clamped)."""
    tput = obs.tput.detach().cpu().numpy().astype(np.float32)
    backlog = np.minimum(obs.backlog.detach().cpu().numpy().astype(
        np.float32), _OBS_HIGH)
    return np.concatenate([tput, backlog])


def make_gym_env(env: CrrmEnv, seed: int = 0):
    """Wrap a functional ``CrrmEnv`` in a ``gymnasium.Env``.

    Observation: ``Box(0, inf, (2 * n_ues,))`` -- per-UE delivered
    throughput then residual backlog.  Action: ``Box(0, power_W,
    (n_cells, n_subbands))`` transmit powers in watts.  Episode end is
    reported as ``truncated`` (a time horizon, not a terminal MDP state).
    Each reset draws the next episode seed from a numpy generator seeded
    with ``seed``.  A ``CrrmEnv(..., telemetry=True)`` surfaces
    ``info["telemetry"]`` and its ``summarize`` reduction
    ``info["kpis"]``, plus the reward decomposition under ``reward/...``.
    """
    try:
        import gymnasium
        from gymnasium import spaces
    except ImportError as e:     # pragma: no cover - exercised without gym
        raise ImportError(
            "gymnasium is required for the adapter: pip install gymnasium "
            "(the functional CrrmEnv works without it)") from e

    from repro_torch.obs import summarize

    class GymCrrmEnv(gymnasium.Env):
        metadata = {"render_modes": []}

        def __init__(self, fenv: CrrmEnv, seed: int):
            self._env = fenv
            self._rng = np.random.default_rng(seed)
            self._state = None
            n = fenv.n_ues
            self.observation_space = spaces.Box(
                low=0.0, high=_OBS_HIGH, shape=(2 * n,), dtype=np.float32)
            self.action_space = spaces.Box(
                low=0.0, high=fenv.max_cell_power_W,
                shape=fenv.action_shape, dtype=np.float32)

        def reset(self, *, seed=None, options=None):
            # gymnasium contract: seed=None continues the seed stream (a
            # fresh stochastic episode per reset); an explicit seed
            # restarts it reproducibly.
            super().reset(seed=seed)
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            ep_seed = int(self._rng.integers(0, 2**31 - 1))
            self._state, obs = self._env.reset(ep_seed)
            return flatten_obs(obs), {}

        def step(self, action):
            action = np.clip(np.asarray(action, np.float32),
                             self.action_space.low, self.action_space.high)
            out = self._env.step(self._state, action)
            self._state, obs, reward, done = out[:4]
            info = {}
            if self._env.telemetry:
                telem = out[4]["telemetry"]
                kpis = summarize(telem, tti_s=self._env.params.tti_s)
                for k, v in out[4]["reward_components"].items():
                    v = v.detach().cpu().numpy()
                    kpis[f"reward/{k}"] = float(v) if v.ndim == 0 else v
                info = {"telemetry": telem, "kpis": kpis}
            return (flatten_obs(obs), float(reward), False, bool(done), info)

    return GymCrrmEnv(env, seed)

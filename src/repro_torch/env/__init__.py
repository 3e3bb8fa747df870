"""Gym-style environment API over the CRRM episode engine.

``CrrmEnv`` (``crrm_env.py``) is the functional core: ``reset``/``step``
over an explicit ``EpisodeState``.  The optional ``gym_adapter`` wraps it in
the stateful ``gymnasium.Env`` protocol (gymnasium is imported only when
the adapter is built).
"""
from repro_torch.env.crrm_env import (CrrmEnv, EnvObs,  # noqa: F401
                                      TopoEnvState, buffer_aware_reward)

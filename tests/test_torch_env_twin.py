"""The port's ``CrrmEnv`` against the JAX package on ``dense_urban_twin``: the env
episode of ``torch_parity.check_env_episode``, to the contract of
tests/test_torch_env.py (which splits the presets over four files by
``torch_parity.ENV_GROUPS``).
"""
import pytest

from torch_parity import ENV_GROUPS, check_env_episode


@pytest.mark.parametrize("name", ENV_GROUPS["test_torch_env_twin"])
def test_env_episode_matches_reference(name):
    check_env_episode(name)

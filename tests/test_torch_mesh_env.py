"""``CrrmEnv(mesh=)`` and PPO collection on a mesh env.

Two gloo ranks (``tests/torch_mesh.py``) step ``dense_urban`` at 16 UEs on
a UE mesh of 2 against the same env on one device, both on the port's own
draws (every rank draws at global shape and keeps its rows): pf at full
buffer, so floats within rtol 1e-5 (the cross-shard sums reorder a float
reduction; under bursty traffic an ulp residue could flip a
backlog-active mask) and integers exact -- the state, the observation,
the reward and the telemetry.  The batch surfaces raise under a mesh, and
one unbatched PPO collection step (``n_envs == 1``) on the mesh env
equals the single env's batch of one; two streams raise.
"""
import numpy as np
import pytest
import torch

from repro_torch.env.crrm_env import CrrmEnv
from repro_torch.rl import policy as pol
from repro_torch.rl.rollout import (RolloutDraws, initial_features,
                                    make_collect_fn)
from torch_mesh import run_ranks, same_on_every_rank
from torch_parity import np_

ENV_KW = dict(scenario="dense_urban",
              scenario_overrides=dict(n_ues=16, traffic_model="full_buffer"),
              episode_tti=6, tti_per_step=3, telemetry=True)
SEED, N_STEPS = 4, 2


def close(got, want, what):
    """Integers and booleans exact, floats rtol 1e-5 (atol 1e-3)."""
    if want is None:
        assert got is None, what
        return
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, f"{what}/{getattr(want, '_fields', range(99))[i]}")
        return
    got, want = np.asarray(got), np_(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = CrrmEnv(device="cpu", **ENV_KW)
    state, _ = env.reset(SEED)
    steps = []
    for _ in range(N_STEPS):
        state, obs, reward, done, info = env.step(state)
        steps.append((state, obs, reward, done, info["telemetry"]))
    cfg = pol.PolicyConfig(n_cells=env.n_cells, n_subbands=env.n_subbands,
                           power_W=env.max_cell_power_W)
    params = pol.init_policy(torch.Generator().manual_seed(0), cfg)
    states, obs = env.reset_batch([SEED])
    ppo = make_collect_fn(env, cfg, 1)(params, states,
                                       initial_features(env, cfg, obs),
                                       RolloutDraws(SEED, "cpu"), 0)
    job = dict(name="env", env_kw=ENV_KW, seed=SEED, n_steps=N_STEPS,
               policy=(cfg, params))
    outs = run_ranks(job, 2, tmp_path_factory.mktemp("mesh_env"))
    return outs, steps, ppo


@pytest.mark.parametrize("i", range(N_STEPS))
def test_mesh_env_step_matches_single_env(runs, i):
    outs, steps, _ = runs
    for what, got, want in zip(("state", "obs", "reward", "done",
                                "telemetry"), outs[0]["steps"][i], steps[i]):
        close(got, want, what)


def test_batch_surfaces_raise_under_a_mesh(runs):
    errors = runs[0][0]["batch_errors"]
    assert len(errors) == 2
    assert all("batch over seeds OR shard over UEs" in e for e in errors)


def test_ppo_collection_on_a_mesh_env_matches_single_env(runs):
    outs, _, (states, feats, traj, last) = runs
    m_state, m_feats, m_traj, m_last = outs[0]["ppo"]
    # the single env's batch of one, without its batch axis
    close(m_state, type(states)(*(None if x is None else x[0]
                                  for x in states)), "state")
    close(m_feats, feats, "feats")
    close(m_traj, tuple(traj), "trajectory")
    close(m_last, last, "last_value")
    assert "n_envs == 1" in outs[0]["ppo_error"]


def test_every_rank_returns_the_same_bits(runs):
    same_on_every_rank(runs[0])

"""PPO collection at ``dense_urban``'s own load against the eager reference.

At the scenario's 400 arrivals/s a UE's backlog drains within the first
step, where the compiled reference leaves a sub-bit residue that the port
and the eager reference do not (ROADMAP queue 3).  So the reference
collects here eagerly (``jax.disable_jit``), one step of two envs (the
eager program compiles per primitive; ~35 s): the trajectory's leaves
rtol 1e-5 (atol 1e-5), ``done`` exact, GAE rtol 1e-4, as in
``tests/test_torch_rl_ppo.py``, which holds the whole iteration at the
recipe's saturating load.
"""
import jax
import numpy as np

from repro.rl import ppo as j_ppo
from repro.rl import rollout as j_ro
from repro_torch.rl import policy as t_pol
from repro_torch.rl import ppo as t_ppo
from test_torch_rl_ppo import (ReplayRollout, check_collection,
                               port_train_state, ppo_pair)
from torch_parity import np_


def test_ppo_collection_at_the_scenario_load_matches_eager_reference():
    ref, port, table, pcfg, cfg = ppo_pair(dict(n_ues=8), n_steps=1)
    assert ref.sim.params.traffic_params["arrival_rate_hz"] == 400.0
    jcfg = j_ppo.PPOConfig(**cfg._asdict())
    ts_j = j_ppo.ppo_init(ref, pcfg, jcfg, seed=0)
    k_roll = jax.random.split(ts_j.key)[1]
    with jax.disable_jit():
        out_j = j_ro.make_collect_fn(ref, pcfg, cfg.n_steps)(
            ts_j.params, ts_j.env_states, ts_j.feats, k_roll)
    traj_j, last_j = out_j[2], out_j[3]
    adv_j, ret_j = j_ppo.gae(traj_j.reward, traj_j.value, traj_j.done,
                             last_j, cfg.gamma, cfg.gae_lambda)

    ts_t = port_train_state(ts_j, table)
    replay = ReplayRollout(ts_j.key, cfg.n_steps, cfg.n_envs,
                           t_pol.action_dim(pcfg), table)
    traj_t, last_t = check_collection(port, pcfg, cfg, ts_t, replay, traj_j,
                                      last_j)
    adv_t, ret_t = t_ppo.gae(traj_t.reward, traj_t.value, traj_t.done,
                             last_t, cfg.gamma, cfg.gae_lambda)
    np.testing.assert_allclose(np_(adv_t), np_(adv_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np_(ret_t), np_(ret_j), rtol=1e-4, atol=1e-5)

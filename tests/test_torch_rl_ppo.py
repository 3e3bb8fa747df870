"""One PPO iteration of the port against the JAX package's.

``make_train_step`` from the reference's initial state, carried over with
``repro_torch.convert``, with the reference's action noise and reset keys
replayed (``ReplayRollout``; the port's integer episode seeds index the
reference's keys, ``KeyTable``).  Contract: the trajectory's leaves rtol
1e-5 (atol 1e-5), ``done`` exact; GAE's advantages and returns, the loss
metrics and the params and Adam moments after the four epochs rtol 1e-4
(atol 1e-5: Adam divides by sqrt(nu), which amplifies the rounding of
small gradients).

The env takes the traffic of ``train_power_baseline``'s recipe, past the
serveable load.  At ``dense_urban``'s own 400/s, a UE's backlog drains,
and the compiled reference's drained-backlog residue (ROADMAP queue 3)
parts it from the port within the first step; the eager reference agrees
with the port there (``tests/test_torch_rl_ppo_drained.py``).
"""
import jax
import numpy as np
import torch

from repro.env.crrm_env import CrrmEnv as JEnv
from repro.rl import ppo as j_ppo
from repro.rl import rollout as j_ro
from repro_torch import convert
from repro_torch import rl as t_rl
from repro_torch.env.crrm_env import CrrmEnv as TEnv
from repro_torch.rl import policy as t_pol
from repro_torch.rl import ppo as t_ppo
from test_torch_rl import ENV, assert_tree_close, jtree_np, pcfg_of, t_
from torch_parity import DEV, ReplayDraws, np_, port_of

#: the traffic of ``train_power_baseline``'s recipe: arrivals past the
#: serveable load, so no backlog drains to a sub-bit residue
SATURATED = dict(n_ues=8, traffic_params=dict(arrival_rate_hz=2000.0,
                                              packet_size_bits=12_000.0))


class KeyTable:
    """Reference PRNG keys behind the port's integer episode seeds: the
    port env's episode ``i`` replays the reference episode of key ``i``."""

    def __init__(self, ref_sim):
        self.keys, self.ref_sim = [], ref_sim

    def seed_of(self, key) -> int:
        self.keys.append(key)
        return len(self.keys) - 1

    def draws(self, seed, device):
        return ReplayDraws(self.keys[seed], self.ref_sim)


class ReplayRollout:
    """The reference train step's action noise and reset keys, from
    ``TrainState.key`` as ``repro.rl.ppo``/``rollout`` split it, in the
    interface of ``repro_torch.rl.rollout.RolloutDraws``."""

    def __init__(self, key, n_steps, n_envs, n_act, table):
        _, k_roll = jax.random.split(key)
        self.noise, self.seeds = [], []
        for k in jax.random.split(k_roll, n_steps):
            pairs = [jax.random.split(kk) for kk in jax.random.split(k,
                                                                     n_envs)]
            self.noise.append(np.stack([np_(jax.random.normal(p[0],
                                                              (n_act,)))
                                        for p in pairs]))
            self.seeds.append([table.seed_of(p[1]) for p in pairs])

    def action_noise(self, iteration, step, shape):
        assert iteration == 0 and tuple(shape) == self.noise[step].shape
        return t_(self.noise[step])

    def reset_seeds(self, iteration, step, n):
        return self.seeds[step]


def ppo_pair(overrides=SATURATED, n_steps=4):
    """The reference's tiny PPO setup of ``tests/test_rl.py`` and the port
    env on its roots, replaying its draws."""
    ref = JEnv(scenario="dense_urban", scenario_overrides=overrides, **ENV)
    table = KeyTable(ref.sim)
    port = TEnv(sim=port_of(ref.sim), draws=table.draws, **ENV)
    pcfg = pcfg_of(port)
    return ref, port, table, pcfg, t_ppo.PPOConfig(n_envs=2, n_steps=n_steps)


def port_train_state(ts_j, table):
    """The reference's ``TrainState`` in the port's form, its env keys
    entered in ``table``."""
    states = {k: np_(v) for k, v in ts_j.env_states._asdict().items()
              if v is not None and k != "key"}
    states["seed"] = [table.seed_of(k) for k in ts_j.env_states.key]
    st = convert.episode_state(states, DEV)
    return t_ppo.TrainState(
        params=convert.policy_params(jtree_np(ts_j.params), DEV),
        opt_state=convert.adamw_state(jtree_np(ts_j.opt_state), DEV),
        env_states=st._replace(seed=st.seed.to(torch.int64)),
        feats=t_(ts_j.feats), seed=torch.tensor(0, dtype=torch.int64),
        iteration=torch.tensor(0, dtype=torch.int32))


def check_collection(port, pcfg, cfg, ts_t, replay, traj_j, last_j):
    """The port's collection from ``ts_t`` on the replayed draws against
    the reference's ``(traj_j, last_j)``: every leaf rtol 1e-5 (atol
    1e-5), ``done`` exact.  Returns the port's ``(traj, last)``."""
    collect = t_rl.make_collect_fn(port, pcfg, cfg.n_steps)
    _, _, traj_t, last_t = collect(ts_t.params, ts_t.env_states, ts_t.feats,
                                   replay, 0)
    for f in ("feat", "u", "logp", "value", "reward"):
        np.testing.assert_allclose(np_(getattr(traj_t, f)),
                                   np_(getattr(traj_j, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(np_(traj_t.done), np_(traj_j.done))
    np.testing.assert_allclose(np_(last_t), np_(last_j), rtol=1e-5,
                               atol=1e-5)
    return traj_t, last_t


def test_one_ppo_iteration_matches_reference():
    ref, port, table, pcfg, cfg = ppo_pair()
    jcfg = j_ppo.PPOConfig(**cfg._asdict())
    ts_j = j_ppo.ppo_init(ref, pcfg, jcfg, seed=0)
    k_roll = jax.random.split(ts_j.key)[1]
    out_j = j_ro.make_collect_fn(ref, pcfg, cfg.n_steps)(
        ts_j.params, ts_j.env_states, ts_j.feats, k_roll)
    traj_j, last_j = out_j[2], out_j[3]
    adv_j, ret_j = j_ppo.gae(traj_j.reward, traj_j.value, traj_j.done,
                             last_j, cfg.gamma, cfg.gae_lambda)
    ts_j1, m_j = j_ppo.make_train_step(ref, pcfg, jcfg)(ts_j)

    ts_t = port_train_state(ts_j, table)
    replay = ReplayRollout(ts_j.key, cfg.n_steps, cfg.n_envs,
                           t_pol.action_dim(pcfg), table)

    # the collection and GAE alone
    traj_t, last_t = check_collection(port, pcfg, cfg, ts_t, replay, traj_j,
                                      last_j)
    adv_t, ret_t = t_ppo.gae(traj_t.reward, traj_t.value, traj_t.done,
                             last_t, cfg.gamma, cfg.gae_lambda)
    np.testing.assert_allclose(np_(adv_t), np_(adv_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np_(ret_t), np_(ret_j), rtol=1e-4, atol=1e-5)

    # the whole iteration: collection, GAE and four Adam epochs
    step = t_ppo.make_train_step(port, pcfg, cfg,
                                 draws=lambda seed, device: replay)
    ts_t1, m_t = step(ts_t)
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert_tree_close(ts_t1.params, ts_j1.params, rtol=1e-4, atol=1e-5)
    assert_tree_close(ts_t1.opt_state, ts_j1.opt_state, rtol=1e-4,
                      atol=1e-5)
    assert int(ts_t1.iteration) == 1
    np.testing.assert_allclose(np_(ts_t1.feats), np_(ts_j1.feats),
                               rtol=1e-5, atol=1e-5)

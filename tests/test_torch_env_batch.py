"""The env batch axis (``reset_batch`` / ``step_batch`` /
``step_autoreset_batch``) and the batched MAC against the JAX package.

Mirrors the reference's batch cases (tests/test_env.py): deterministic
batched trajectories, batch row b == the single episode b, batched
topologies that differ.  The port's batch is an explicit leading axis:
each env runs its radio side on its own draws at its own TTI, and the
MAC of all envs runs at once through flat-id segment reductions.
Contracts: row b of a batch equals the single episode of seed b bit for
bit on the CPU (``index_add_`` adds in index order there); the batch
against the reference's ``jit(vmap)`` batch on replayed draws, one
reference key per env, as ``torch_parity.check_env_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.env.crrm_env import CrrmEnv as JEnv
from repro.mac import scheduler as j_sched
from repro.mac import segments as j_seg
from repro.sim import scenarios as j_scen
from repro_torch.env.crrm_env import CrrmEnv as TEnv
from repro_torch.mac import scheduler as t_sched
from repro_torch.mac import segments as t_seg
from repro_torch.sim.mobility import ChurnConfig
from torch_parity import (check_env_step, check_state, env_draws, np_,
                          port_of)

ENV = dict(tti_per_step=2, episode_tti=4, telemetry=True, device="cpu")
SEEDS = [3, 7, 11, 2 ** 31]


def leaves_equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def row(tup, b):
    return type(tup)(*(None if x is None else x[b] for x in tup))


def ep(state):
    return state.ep if hasattr(state, "ep") else state


def assert_rows_are_single_episodes(env, seeds, states, out, single_states,
                                    act=None, fair=None):
    """Row b of a batched step equals ``step`` of env b, bit for bit."""
    s_b, o_b, r_b, d_b, i_b = out
    for b, s in enumerate(single_states):
        a = None if act is None else act[b]
        f = None if fair is None else fair[b]
        s1, o1, r1, d1, i1 = env.step(s, a, f)
        assert leaves_equal(row(ep(s_b), b), ep(s1)), b
        if hasattr(s1, "static"):
            assert leaves_equal(row(s_b.static, b), s1.static)
        assert torch.equal(o_b.tput[b], o1.tput)
        assert torch.equal(o_b.backlog[b], o1.backlog)
        assert torch.equal(r_b[b], r1) and bool(d_b[b]) == bool(d1)
        assert leaves_equal(row(i_b["telemetry"], b), i1["telemetry"])
        for k, v in i1["reward_components"].items():
            assert torch.equal(i_b["reward_components"][k][b], v), k


@pytest.mark.parametrize("name,kw", [
    ("dense_urban_twin", {}),                  # incremental, A3, HARQ
    ("outage_storm", {}),                      # faults, A3, fading
    ("dense_urban", dict(churn=ChurnConfig(400.0, 0.1, 6))),
    ("rural_macro", dict(resample_topology=True)),
    ("handover_stress", dict(per_tti_fading=True)),
])
def test_batch_row_matches_single_episode(name, kw):
    """Each row of ``reset_batch`` + ``step_batch`` (with B actions and B
    fairness overrides) is ``reset(seed_b)`` + ``step``, bitwise."""
    env = TEnv(scenario=name, scenario_overrides=dict(n_ues=60), **ENV,
               **kw)
    states, obs = env.reset_batch(SEEDS)
    assert states is not None and obs.tput.shape == (4, 60)
    singles = [env.reset(s)[0] for s in SEEDS]
    for b, s in enumerate(singles):
        assert leaves_equal(row(ep(states), b), ep(s))
    rng = np.random.default_rng(1)
    act = torch.tensor(rng.uniform(0.0, env.max_cell_power_W,
                                   (4,) + env.action_shape), dtype=torch.float32)
    fair = [0.1, 0.5, 0.9, 0.3]
    out = env.step_batch(states, act, fair)
    assert_rows_are_single_episodes(env, SEEDS, states, out, singles, act,
                                    fair)
    assert out[1].tput.shape == (4, 60) and out[2].shape == (4,)
    e = ep(out[0])
    assert any(not torch.equal(x[0], x[1])          # the envs differ
               for x in (e.backlog, e.pf_avg, e.U, out[1].tput))


def test_batched_reset_step_is_deterministic():
    """Same seeds -> bit-identical batched trajectories, run to run."""
    env = TEnv(scenario="dense_urban", scenario_overrides=dict(
        n_ues=30, harq_bler=0.2), **dict(ENV, episode_tti=6))

    def run():
        states, obs = env.reset_batch(torch.arange(8))
        rews = []
        for _ in range(3):
            states, obs, rew, done, _ = env.step_batch(states)
            rews.append(rew)
        return torch.stack(rews), obs.tput, done

    r1, t1, d1 = run()
    r2, t2, d2 = run()
    assert torch.equal(r1, r2) and torch.equal(t1, t2)
    assert d1.shape == (8,) and bool(d1.all()) and torch.equal(d1, d2)


def test_autoreset_batch_keeps_a_tti_counter_per_env():
    """Envs at different TTIs: the finished env restarts from its reset
    seed while the others run on, each on the draws of its own TTI; every
    row stays the single episode bit for bit."""
    env = TEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=40),
               **ENV)
    stepped = env.step_batch(env.reset_batch([1, 2])[0])[0]   # t = 2, 2
    fresh, _ = env.reset_batch([5, 6])                         # t = 0, 0
    states = type(stepped)(*(None if x is None else torch.stack([x[0], y[1]])
                             for x, y in zip(stepped, fresh)))
    assert states.t.tolist() == [2, 0]
    s_ar, obs, rew, done, _ = env.step_autoreset_batch(states, None, [8, 9])
    assert done.tolist() == [True, False]
    assert s_ar.t.tolist() == [0, 2] and s_ar.seed.tolist() == [8, 6]
    assert leaves_equal(row(s_ar, 0), env.reset(8)[0])
    single = env.step(row(states, 1))
    assert leaves_equal(row(s_ar, 1), single[0])
    assert torch.equal(obs.tput[0], env.step(row(states, 0))[1].tput)
    # next window: env 0 at t=0 of seed 8, env 1 at t=2 of seed 6
    out = env.step_batch(s_ar)
    assert_rows_are_single_episodes(env, [8, 6], s_ar, out,
                                    [row(s_ar, 0), row(s_ar, 1)])
    assert out[3].tolist() == [False, True]


def test_batch_matches_reference_vmap():
    """The port's batch against the reference's ``jit(vmap)`` batch of the
    same presets on replayed draws (one reference key per env)."""
    for name in ("dense_urban_twin", "outage_storm"):
        params = j_scen.make_scenario(name, n_ues=24, n_cells=6,
                                      traffic_model="full_buffer")
        kw = dict(episode_tti=2, tti_per_step=1, telemetry=True)
        ref = JEnv(params=params, **kw)
        port = TEnv(sim=port_of(ref.sim), draws=env_draws(ref), **kw)
        seeds = [3, 4, 5]
        keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
        sj, _ = ref.reset_batch(keys)
        st, _ = port.reset_batch(seeds)
        check_state(st, sj)
        acts = np.stack([np_(ref.uniform_action())] * 3)
        out_j = ref.step_batch(sj, jnp.asarray(acts))
        out_t = port.step_batch(st, torch.tensor(acts))
        for b in range(3):
            check_env_step(tuple(row(x, b) if isinstance(x, tuple) else
                                 ({"telemetry": row(x["telemetry"], b),
                                   "reward_components": {
                                       k: v[b] for k, v in
                                       x["reward_components"].items()}}
                                  if isinstance(x, dict) else x[b])
                                 for x in out_t),
                           tuple(jax.tree_util.tree_map(lambda v: v[b], x)
                                 for x in out_j))


def test_topology_batched_step_runs_and_varies_across_topologies():
    env = TEnv(scenario="dense_urban", scenario_overrides=dict(
        n_ues=40, harq_bler=0.2), resample_topology=True,
        **dict(ENV, episode_tti=3, tti_per_step=1))
    states, _ = env.reset_batch([7, 8, 9, 10, 11, 12])
    assert states.ep.U.shape == (6, 40, 3)
    assert not torch.equal(states.ep.U[0], states.ep.U[1])
    states, obs, rew, done, _ = env.step_batch(states)
    assert obs.tput.shape == (6, 40) and torch.isfinite(obs.tput).all()
    assert float(rew.std()) > 0 and not bool(done.any())
    for _ in range(2):
        states, obs, rew, done, _ = env.step_batch(states)
    assert bool(done.all())
    with pytest.raises(ValueError, match="resample_topology"):
        env.step_autoreset_batch(states, None, [1] * 6)


@pytest.mark.parametrize("n_freq", [1, 3])
def test_flat_id_segment_reductions_match_unbatched(n_freq):
    """B envs through one flat reduction == B unbatched ones, bitwise on
    the CPU; unbatched == the reference's segment reductions."""
    rng = np.random.default_rng(0)
    B, n, m = 5, 300, 7
    seg = torch.tensor(rng.integers(0, m, (B, n)), dtype=torch.int32)
    data = torch.tensor(rng.standard_normal((B, n, n_freq)),
                        dtype=torch.float32)
    s_b = t_seg.segment_sum(data, seg, m)
    x_b = t_seg.segment_max(data, seg, m, fill=-1.0)
    assert s_b.shape == x_b.shape == (B, m, n_freq)
    for b in range(B):
        assert torch.equal(s_b[b], t_seg.segment_sum(data[b], seg[b], m))
        assert torch.equal(x_b[b], t_seg.segment_max(data[b], seg[b], m,
                                                     fill=-1.0))
        assert torch.equal(t_seg.take(s_b, seg)[b], s_b[b][seg[b].long()])
    np.testing.assert_allclose(
        np_(t_seg.segment_sum(data[0], seg[0], m)),
        np_(j_seg.segment_sum(jnp.asarray(np_(data[0])),
                              jnp.asarray(np_(seg[0])), m)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(
        np_(t_seg.segment_max(data[0], seg[0], m, fill=-1.0)),
        np_(j_seg.segment_max(jnp.asarray(np_(data[0])),
                              jnp.asarray(np_(seg[0])), m, fill=-1.0)))


@pytest.mark.parametrize("policy", ["rr", "max_cqi", "pf"])
def test_batched_allocation_matches_per_env(policy):
    """Every policy with a leading batch axis: row b == the unbatched
    allocation of env b (bitwise), which equals the reference's."""
    rng = np.random.default_rng(2)
    B, n, m, k = 4, 200, 6, 3
    active = torch.tensor(rng.random((B, n, k)) < 0.7)
    cqi = torch.tensor(rng.integers(0, 16, (B, n, k)), dtype=torch.int32)
    a = torch.tensor(rng.integers(0, m, (B, n)), dtype=torch.int32)
    log_w = torch.tensor(rng.standard_normal((B, n, k)), dtype=torch.float32)
    cursor = torch.tensor([0, 3, 7, 12], dtype=torch.int32)
    got = t_sched.allocate(policy, active, cqi, a, m, 25, cursor, log_w)
    assert got.shape == (B, n, k)
    for b in range(B):
        one = t_sched.allocate(policy, active[b], cqi[b], a[b], m, 25,
                               cursor[b], log_w[b])
        assert torch.equal(got[b], one)
        want = j_sched.allocate(policy, jnp.asarray(np_(active[b])),
                                jnp.asarray(np_(cqi[b])),
                                jnp.asarray(np_(a[b])), m, 25,
                                jnp.int32(int(cursor[b])),
                                jnp.asarray(np_(log_w[b])))
        np.testing.assert_allclose(np_(one), np_(want), rtol=1e-5,
                                   atol=1e-5)

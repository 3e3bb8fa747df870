"""The port's scenario registry and ``CrrmEnv`` against the JAX package.

Registry: ``make_scenario`` equal field by field for every name.  Env
(``torch_parity.env_pair``): the port's ``CrrmEnv`` wraps a ``CRRM`` on
the reference env's roots and replays the reference env's draws through
its ``draws=`` factory (the port's reset seed ``s`` is the reference's
``PRNGKey(s)``).  Under bursty traffic the reference steps eagerly
(``jax.disable_jit``, see tests/test_torch_engine.py).  Contract
(``torch_parity.check_env_step``): states as ``check_state``, telemetry as
``check_telemetry``; obs, reward and reward components rtol 1e-4; ``done``
exact.  The episode check's presets are split over four files by
``torch_parity.ENV_GROUPS`` (this one, ``_twin``, ``_handover`` and
``_scenarios``): the eager reference compiles each preset's primitives
anew, and each file stays under a minute.  The resampled reset is tested
in tests/test_torch_env_topology.py.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.env.crrm_env import expand_action as j_expand
from repro.sim import scenarios as j_scen
from repro_torch.core.crrm import CRRM
from repro_torch.env.crrm_env import CrrmEnv as TEnv
from repro_torch.env.crrm_env import expand_action as t_expand
from repro_torch.mac.engine import Draws
from repro_torch.sim import faults as t_faults
from repro_torch.sim import scenarios as t_scen
from torch_parity import (ENV_GROUPS, RUNNABLE_SCENARIOS, check_env_episode,
                          np_)


def test_registry_matches_reference_field_by_field():
    assert t_scen.scenario_names() == j_scen.scenario_names()
    assert len(t_scen.scenario_names()) == 7
    for name in j_scen.scenario_names():
        assert t_scen.scenario_description(name) == \
            j_scen.scenario_description(name)
        for ov in ({}, dict(n_ues=17, seed=5)):
            j, t = j_scen.make_scenario(name, **ov), \
                t_scen.make_scenario(name, **ov)
            for f in dataclasses.fields(j):
                a, b = getattr(j, f.name), getattr(t, f.name)
                if f.name == "faults" and a is not None:
                    assert isinstance(b, t_faults.FaultConfig)
                    assert tuple(a) == tuple(b) and a._fields == b._fields
                else:
                    assert a == b, (name, f.name)
    with pytest.raises(ValueError, match="unknown scenario"):
        t_scen.make_scenario("nope")
    with pytest.raises(ValueError, match="already registered"):
        t_scen.register_scenario("dense_urban", "x", lambda **k: None)


def test_fault_config_validation_matches_reference():
    from repro.core.params import CRRM_parameters as JParams
    from repro.sim import faults as j_faults
    from repro_torch.core.params import CRRM_parameters as TParams
    for kw in (dict(outage_rate_hz=-1.0), dict(mean_sleep_s=0.0),
               dict(outage_rate_hz=2000.0), dict(mean_outage_s=1e-4)):
        with pytest.raises(ValueError):
            JParams(faults=j_faults.FaultConfig(**kw))
        with pytest.raises(ValueError):
            TParams(faults=t_faults.FaultConfig(**kw))
    with pytest.raises(ValueError, match="FaultConfig"):
        TParams(faults=object())
    assert t_faults.FaultConfig() == tuple(j_faults.FaultConfig())


def test_outage_storm_builds_but_raises_when_run():
    """The preset builds and, since the faults slice, runs: the engine and
    the env take its fault process by default (this test raised
    ``NotImplementedError`` before the process was ported)."""
    p = t_scen.make_scenario("outage_storm", n_ues=10)
    assert p.faults.outage_rate_hz == 5.0
    sim = CRRM(p, device="cpu")
    _, _, telem = sim.episode_fns(telemetry=True).rollout(
        sim.episode_static(), sim.init_episode_state(), 3, Draws(0, "cpu"))
    assert telem.cells_down.shape == (3,)
    env = TEnv(scenario="outage_storm", scenario_overrides=dict(n_ues=10),
               device="cpu", telemetry=True)
    s, _ = env.reset(0)
    s, _, _, _, info = env.step(s)
    assert s.cell_state.shape == (env.n_cells,)
    assert info["telemetry"].reattach_events is not None


@pytest.mark.parametrize("name", ENV_GROUPS["test_torch_env"])
def test_env_episode_matches_reference(name):
    """``torch_parity.check_env_episode``: reset, a uniform step, a
    random-action step with a fairness override (reaching ``done``), then
    ``step_autoreset`` across the episode boundary."""
    check_env_episode(name)


def test_env_groups_cover_every_runnable_preset():
    """The env files together run the episode check on every preset the
    reference env steps, each preset once (the resampled reset runs on
    all of them in tests/test_torch_env_topology.py)."""
    names = [n for group in ENV_GROUPS.values() for n in group]
    assert sorted(names) == sorted(RUNNABLE_SCENARIOS)
    for f in ENV_GROUPS:
        assert (Path(__file__).parent / f"{f}.py").is_file(), f


@pytest.mark.parametrize("n_rb_subbands", [1, 4])
def test_expand_action_matches_reference(n_rb_subbands):
    params = j_scen.make_scenario("dense_urban", n_ues=8, n_cells=6,
                                  n_rb_subbands=n_rb_subbands)
    rng = np.random.default_rng(n_rb_subbands)
    for scale in (0.1, 1.0, 5.0):       # under, near and over the budget
        act = rng.uniform(0, scale * params.power_W,
                          (6, params.n_subbands)).astype(np.float32)
        got = t_expand(params, act)
        want = j_expand(params, jnp.asarray(act))
        assert tuple(got.shape) == (6, params.n_freq)
        np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6)


def test_autoreset_selects_leaf_by_leaf_and_later_slices_raise():
    env = TEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=16),
               episode_tti=2, tti_per_step=1, device="cpu")
    s, _ = env.reset(1)
    s1 = env.step_autoreset(s, None, 9)[0]       # t=1: not done, stepped
    assert int(s1.t) == 1 and int(s1.seed) == 1
    s2, _, _, done = env.step_autoreset(s1, None, 9)
    fresh, _ = env.reset(9)
    assert bool(done) and int(s2.t) == 0 and int(s2.seed) == 9
    for a, b in zip(s2, fresh):
        assert (a is None and b is None) or torch.equal(a, b)
    # the batch surfaces run (tests/test_torch_env_batch.py); churn with a
    # resampled topology is refused as in the reference; a mesh must be a
    # core.distributed.Mesh (tests/test_torch_mesh_env.py)
    states, _ = env.reset_batch(np.arange(2))
    assert env.step_batch(states)[0].t.tolist() == [1, 1]
    with pytest.raises(ValueError, match="resample_topology"):
        TEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=4),
             device="cpu", resample_topology=True, churn=object())
    with pytest.raises(TypeError, match="Mesh"):
        TEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=4),
             device="cpu", mesh=object())
    with pytest.raises(ValueError, match="exactly one"):
        TEnv(device="cpu")
    with pytest.raises(ValueError, match="reset_seed"):
        env.step_autoreset(s, None)


def test_env_defaults_to_the_card_and_draws_from_its_seed():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEnv(scenario="rural_macro", scenario_overrides=dict(n_ues=4))
    env = TEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=12),
               tti_per_step=3, device="cpu")
    a = env.step(env.reset(4)[0])
    b = env.step(env.reset(4)[0])
    c = env.step(env.reset(5)[0])
    assert torch.equal(a[1].tput, b[1].tput)
    assert not torch.equal(a[1].tput, c[1].tput)
    # a resampled reset draws its field from the same seed's Draws
    envr = TEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=12),
                resample_topology=True, device="cpu")
    u = envr.reset(4)[0].ep.U
    assert torch.equal(u, Draws(4, "cpu").topology(12, 1200.0, 1.5))


def test_gym_adapter_wraps_the_env():
    pytest.importorskip("gymnasium")
    from repro_torch.env.gym_adapter import flatten_obs, make_gym_env
    env = TEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=10),
               episode_tti=4, tti_per_step=2, telemetry=True, device="cpu")
    g = make_gym_env(env, seed=3)
    obs, info = g.reset(seed=1)
    assert obs.shape == (20,) and obs.dtype == np.float32 and info == {}
    obs2, _ = g.reset(seed=1)
    np.testing.assert_array_equal(obs, obs2)
    obs, reward, term, trunc, info = g.step(g.action_space.sample())
    assert g.observation_space.contains(obs) and not term and not trunc
    assert isinstance(reward, float)
    assert {"served_mbits", "mean_jain", "reward/goodput_term"} <= set(
        info["kpis"])
    assert info["kpis"]["reward/cell_tput_mbps"].shape == (env.n_cells,)
    _, _, _, trunc, _ = g.step(g.action_space.sample())
    assert trunc
    s, o = env.reset(0)
    assert flatten_obs(o)[10:].max() == 0.0

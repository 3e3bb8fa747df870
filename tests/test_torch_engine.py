"""The port's TTI engine against the JAX package: whole trajectories.

Both engines start from the same ``EpisodeStatic``/``EpisodeState``
(carried over with ``repro_torch.convert``) and the port replays the
reference's own random draws (``ReplayDraws``: the reference's mobility,
fading, traffic and HARQ draws on ``radio.tti_keys(key, t)``).
Under bursty traffic the reference rolls out eagerly (``jax.disable_jit``):
compiled, XLA fuses the TTI body and rounds the drained backlog
differently (an ulp residue of ~1e-3 bits where the eager ops -- and the
port -- leave 0), and such a residue flips a UE's active mask so the
trajectory diverges, as ``repro.mac.engine``'s docstring notes for any
reordering.  Full-buffer backlogs are infinite, so those run compiled.
Tolerances: per-TTI throughput rtol 1e-4 (sum order of the per-cell PF
shares and ulps of the radio chain; atol 1 bit/s for exact zeros);
positions rtol 1e-6; integer state (serving, ttt, harq_retx, rr_cursor,
t) exact.  The mobility and incremental cases are in
tests/test_torch_engine_mobility.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.params import CRRM_parameters as JParams
from repro.mac import engine as j_engine
from repro_torch.mac import engine as t_engine
from torch_parity import RTOL_TPUT, check_state, np_, run_pair

N_TTI = 20


def check(ref_out, port_out):
    (s_j, tput_j), (s_t, tput_t) = ref_out[:2], port_out[:2]
    tput_j, tput_t = np_(tput_j), np_(tput_t)
    assert tput_t.dtype == np.float32 and tput_t.shape == tput_j.shape
    np.testing.assert_allclose(tput_t, tput_j, rtol=RTOL_TPUT, atol=1.0)
    check_state(s_t, s_j)


BASE = dict(n_ues=48, n_cells=7, seed=2, pathloss_model_name="UMa",
            power_W=10.0, extent_m=1500.0)


@pytest.mark.parametrize("policy,traffic,harq", [
    ("rr", "full_buffer", None),
    ("max_cqi", "poisson", "saw"),
    ("pf", "poisson", "lite"),
    ("pf", "full_buffer", "saw"),
])
def test_static_channel_trajectories_match_reference(policy, traffic, harq):
    params = JParams(**BASE, scheduler_policy=policy, fairness_p=0.5,
                     traffic_model=traffic, harq_bler=0.0 if harq is None
                     else 0.1,
                     traffic_params=dict(arrival_rate_hz=300.0)
                     if traffic == "poisson" else {})
    kw = {} if harq is None else dict(use_harq=harq == "saw")
    check(*run_pair(params, **kw))


MILLION = dict(n_cells=19, n_sectors=1, seed=3, pathloss_model_name="UMa",
               power_W=10.0, scheduler_policy="pf", fairness_p=0.5,
               mobility_step_m=20.0, mobility_move_frac=0.1)


def test_port_dense_equals_incremental():
    """Inside the port: the dense engine and the incremental engine on the
    same draws (cf. tests/test_smart_update_scan.py)."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    p = CRRM_parameters(n_ues=64, **MILLION)
    outs = {}
    for mode, be in (("dense", None), ("incremental", "torch"),
                     ("incremental", "fused"), ("incremental", "auto")):
        sim = CRRM(p, device="cpu")
        fns = sim.episode_fns(radio_mode=mode, inc_backend=be)
        s, t = fns.rollout(sim.episode_static(), sim.init_episode_state(),
                           N_TTI, t_engine.Draws(5, "cpu"))
        outs[(mode, be)] = (s, t)
    s0, t0 = outs[("dense", None)]
    for key, (s, t) in outs.items():
        np.testing.assert_allclose(np_(t), np_(t0), rtol=1e-5, atol=1e-2,
                                   err_msg=str(key))
        assert torch.equal(s.U, s0.U)


def test_fused_inc_backend_raises_for_handover_tables():
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    sim = CRRM(CRRM_parameters(n_ues=8, n_cells=3, ho_enabled=True,
                               radio_mode="incremental",
                               mobility_step_m=5.0), device="cpu")
    with pytest.raises(ValueError, match="cannot express"):
        sim.episode_fns(inc_backend="fused")
    sim.episode_fns(inc_backend="auto")        # the torch rows, no error
    with pytest.raises(ValueError, match="per_tti_fading"):
        sim.episode_fns(per_tti_fading=True)


def test_default_draws_reproduce_a_tti_on_its_own():
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    p = CRRM_parameters(n_ues=32, n_cells=4, seed=1, traffic_model="poisson",
                        harq_bler=0.2, mobility_step_m=10.0,
                        scheduler_policy="rr")
    sim = CRRM(p, device="cpu")
    fns = sim.episode_fns()
    st, s0 = sim.episode_static(), sim.init_episode_state()
    s5, t5 = fns.rollout(st, s0, 5, t_engine.Draws(9, "cpu"))
    s4, _ = fns.rollout(st, s0, 4, t_engine.Draws(9, "cpu"))
    s5b, t5b = fns.step(st, s4, t_engine.Draws(9, "cpu"))
    assert torch.equal(t5[-1], t5b) and torch.equal(s5.U, s5b.U)
    assert int(s5b.t) == 5
    run = sim.run_episode(5, draws=t_engine.Draws(9, "cpu"))
    assert torch.equal(run, t5)
    assert sim.sched.cursor == int(s5.rr_cursor)


def test_a3_and_harq_helpers_match_reference():
    rng = np.random.default_rng(0)
    meas = rng.exponential(1.0, (50, 6)).astype(np.float32)
    a = rng.integers(0, 6, 50).astype(np.int32)
    ttt = rng.integers(0, 4, 50).astype(np.int32)
    ja, jt = j_engine.a3_handover(jnp.asarray(a), jnp.asarray(ttt),
                                  jnp.asarray(meas), 3.0, 4)
    ta, tt = t_engine.a3_handover(torch.as_tensor(a), torch.as_tensor(ttt),
                                  torch.as_tensor(meas), 3.0, 4)
    np.testing.assert_array_equal(np_(ta), np_(ja))
    np.testing.assert_array_equal(np_(tt), np_(jt))
    assert np_(ta).dtype == np.int32 and np_(tt).dtype == np.int32
    retx = np.arange(5, dtype=np.int32)
    np.testing.assert_allclose(
        np_(t_engine.harq_fail_prob(0.1, 3.0, torch.as_tensor(retx))),
        np_(j_engine.harq_fail_prob(0.1, 3.0, jnp.asarray(retx))), rtol=1e-6)


def test_stationary_served_tput_matches_the_graph():
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    for policy in ("rr", "max_cqi", "pf"):
        sim = CRRM(CRRM_parameters(n_ues=30, n_cells=5, seed=1,
                                   scheduler_policy=policy, fairness_p=0.3),
                   device="cpu")
        got = t_engine.stationary_served_tput(
            sim.params, sim.n_cells, sim.get_spectral_efficiency(),
            sim.get_CQI(), sim.get_attachment(), sim.get_backlog())
        assert torch.equal(got, sim.get_served_throughputs())


def test_draws_fold_the_whole_seed():
    """Distinct episode seeds give distinct draws: the seed is mixed
    into 64 bits before the (lineage, 4 t + stream) offset is added, so
    seeds that agree in their low 31 or 32 bits no longer collide, and
    no lineage or stream repeats another's."""
    Draws = t_engine.Draws
    u = lambda seed, t=3: Draws(seed, "cpu").harq_uniform(t, 16)
    for a, b in ((0, 2 ** 31), (1, 1 + 2 ** 32), (5, 5 + 2 ** 40), (0, -1)):
        assert not torch.equal(u(a), u(b)), (a, b)
    assert torch.equal(u(2 ** 31), u(2 ** 31))
    d = Draws(7, "cpu")
    streams = [d.harq_uniform(4, 16), d.churn_death(4, 2.0, 16).float(),
               d.fault_uniform(4, 16), u(7, 5)]
    g = d.generator(0, 4)
    streams.append(torch.rand(16, generator=g))
    for i in range(len(streams)):
        for j in range(i + 1, len(streams)):
            assert not torch.equal(streams[i], streams[j]), (i, j)
    with pytest.raises(ValueError, match="32 bits"):
        d.generator(0, 2 ** 30)

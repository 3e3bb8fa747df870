"""The port's per-cell fault process (``faults=``) against the JAX package.

Mirrors the reference's own fault-process cases (tests/test_faults.py):
zero-rate faults bitwise equal to faults off, a SLEEP cell attenuated,
reattachment conservation under the storm, dense == incremental under the
storm, faults composing with churn and the batch axis, faults + relax
raising, the ``outage_storm`` engine under full-buffer traffic, and
parameter validation; the Poisson-traffic storm runs (engine and env) are
in tests/test_torch_faults_storm.py and the DOWN cell's in
tests/test_torch_faults_dark.py.  Parity runs hand the port the
reference's draws (``torch_parity.ReplayDraws``, which replays
``radio.fault_keys``).  Contract: ``cell_state``, attachment and RB grants
exact (near ties counted as ``torch_parity`` does), throughput and backlog
rtol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.params import CRRM_parameters as JParams
from repro.mac import engine as j_engine
from repro.sim import faults as j_faults
from repro.sim import radio as j_radio
from repro.sim import scenarios as j_scen
from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters as TParams
from repro_torch.mac import engine as t_engine
from repro_torch.mac.engine import Draws
from repro_torch.sim import faults as t_faults
from repro_torch.sim import mobility as t_mob
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim.faults import DOWN, SLEEP, UP
from torch_parity import (RTOL_TPUT, ReplayDraws, carried, check_state,
                          check_telemetry, np_, pair)

STORM = dict(outage_rate_hz=20.0, mean_outage_s=0.03, sleep_rate_hz=20.0,
             mean_sleep_s=0.02, sleep_atten_db=10.0)
FROZEN = dict(outage_rate_hz=0.0, mean_outage_s=1.0, sleep_rate_hz=0.0,
              mean_sleep_s=1.0)
T_STORM, T_FROZEN = t_faults.FaultConfig(**STORM), t_faults.FaultConfig(
    **FROZEN)
BASE = dict(n_ues=24, n_cells=6, n_sectors=1, seed=5,
            pathloss_model_name="UMa", power_W=10.0, scheduler_policy="pf",
            traffic_model="poisson",
            traffic_params=dict(arrival_rate_hz=300.0,
                                packet_size_bits=12_000.0))


def _params(**kw):
    return TParams(**dict(BASE, **kw))


def _roll(params, n_tti=20, seed=0, telemetry=False, state=None, **fns_kw):
    sim = CRRM(params, device="cpu")
    fns = sim.episode_fns(telemetry=telemetry, **fns_kw)
    if state is None:
        state = sim.init_episode_state()
    return fns.rollout(sim.episode_static(), state, n_tti, Draws(seed, "cpu"))


def fault_pair(params, n_tti=20, key=0, cell_state=None, **kw):
    """Roll the reference (its XLA rows) and the port under ``params``'s
    fault process from the same carried state on the reference's draws;
    ``(ref_out, port_out)``, each ``(state, tput, telemetry)``.  Poisson
    traffic runs the reference eagerly."""
    ref, port = pair(params)
    k = jax.random.PRNGKey(key)
    static_j, state_j, static_t, state_t = carried(ref, k)
    if cell_state is not None:
        state_j = j_engine.seed_fault_state(state_j, cell_state=cell_state)
        state_t = t_engine.seed_fault_state(state_t, cell_state=cell_state)
    with jax.disable_jit(params.traffic_model != "full_buffer"):
        out_j = ref.episode_fns(telemetry=True).rollout(static_j, state_j,
                                                        n_tti)
    out_t = port.episode_fns(telemetry=True, **kw).rollout(
        static_t, state_t, n_tti, ReplayDraws(k, ref))
    return out_j, out_t


def check_pair(out_j, out_t):
    (s_j, t_j, tel_j), (s_t, t_t, tel_t) = out_j, out_t
    check_state(s_t, s_j)
    np.testing.assert_allclose(np_(t_t), np_(t_j), rtol=RTOL_TPUT, atol=1.0)
    check_telemetry(tel_t, tel_j)


# ------------------------------------------------- fault-process invariants
def test_fault_step_and_multiplier_match_reference():
    """The Markov transition on the reference's uniforms and the tx
    multiplier: exact, with DOWN exactly 0.0 and UP exactly 1.0."""
    key = jax.random.PRNGKey(3)
    jf = j_faults.FaultConfig(**STORM)
    cs_j, cs_t = j_faults.init_cell_state(40), t_faults.init_cell_state(40)
    assert cs_t.dtype == torch.int32
    draws = ReplayDraws(key, None)
    seen = set()
    for t in range(200):
        cs_j, ch_j = j_faults.fault_step(j_radio.fault_keys(key, t), cs_j,
                                         1e-3, jf)
        cs_t, ch_t = t_faults.fault_step(draws.fault_uniform(t, 40), cs_t,
                                         1e-3, T_STORM)
        np.testing.assert_array_equal(np_(cs_t), np_(cs_j))
        np.testing.assert_array_equal(np_(ch_t), np_(ch_j))
        seen |= set(np_(cs_t).tolist())
    assert seen == {UP, SLEEP, DOWN}
    m_t = t_faults.tx_multiplier(cs_t, T_STORM)
    np.testing.assert_array_equal(np_(m_t), np_(j_faults.tx_multiplier(
        cs_j, jf)))
    assert m_t.dtype == torch.float32
    assert set(np_(m_t)[np_(cs_t) == DOWN]) <= {0.0}
    assert set(np_(m_t)[np_(cs_t) == UP]) <= {1.0}


def test_zero_rate_faults_bitwise_equal_off():
    """The fault draws are a lineage of their own: arming the process at
    zero rates leaves the trajectory bitwise that of faults off.  (Under
    faults the serving leaf tracks the instantaneous attachment, as in the
    reference, where faults off leave it at its initial value; so it is
    held to the attachment, not to the fault-free leaf.)"""
    p = _params(mobility_step_m=10.0)
    s_off, t_off = _roll(p, faults=None)
    s_on, t_on = _roll(p, faults=T_FROZEN)
    assert torch.equal(t_on, t_off)
    for name in ("U", "backlog", "pf_avg", "harq_bits"):
        assert torch.equal(getattr(s_on, name), getattr(s_off, name)), name
    sim = CRRM(p, device="cpu")
    sim.set_UE_positions(s_on.U)
    assert torch.equal(s_on.serving, sim.get_attachment())
    assert s_off.cell_state is None
    assert torch.equal(s_on.cell_state, torch.full((6,), UP,
                                                   dtype=torch.int32))


def test_scenario_faults_off_override_restores_legacy_treedef():
    base = t_scen.make_scenario("outage_storm", n_ues=16, n_cells=6,
                                faults=None)
    assert base.faults is None
    s, _ = _roll(base, n_tti=4)
    assert s.cell_state is None
    storm = t_scen.make_scenario("outage_storm", n_ues=16, n_cells=6)
    assert _roll(storm, n_tti=4)[0].cell_state.shape == (6,)
    assert _roll(storm, n_tti=4, faults=0)[0].cell_state is None


def test_sleep_cell_attenuated_not_dark():
    p = _params(n_ues=48, n_cells=5, seed=2)
    sim = CRRM(p, device="cpu")
    asleep = 1
    cs = np.full(5, UP)
    cs[asleep] = SLEEP
    deep = t_faults.FaultConfig(**dict(FROZEN, sleep_atten_db=30.0))

    def served_share(cell_state):
        fns = sim.episode_fns(telemetry=True, faults=deep)
        state = t_engine.seed_fault_state(sim.init_episode_state(),
                                          cell_state=cell_state)
        _, _, telem = fns.rollout(sim.episode_static(), state, 25,
                                  Draws(0, "cpu"))
        return (float(telem.served_bits[:, asleep].sum()),
                float(telem.served_bits.sum()))

    awake_bits, _ = served_share(np.full(5, UP))
    sleep_bits, sleep_total = served_share(cs)
    assert awake_bits > 0.0 and sleep_total > 0.0
    assert sleep_bits < awake_bits
    m = np_(t_faults.tx_multiplier(torch.as_tensor(cs), deep))
    assert m[asleep] == pytest.approx(1e-3)
    assert m[[0, 2, 3, 4]].tolist() == [1.0] * 4


def test_reattachment_conservation_under_storm():
    """The per-TTI attachment never leaves a UE on a DOWN cell while any
    cell is up (port, its own draws, stepped TTI by TTI)."""
    sim = CRRM(_params(n_ues=32, n_cells=5, seed=3), device="cpu")
    fns = sim.episode_fns(telemetry=True, faults=T_STORM)
    static, state = sim.episode_static(), sim.init_episode_state()
    draws, saw_down = Draws(4, "cpu"), 0
    for _ in range(60):
        state, _, telem = fns.step(static, state, draws)
        cs, srv = np_(state.cell_state), np_(state.serving)
        if (cs == DOWN).any() and (cs != DOWN).any():
            saw_down += 1
            assert not (cs[srv] == DOWN).any()
        assert int(telem.cells_down) == int((cs == DOWN).sum())
    assert saw_down > 5


def check_storm(radio_mode, policy, traffic):
    """``outage_storm`` (A3, Rayleigh fading, mobility) at 24 UEs x 6
    cells on the reference's draws, 20 TTIs; the incremental port
    re-derives the per-UE outputs from its carried gains, branch-free.
    Bursty traffic runs with rr, whose grants are exact integers: under pf
    an ulp of the per-cell share can leave a backlog residue in one
    package and not the other, which flips an active mask (the hazard of
    ROADMAP queue 3)."""
    params = j_scen.make_scenario("outage_storm", n_ues=24, n_cells=6,
                                  radio_mode=radio_mode,
                                  scheduler_policy=policy,
                                  traffic_model=traffic)
    check_pair(*fault_pair(params, n_tti=20, key=0))


@pytest.mark.parametrize("radio_mode,policy,traffic", [
    ("dense", "pf", "full_buffer"), ("incremental", "pf", "full_buffer")])
def test_storm_engine_matches_reference(radio_mode, policy, traffic):
    """:func:`check_storm` under full-buffer traffic, both radio modes;
    the Poisson cases run in tests/test_torch_faults_storm.py."""
    check_storm(radio_mode, policy, traffic)


def test_dense_equals_incremental_under_storm():
    """Port vs port: the incremental gain-carry fault update reproduces
    the dense recompute; cell_state, serving and positions exact."""
    base = t_scen.make_scenario("outage_storm", n_ues=24, n_cells=6)
    s1, t1 = _roll(base, radio_mode="dense")
    s2, t2 = _roll(base, radio_mode="incremental")
    np.testing.assert_allclose(np_(t2), np_(t1), rtol=1e-5, atol=1e-2)
    for f in ("cell_state", "serving", "U"):
        assert torch.equal(getattr(s2, f), getattr(s1, f)), f


def test_fused_backend_refuses_faults_and_auto_takes_the_torch_rows():
    p = _params(faults=T_STORM, radio_mode="incremental",
                mobility_step_m=10.0, mobility_move_frac=0.25)
    sim = CRRM(p, device="cpu")
    with pytest.raises(ValueError, match="fault"):
        sim.episode_fns(inc_backend="fused")
    auto = sim.episode_fns(inc_backend="auto")
    assert auto.inc_backend == "torch" and "fault" in auto.inc_reason
    off = sim.episode_fns(inc_backend="auto", faults=0)
    assert off.inc_backend == "fused" and off.inc_reason is None
    torch_rows = sim.episode_fns(inc_backend="torch")
    state = sim.init_episode_state()
    s_a, t_a = auto.rollout(sim.episode_static(), state, 10, Draws(0, "cpu"))
    s_t, t_t = torch_rows.rollout(sim.episode_static(), state, 10,
                                  Draws(0, "cpu"))
    assert torch.equal(t_a, t_t)


def test_faults_compose_with_churn_and_the_batch_axis():
    """Faults + churn in one engine over a batch of 3 envs: batched
    cell_state, the envs diverge, and each row is its single episode bit
    for bit."""
    p = _params(n_ues=16, n_cells=4)
    sim = CRRM(p, device="cpu")
    churn = t_mob.ChurnConfig(arrival_rate_hz=300.0, mean_lifetime_s=0.1,
                              max_arrivals_per_tti=4)
    fns = sim.episode_fns(churn=churn, faults=T_STORM, telemetry=True)
    static = sim.episode_static()
    one = t_engine.seed_churn_state(sim.init_episode_state(), static, p)
    batch = type(one)(*(None if x is None else torch.stack([x] * 3)
                        for x in one))
    seeds = [0, 1, 2]
    s, t, telem = fns.rollout(static, batch, 15,
                              [Draws(k, "cpu") for k in seeds])
    assert s.cell_state.shape == (3, 4) and t.shape == (3, 15, 16)
    assert telem.cells_down.shape == (3, 15)
    assert not torch.equal(t[0], t[1])
    for b in seeds:
        s1, t1, tel1 = fns.rollout(static, one, 15, Draws(b, "cpu"))
        assert torch.equal(t[b], t1)
        for x, y in zip(s, s1):
            assert (x is None and y is None) or torch.equal(x[b], y)
        for x, y in zip(telem, tel1):
            assert (x is None and y is None) or torch.equal(x[b], y)


def test_faults_rejected_with_relax():
    with pytest.raises(ValueError, match="relax"):
        CRRM(_params(), device="cpu").episode_fns(faults=T_STORM, relax=0.5)


def test_fault_params_validation():
    with pytest.raises(ValueError, match="FaultConfig"):
        _params(faults="storm")
    with pytest.raises(ValueError):
        _params(faults=t_faults.FaultConfig(outage_rate_hz=-1.0))
    with pytest.raises(ValueError):
        # per-TTI probability above 1 at tti_s=1ms
        _params(faults=t_faults.FaultConfig(outage_rate_hz=2000.0))


def test_convert_carries_the_new_leaves_and_batches():
    """``convert.episode_state`` takes the reference's churn and fault
    leaves, and a vmapped (batched) state, with the port's dtypes."""
    from repro.sim.mobility import ChurnConfig as JChurn
    from repro_torch import convert
    ref, _ = pair(JParams(**dict(BASE, n_ues=16, n_cells=4),
                          rayleigh_fading=True))
    static = ref.episode_static()
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    states = jax.vmap(lambda k: j_engine.seed_fault_state(
        j_engine.seed_churn_state(ref.init_episode_state(k), static,
                                  ref.params), 4))(keys)
    fns = ref.episode_fns(churn=JChurn(300.0, 0.1, 4),
                          faults=j_faults.FaultConfig(**STORM))
    states, _ = jax.vmap(lambda s: fns.rollout(static, s, 5))(states)
    got = convert.episode_state({k: np_(v) for k, v in
                                 states._asdict().items() if v is not None},
                                "cpu")
    assert got.active.dtype == torch.bool and got.active.shape == (3, 16)
    assert got.cell_state.dtype == torch.int32
    assert got.cell_state.shape == (3, 4) and got.t.tolist() == [5] * 3
    assert got.fad.shape == (3, 16, 4) and got.fad.dtype == torch.float32
    check_state(got, states)

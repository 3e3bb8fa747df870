"""The port's birth-death UE process (``churn=``) against the JAX package.

Mirrors the reference's own churn cases (tests/test_twin.py): the
birth-death invariants, inactive UEs at zero RB and zero throughput,
telemetry counting only active UEs, incremental == dense, chunk
invariance, the legacy state untouched, ``scatter_born``'s duplicate
safety and churn + mesh raising; the full twin regime (handover,
fading, HARQ, bursty traffic) runs in tests/test_torch_churn_handover.py.
Parity runs hand the port the reference's draws
(``torch_parity.ReplayDraws``, which replays ``radio.churn_keys``).  Contract: ``active``, ``born``, attachment and RB
grants exact (near ties counted as ``torch_parity`` does), throughput and
backlog rtol 1e-4 (``check_state``/``check_telemetry``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.params import CRRM_parameters as JParams
from repro.mac import engine as j_engine
from repro.sim import mobility as j_mob
from repro.sim import radio as j_radio
from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters as TParams
from repro_torch.mac import engine as t_engine
from repro_torch.mac.engine import Draws
from repro_torch.obs.telemetry import summarize
from repro_torch.sim import mobility as t_mob
from repro_torch.sim import radio as t_radio
from torch_parity import (DEV, RTOL_TPUT, ReplayDraws, carried, check_state,
                          check_telemetry, np_, pair)

BASE = dict(n_ues=48, n_cells=7, n_sectors=1, seed=11,
            pathloss_model_name="UMa", power_W=10.0,
            scheduler_policy="pf")
CHURN = dict(arrival_rate_hz=400.0, mean_lifetime_s=0.1,
             max_arrivals_per_tti=6)
J_CHURN, T_CHURN = j_mob.ChurnConfig(**CHURN), t_mob.ChurnConfig(**CHURN)


def churn_pair(params, n_tti=30, key=0, inc_backend=None):
    """Roll the reference (its XLA rows) and the port (``inc_backend``)
    under churn from the same carried state on the reference's draws;
    ``(ref_out, port_out)``, each ``(state, tput, telemetry)``.  Poisson
    traffic runs the reference eagerly (see tests/test_torch_engine.py)."""
    ref, port = pair(params)
    k = jax.random.PRNGKey(key)
    static_j, state_j, static_t, state_t = carried(ref, k)
    state_j = j_engine.seed_churn_state(state_j, static_j, ref.params)
    state_t = t_engine.seed_churn_state(state_t, static_t, port.params)
    with jax.disable_jit(params.traffic_model != "full_buffer"):
        out_j = ref.episode_fns(churn=J_CHURN, telemetry=True).rollout(
            static_j, state_j, n_tti)
    out_t = port.episode_fns(churn=T_CHURN, telemetry=True,
                             inc_backend=inc_backend).rollout(
        static_t, state_t, n_tti, ReplayDraws(k, ref))
    return out_j, out_t


def check_pair(out_j, out_t):
    (s_j, t_j, tel_j), (s_t, t_t, tel_t) = out_j, out_t
    check_state(s_t, s_j)
    np.testing.assert_allclose(np_(t_t), np_(t_j), rtol=RTOL_TPUT, atol=1.0)
    check_telemetry(tel_t, tel_j)


def port_setup(radio_mode="dense", n_ues=48, **kw):
    sim = CRRM(TParams(**dict(BASE, n_ues=n_ues, traffic_model="poisson",
                              traffic_params=dict(arrival_rate_hz=300.0,
                                                  packet_size_bits=12_000.0),
                              radio_mode=radio_mode)), device="cpu")
    fns = sim.episode_fns(churn=T_CHURN, telemetry=True, **kw)
    static = sim.episode_static()
    state = t_engine.seed_churn_state(sim.init_episode_state(), static,
                                      sim.params)
    return sim, fns, static, state


# ----------------------------------------------------------- churn process
def test_birth_death_step_matches_reference():
    """The process on the reference's draws: the same departures, arrival
    counts and newborn slots, exactly; the reference's invariants."""
    key = jax.random.PRNGKey(0)
    kw = dict(arrival_rate_hz=800.0, mean_lifetime_s=0.02,
              max_arrivals_per_tti=4)
    jc, tc = j_mob.ChurnConfig(**kw), t_mob.ChurnConfig(**kw)
    draws = ReplayDraws(key, None)
    p_dep, lam = t_mob.churn_rates(1e-3, tc)
    act_j, act_t = jnp.ones(32, bool), torch.ones(32, dtype=torch.bool)
    for t in range(50):
        k_b, k_d, _, _ = j_radio.churn_keys(key, t)
        act_j, born_j, n_j = j_mob.birth_death_step(k_b, k_d, act_j, 1e-3,
                                                    jc)
        act_t, born_t, n_t = t_mob.birth_death_step(
            draws.churn_birth(t, lam), draws.churn_death(t, p_dep, 32),
            act_t, tc)
        np.testing.assert_array_equal(np_(act_t), np_(act_j))
        np.testing.assert_array_equal(np_(born_t), np_(born_j))
        assert n_t.dtype == torch.int32 and int(n_t) == int(n_j)
        assert int(born_t.sum()) == int(n_t) <= tc.max_arrivals_per_tti
        assert not (born_t & ~act_t).any()
    assert 0 < int(act_t.sum()) < 32          # churn actually happened


@pytest.mark.parametrize("radio_mode,inc_backend", [
    ("dense", None), ("incremental", "torch"), ("incremental", "fused")])
def test_churn_engine_matches_reference(radio_mode, inc_backend):
    """The million-episode configuration at 48 UEs with window movers:
    newborn rows join the mover rows (one fused call per TTI)."""
    params = JParams(**BASE, fairness_p=0.5, mobility_step_m=20.0,
                     mobility_move_frac=0.1, radio_mode=radio_mode)
    check_pair(*churn_pair(params, inc_backend=inc_backend))


@pytest.mark.parametrize("radio_mode", ["dense", "incremental"])
def test_inactive_ues_zero_rb_zero_tput(radio_mode):
    """A slot outside the active mask draws zero RBs and zero throughput,
    every TTI, on both radio modes (port, its own draws)."""
    _, fns, static, state = port_setup(radio_mode)
    draws, saw_inactive = Draws(0, "cpu"), False
    for _ in range(30):
        state, tput, telem = fns.step(static, state, draws)
        inact = ~state.active
        saw_inactive |= bool(inact.any())
        assert (tput[inact] == 0.0).all()
        assert int(telem.active_ues) == int(state.active.sum())
    assert saw_inactive


def test_telemetry_counts_only_active_ues():
    _, fns, static, state = port_setup()
    state, _, telem = fns.rollout(static, state, 40, Draws(0, "cpu"))
    traj = np_(telem.active_ues)
    assert traj.shape == (40,) and traj.dtype == np.int32
    assert traj.min() < 48                   # departures visible
    assert int(traj[-1]) == int(state.active.sum())
    assert summarize(telem)["mean_active_ues"] == pytest.approx(traj.mean())


@pytest.mark.parametrize("inc_backend", ["torch", "fused"])
def test_churn_incremental_matches_dense(inc_backend):
    """Newborn rows patched through the carried RadioState (one row
    recompute with the movers; the fused kernel's plain version on the
    CPU) reproduce the dense recompute: every integer leaf exact,
    throughput to rtol 1e-4."""
    _, fns_d, static, state = port_setup(mobility_step_m=20.0,
                                         mobility_move_frac=0.1)
    _, fns_i, _, _ = port_setup("incremental", mobility_step_m=20.0,
                                mobility_move_frac=0.1,
                                inc_backend=inc_backend)
    sd, td, teld = fns_d.rollout(static, state, 30, Draws(4, "cpu"))
    si, ti, teli = fns_i.rollout(static, state, 30, Draws(4, "cpu"))
    np.testing.assert_allclose(np_(ti), np_(td), rtol=RTOL_TPUT, atol=1.0)
    for f in ("U", "active", "serving", "harq_retx", "t"):
        np.testing.assert_array_equal(np_(getattr(si, f)),
                                      np_(getattr(sd, f)), err_msg=f)
    np.testing.assert_array_equal(np_(teli.granted_rb), np_(teld.granted_rb))
    assert int(teli.dirty_rows.min()) >= 5     # movers + newborns


def test_churn_trajectory_chunk_invariant():
    """Draws keyed on the absolute TTI: 3 chunks of 10 == one 30-TTI run,
    bitwise."""
    _, fns, static, state = port_setup()
    s_whole, t_whole, _ = fns.rollout(static, state, 30, Draws(2, "cpu"))
    s, parts = state, []
    for _ in range(3):
        s, t, _ = fns.rollout(static, s, 10, Draws(2, "cpu"))
        parts.append(t)
    assert torch.equal(torch.cat(parts), t_whole)
    for a, b in zip(s, s_whole):
        assert (a is None and b is None) or torch.equal(a, b)


def test_legacy_state_and_trajectory_untouched():
    """Churn off: the new leaves stay None and the trajectory is what it
    was; churn on with no births and no deaths leaves the legacy streams
    (mobility, traffic, HARQ) bit-identical; the caller's state is not
    written in place."""
    p = TParams(**BASE, mobility_step_m=10.0, harq_bler=0.2,
                traffic_model="poisson",
                traffic_params=dict(arrival_rate_hz=300.0,
                                    packet_size_bits=12_000.0))
    sim = CRRM(p, device="cpu")
    state = sim.init_episode_state()
    assert state.active is None and state.fad is None
    assert state.cell_state is None
    t0 = sim.run_episode(20, draws=Draws(1, "cpu"), sync_state=False)
    t1 = CRRM(p, device="cpu").run_episode(20, draws=Draws(1, "cpu"),
                                           sync_state=False)
    assert torch.equal(t0, t1)
    still = t_mob.ChurnConfig(arrival_rate_hz=0.0, mean_lifetime_s=1e30,
                              max_arrivals_per_tti=2)
    static = sim.episode_static()
    s_c = t_engine.seed_churn_state(state, static, p)
    U0 = s_c.U.clone()
    s_c, t2 = sim.episode_fns(churn=still).rollout(static, s_c, 20,
                                                   Draws(1, "cpu"))
    assert torch.equal(t2, t0) and bool(s_c.active.all())
    assert torch.equal(state.U, U0)


def test_scatter_born_duplicate_safety():
    """Padded slots must not corrupt row 0: zero births is a bitwise
    no-op, duplicate writes are identical -- the reference's cases, and
    the same result as the reference."""
    dst = np.arange(12.0, dtype=np.float32).reshape(6, 2)
    for born, fresh, n in (
            (np.zeros(6, bool), np.full((4, 2), 99.0, np.float32), 0),
            (np.array([0, 0, 1, 0, 1, 0], bool),
             np.array([[1, 1], [2, 2], [3, 3], [4, 4]], np.float32), 2)):
        idx_j = j_radio.dirty_indices(jnp.asarray(born), 4)
        want = j_engine.scatter_born(jnp.asarray(dst), idx_j,
                                     jnp.asarray(fresh), jnp.int32(n))
        idx_t = t_radio.dirty_indices(torch.as_tensor(born), 4)
        np.testing.assert_array_equal(np_(idx_t), np_(idx_j))
        got = t_engine.scatter_born(torch.tensor(dst), idx_t,
                                    torch.tensor(fresh),
                                    torch.tensor(n, dtype=torch.int32))
        np.testing.assert_array_equal(np_(got), np_(want))
        if n == 0:
            np.testing.assert_array_equal(np_(got), dst)
        else:
            np.testing.assert_array_equal(np_(got)[[2, 4]], fresh[:2])
            np.testing.assert_array_equal(np_(got)[0], dst[0])


def test_churn_mesh_raises():
    sim = CRRM(TParams(**BASE), device="cpu")
    with pytest.raises(ValueError, match="churn"):
        sim.episode_fns(churn=T_CHURN, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        sim.episode_fns(mesh=object())


def test_churn_draws_depend_on_seed_and_tti_only():
    """Each churn stream is a function of (episode seed, absolute TTI):
    two objects agree, another TTI or seed differs, and drawing churn
    leaves the legacy HARQ stream as it was."""
    a, b = Draws(5, DEV), Draws(5, DEV)
    u0 = a.harq_uniform(3, 64)
    for f in (lambda d, t: d.churn_death(t, 0.5, 64),
              lambda d, t: d.churn_positions(t, 8, 100.0, 1.5),
              lambda d, t: d.fault_uniform(t, 16)):
        assert torch.equal(f(a, 3), f(b, 3))
        assert not torch.equal(f(a, 3), f(a, 4))
        assert not torch.equal(f(a, 3), f(Draws(6, DEV), 3))
    assert int(a.churn_birth(3, 7.0)) == int(b.churn_birth(3, 7.0))
    assert torch.equal(a.harq_uniform(3, 64), u0)

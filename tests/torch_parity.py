"""Shared helpers of the ``test_torch_*`` parity tests: building the same
simulator in both packages and holding integer outputs to the contract.

Contract for quantised outputs: attachment exact, except rows whose two
best wideband measurements differ by less than 1e-5 relative in the
reference (counted; at the test seeds there are none); CQI exact, except
where the reference's SINR lies within 1e-4 dB of a CQI threshold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_fixture
from repro.core.crrm import CRRM as JCRRM
from repro.env.crrm_env import CrrmEnv as JEnv
from repro.sim import deploy as j_deploy
from repro.sim import mobility as j_mobility
from repro.sim import phy as j_phy
from repro.sim import radio as j_radio
from repro.sim import scenarios as j_scen
from repro_torch import convert
from repro_torch.env.crrm_env import CrrmEnv as TEnv
from repro_torch.mac import engine as t_engine
from repro_torch.sim import faults as t_faults

DEV = torch.device("cpu")


def np_(x):
    """numpy view of a JAX array, a tensor, or None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fields_of(params):
    """The reference params as a field dict the port accepts."""
    d = {f.name: getattr(params, f.name)
         for f in dataclasses.fields(params)}
    if d["faults"] is not None:
        d["faults"] = t_faults.FaultConfig(*d["faults"])
    return d


def port_of(ref):
    """The port CRRM on the roots of the reference CRRM ``ref``."""
    roots = {k: np_(getattr(ref, k)._data)
             for k in ("U", "C", "P", "boresight", "fading")}
    roots["buffer"] = np_(ref.buffer._data)
    return convert.crrm_from_reference(fields_of(ref.params), roots, DEV)


def pair(params):
    """(reference CRRM, port CRRM) on the same roots."""
    ref = JCRRM(params)
    return ref, port_of(ref)


def near_tie_rows(meas_ref):
    """Rows whose two best reference measurements differ < 1e-5 relative."""
    m = np.sort(np_(meas_ref), axis=1)
    if m.shape[1] < 2:
        return np.zeros(m.shape[0], bool)
    return (m[:, -1] - m[:, -2]) < 1e-5 * np.abs(m[:, -1])


def assert_attachment(a_port, a_ref, meas_ref):
    ties = near_tie_rows(meas_ref)
    assert ties.sum() == 0, f"{ties.sum()} near-tie rows at this seed"
    a_port, a_ref = np_(a_port), np_(a_ref)
    assert a_port.dtype == np.int32
    np.testing.assert_array_equal(a_port, a_ref)


def assert_sinr(gamma, gamma_ref, w_ref, u_ref, noise_w, rtol=1e-4):
    """gamma = w / (noise + total - w) to ``rtol`` times its condition number.

    The relative errors of w and total (rtol 1e-4: sum order, ulps of
    log10/pow) reach gamma amplified by kappa = 1 + (w + total) /
    (noise + u): 1 where interference or noise dominate, about 2 * gamma
    where the wanted power dominates and u is a small difference of two
    large sums.  ``rtol * kappa`` is that propagated bound.
    """
    g, g_r = np_(gamma), np_(gamma_ref)
    w_r, u_r = np_(w_ref).astype(np.float64), np_(u_ref).astype(np.float64)
    kappa = 1.0 + (2 * w_r + u_r) / (noise_w + u_r)
    bad = np.abs(g - g_r) > rtol * kappa * np.abs(g_r)
    assert not bad.any(), (
        f"{bad.sum()} SINR entries off: got {g[bad][:5]}, want {g_r[bad][:5]}")


def near_threshold(gamma_ref):
    """Entries whose reference SINR (dB) is within 1e-4 dB of a CQI step."""
    db = np_(j_phy.sinr_to_db(jnp.asarray(np_(gamma_ref))))
    thr = np_(j_phy.CQI_SINR_THRESHOLDS_DB)
    return np.abs(db[..., None] - thr).min(axis=-1) < 1e-4


def assert_cqi(port, ref, gamma_ref):
    """CQI (or a quantity it determines) exact away from the staircase."""
    edge = near_threshold(gamma_ref)
    assert edge.mean() < 0.01, f"{edge.sum()} entries sit on a CQI step"
    np.testing.assert_array_equal(np_(port)[~edge], np_(ref)[~edge])


class ReplayDraws(t_engine.Draws):
    """The reference's per-TTI draws, handed to the port as tensors: on
    ``radio.tti_keys(key, t)``, the churn draws on ``radio.churn_keys(key,
    t)``, the fault uniforms on ``radio.fault_keys(key, t)``, and for a
    resampled env reset on the topology and fading keys of
    ``radio.reset_keys`` (``reset_keys``).  A batch replays one reference
    key per env: a list of these."""

    def __init__(self, key, ref_sim, reset_keys=None):
        super().__init__(0, DEV)
        self.key, self.ref, self.reset_keys = key, ref_sim, reset_keys

    def keys(self, t):
        return j_radio.tti_keys(self.key, t)

    def walk(self, t, n, step_m):
        d = j_mobility.walk_steps(self.keys(t)[0], n, step_m)
        return torch.as_tensor(np_(d))

    def window(self, t, n, n_move, step_m):
        start, d = j_mobility.window_movers(self.keys(t)[0], n, n_move,
                                           step_m)
        return torch.tensor(int(start)), torch.as_tensor(np_(d))

    def fading(self, t, cfg, n_ues, n_cells):
        f = j_radio.draw_fading(self.ref.radio_config(), self.keys(t)[1],
                                n_ues, n_cells)
        return torch.as_tensor(np_(f))

    def traffic(self, t, traffic_step):
        return torch.tensor(np_(self.ref._traffic_step(self.keys(t)[2], t)))

    def harq_uniform(self, t, n):
        return torch.as_tensor(np_(jax.random.uniform(self.keys(t)[3], (n,))))

    def harq_bernoulli(self, t, p, n):
        return torch.as_tensor(np_(jax.random.bernoulli(self.keys(t)[3], p,
                                                        (n,))))

    def topology(self, n, extent_m, z):
        return torch.as_tensor(np_(j_deploy.ppp_points(
            self.reset_keys[0], n, extent_m, z=z)))

    def topology_fading(self, cfg, n_ues, n_cells):
        return torch.as_tensor(np_(j_radio.draw_fading(
            self.ref.radio_config(), self.reset_keys[1], n_ues, n_cells)))

    # the churn lineage: radio.churn_keys = (birth, death, position, fading)
    def churn_birth(self, t, lam):
        k = j_radio.churn_keys(self.key, t)[0]
        return torch.tensor(np_(jax.random.poisson(k, lam, ())))

    def churn_death(self, t, p, n):
        k = j_radio.churn_keys(self.key, t)[1]
        return torch.tensor(np_(jax.random.bernoulli(k, p, (n,))))

    def churn_positions(self, t, n, extent_m, z):
        k = j_radio.churn_keys(self.key, t)[2]
        return torch.tensor(np_(j_deploy.ppp_points(k, n, extent_m, z=z)))

    def churn_fading(self, t, cfg, n_ues, n_cells):
        k = j_radio.churn_keys(self.key, t)[3]
        return torch.tensor(np_(j_radio.draw_fading(
            self.ref.radio_config(), k, n_ues, n_cells)))

    def fault_uniform(self, t, n_cells):
        k = j_radio.fault_keys(self.key, t)
        return torch.tensor(np_(jax.random.uniform(k, (n_cells,))))


def batch_draws(keys, ref_sim):
    """One :class:`ReplayDraws` per env of a batch: the reference key of
    row b replays env b."""
    return [ReplayDraws(k, ref_sim) for k in keys]


def env_draws(ref_env):
    """The port env's ``draws`` factory replaying the reference env
    ``ref_env``: its reset seed ``s`` is the reference's
    ``PRNGKey(s)``."""
    def make(seed, device):
        key = jax.random.PRNGKey(seed)
        if ref_env.resample_topology:
            k_topo, k_fad, k_ep = j_radio.reset_keys(key)
            return ReplayDraws(k_ep, ref_env.sim, (k_topo, k_fad))
        return ReplayDraws(key, ref_env.sim)
    return make


def carried(ref, key):
    """The reference's static and initial state, and the port's copies."""
    static, state = ref.episode_static(), ref.init_episode_state(key)
    as_dict = lambda nt: {k: np_(v) for k, v in nt._asdict().items()
                          if v is not None}
    return (static, state, convert.episode_static(as_dict(static), DEV),
            convert.episode_state(as_dict(state), DEV))


RTOL_TPUT = 1e-4


def check_state(s_t, s_j):
    """A port ``EpisodeState`` against the reference's: positions and the
    carried fading to rtol 1e-6, integer and boolean state exact (the
    churn mask and the fault codes too), throughput-like floats to rtol
    1e-4 (sum order of the per-cell PF shares and ulps of the radio chain;
    atol 1 bit/s for exact zeros)."""
    np.testing.assert_allclose(np_(s_t.U), np_(s_j.U), rtol=1e-6)
    for f in ("serving", "ttt", "harq_retx", "rr_cursor", "t",
              "cell_state"):
        got, want = np_(getattr(s_t, f)), np_(getattr(s_j, f))
        if want is None:
            assert got is None, f
            continue
        assert got.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("active", "fad"):
        got, want = np_(getattr(s_t, f)), np_(getattr(s_j, f))
        assert (got is None) == (want is None), f
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f)
    for f in ("pf_avg", "backlog", "harq_bits"):
        np.testing.assert_allclose(np_(getattr(s_t, f)),
                                   np_(getattr(s_j, f)), rtol=RTOL_TPUT,
                                   atol=1.0, err_msg=f)


def check_telemetry(tel_t, tel_j):
    """Integer KPIs exact, float KPIs to rtol 1e-4 (the per-cell segment
    sums add in another order than XLA's scatter-add)."""
    ints = ("harq_acks", "harq_nacks", "harq_retx", "ho_events",
            "dirty_rows", "active_ues", "cells_down", "reattach_events")
    for f in tel_j._fields:
        got, want = getattr(tel_t, f), getattr(tel_j, f)
        if want is None:
            assert got is None, f
            continue
        got, want = np_(got), np_(want)
        assert got.shape == want.shape, f
        if f in ints:
            assert got.dtype == np.int32, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            assert got.dtype == np.float32, f
            np.testing.assert_allclose(got, want, rtol=RTOL_TPUT,
                                       atol=1e-3 if f in ("granted_rb", "jain")
                                       else 1.0, err_msg=f)


def run_pair(params, n_tti=20, key=0, fairness_p=None, **kw):
    """Roll the reference and the port from the same carried state on the
    reference's draws: ``(ref_out, port_out)``, each ``(state, tput)`` plus
    the telemetry stack when ``telemetry=True`` is among ``kw``.  Under
    bursty traffic the reference rolls out eagerly (see
    tests/test_torch_engine.py).  ``fairness_p`` goes to the reference as a
    float32 scalar, as a traced override."""
    ref, port = pair(params)
    k = jax.random.PRNGKey(key)
    static_j, state_j, static_t, state_t = carried(ref, k)
    fp_j = None if fairness_p is None else jnp.float32(fairness_p)
    with jax.disable_jit(params.traffic_model != "full_buffer"):
        out_j = ref.episode_fns(**kw).rollout(static_j, state_j, n_tti,
                                              None, fp_j)
    tkw = dict(kw)
    if tkw.get("inc_backend") == "xla":
        tkw["inc_backend"] = "torch"
    out_t = port.episode_fns(**tkw).rollout(
        static_t, state_t, n_tti, ReplayDraws(k, ref), None, fairness_p)
    return ((out_j[0], np_(out_j[1])) + tuple(out_j[2:]),
            (out_t[0], np_(out_t[1])) + tuple(out_t[2:]))


#: the presets whose reference env steps and autoresets: the reference's
#: ``step_autoreset`` fails under faults (ROADMAP queue 3), so
#: ``outage_storm`` is held to it in tests/test_torch_faults.py instead
RUNNABLE_SCENARIOS = [n for n in j_scen.scenario_names()
                      if n != "outage_storm"]
ENV_SMALL = dict(episode_tti=2, tti_per_step=1, telemetry=True)
#: the runnable presets of each file's env-episode check
#: (:func:`check_env_episode`): under bursty traffic the eager reference
#: compiles every primitive of a preset anew, so the presets are spread
#: over files to keep each under a minute (tests/test_torch_env.py holds
#: the cover)
ENV_GROUPS = {
    "test_torch_env": ("dense_urban", "dense_urban_mobile"),
    "test_torch_env_twin": ("dense_urban_twin",),
    "test_torch_env_handover": ("handover_stress",),
    "test_torch_env_scenarios": ("indoor_hotspot", "rural_macro"),
}


def env_pair(name, resample=False, **kw):
    """(reference CrrmEnv, port CrrmEnv) of a preset at 24 UEs x 6 cells,
    the port on the reference's roots and draws."""
    params = j_scen.make_scenario(name, n_ues=24, n_cells=6)
    ref = JEnv(params=params, resample_topology=resample, **ENV_SMALL, **kw)
    port = TEnv(sim=port_of(ref.sim), resample_topology=resample,
                draws=env_draws(ref), **ENV_SMALL, **kw)
    return ref, port


def check_env_step(out_t, out_j):
    """(state, obs, reward, done, info) of the port against the
    reference's."""
    s_t, o_t, r_t, d_t, i_t = out_t
    s_j, o_j, r_j, d_j, i_j = out_j
    if hasattr(s_j, "ep"):
        s_t, s_j = s_t.ep, s_j.ep
    check_state(s_t, s_j)
    np.testing.assert_allclose(np_(o_t.tput), np_(o_j.tput), rtol=1e-4,
                               atol=1.0)
    np.testing.assert_allclose(np_(o_t.backlog), np_(o_j.backlog),
                               rtol=1e-4, atol=1.0)
    np.testing.assert_allclose(float(r_t), float(r_j), rtol=1e-4)
    assert bool(d_t) == bool(d_j)
    check_telemetry(i_t["telemetry"], i_j["telemetry"])
    rc_t, rc_j = i_t["reward_components"], i_j["reward_components"]
    assert sorted(rc_t) == sorted(rc_j)
    for k in rc_j:
        np.testing.assert_allclose(np_(rc_t[k]), np_(rc_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def bursty(ref):
    """Does the reference env step with bursty traffic (then eagerly)?"""
    return ref.params.traffic_model != "full_buffer"


def seed_draws(ref_sim):
    """A port ``draws(seed, device)`` factory replaying the reference's
    episode key of ``seed`` (``radio.episode_key``: what
    ``init_episode_state(key=None)`` and the reference's ``TwinServer``
    draw from)."""
    return lambda seed, device: ReplayDraws(j_radio.episode_key(int(seed)),
                                            ref_sim)


def reference_twin_tree(ref_server, seed):
    """The reference ``TwinServer``'s serving tuple as numpy, its PRNG
    ``key`` dropped and the episode ``seed`` given: the input of
    ``convert.twin_tree``."""
    state = {k: np_(v) for k, v in ref_server.state._asdict().items()
             if v is not None and k != "key"}
    state["seed"] = seed
    return {"state": state, "power": np_(ref_server.power),
            "fairness": np_(ref_server.fairness)}


def first_divergence(tput_port, tput_ref, tti_s):
    """The first TTI at which two ``(n_tti, n_ues)`` throughput stacks
    differ beyond rtol 1e-4 (atol 1 bit/s), as ``(tti, sub_bit)``, or None.

    ``sub_bit`` says whether at that TTI one side served some UE less than
    one bit while the other did not serve it the same: the signature of a
    drained-backlog residue.  ``served_bits`` drains ``cap * (B / cap)``,
    which rounds to B or to B -/+ 1 ulp; a 1-ulp difference of the SE
    decides which, and a 1-ulp residue (~1e-3 bits at 12 000) still counts
    as demand and wins resource blocks at the next TTI.  Both packages do
    this, each in either direction: it is the MAC's near tie (ROADMAP
    queue 3), and the trajectories part there.
    """
    a, b = np_(tput_port), np_(tput_ref)
    bad = ~np.isclose(a, b, rtol=RTOL_TPUT, atol=1.0)
    if not bad.any():
        return None
    t = int(np.argwhere(bad.any(axis=1))[0, 0])
    bits_a, bits_b = a[t] * tti_s, b[t] * tti_s
    sub = lambda x: (x > 0.0) & (x < 1.0)
    flip = (sub(bits_a) | sub(bits_b)) & (bits_a != bits_b)
    return t, bool(flip.any())


def check_env_episode(name):
    """reset, a uniform step, a random-action step with a fairness
    override (reaching ``done``), then ``step_autoreset`` across the
    episode boundary, against the reference env of preset ``name``."""
    ref, port = env_pair(name)
    sj, oj = ref.reset(jax.random.PRNGKey(3))
    st, ot = port.reset(3)
    check_state(st, sj)
    assert int(st.seed) == 3
    np.testing.assert_array_equal(np_(ot.tput), np_(oj.tput))
    act = np.random.default_rng(0).uniform(
        0.0, port.max_cell_power_W, port.action_shape).astype(np.float32)
    with jax.disable_jit(bursty(ref)):
        out_j = ref.step(sj, ref.uniform_action())
        out_t = port.step(st, port.uniform_action())
        check_env_step(out_t, out_j)
        out_j = ref.step(out_j[0], jnp.asarray(act), jnp.float32(0.2))
        out_t = port.step(out_t[0], act, 0.2)
        check_env_step(out_t, out_j)
        assert bool(out_t[3])
        ar_j = ref.step_autoreset(out_j[0], None, jax.random.PRNGKey(7))
        ar_t = port.step_autoreset(out_t[0], None, 7)
    check_env_step((out_t[0],) + ar_t[1:], (out_j[0],) + ar_j[1:])
    fresh_j, _ = ref.reset(jax.random.PRNGKey(7))
    check_state(ar_t[0], fresh_j)
    assert int(ar_t[0].seed) == 7


def check_resampled_reset(name):
    """``resample_topology=True``: the reset of seed 11 redraws the field
    and fading (exact), reruns the chain (attachment exact, CQI/SE exact
    off the steps), and the first step holds the env contract; the
    reference's reset state, carried over, steps as the port's own.

    The step is one TTI (``ENV_SMALL``), so the reference steps compiled
    under any traffic: a drained-backlog residue of the compiled program
    (~1e-3 bits, within the contract's atol) can part two trajectories
    only at a later TTI, by counting as demand there."""
    ref, port = env_pair(name, resample=True)
    sj, _ = ref.reset(jax.random.PRNGKey(11))
    st, _ = port.reset(11)
    np.testing.assert_array_equal(np_(st.ep.U), np_(sj.ep.U))
    np.testing.assert_array_equal(np_(st.static.fad), np_(sj.static.fad))
    # the chain on the redrawn field: attachment and CQI/SE exact
    out = j_radio.radio_forward(ref.sim.radio_static(), sj.ep.U,
                                fad=sj.static.fad)
    G0 = j_radio.pathgains(ref.sim.radio_config(), sj.ep.U, ref.sim.C._data,
                           ref.sim.boresight._data)
    cfg = ref.sim.radio_config()
    meas = j_radio.rsrp(G0 if cfg.rayleigh_fading and cfg.attach_ignores_fading
                        else j_radio.apply_fading(G0, sj.static.fad),
                        ref.sim.P._data).sum(axis=-1)
    assert_attachment(st.static.a, sj.static.a, meas)
    assert_cqi(st.static.cqi, sj.static.cqi, out.gamma)
    assert_cqi(st.static.se, sj.static.se, out.gamma)
    check_state(st.ep, sj.ep)
    out_j = ref.step(sj, ref.uniform_action())
    out_t = port.step(st, port.uniform_action())
    check_env_step(out_t, out_j)
    obs = convert.env_obs({k: np_(v) for k, v in out_j[1]._asdict().items()},
                          DEV)
    np.testing.assert_allclose(np_(obs.tput), np_(out_t[1].tput), rtol=1e-4,
                               atol=1.0)
    # the reference's reset state, carried over, steps like the port's own
    as_dict = lambda nt: {k: np_(v) for k, v in nt._asdict().items()
                          if v is not None}
    carried = convert.topo_env_state(
        {"ep": dict(as_dict(sj.ep), seed=np.int64(11)),
         "static": as_dict(sj.static)}, DEV)
    out_c = port.step(carried, port.uniform_action())
    check_env_step(out_c, out_j)
    assert torch.equal(out_c[0].ep.U, out_t[0].ep.U)
    with pytest.raises(ValueError, match="resample_topology"):
        port.step_autoreset(st, None, 1)


def top2_margin(logits):
    """(argmax, gap between the two largest) over the last axis: greedy
    decoding's near tie.  XLA and PyTorch reduce in different orders, so a
    gap near zero may flip the argmax; a flip is counted against the
    reference's gap, as an attachment's near tie is
    (``tests/lm_fixture.py``'s ``hold``)."""
    arg, margin, _ = lm_fixture.top2(np_(logits))
    return arg, margin

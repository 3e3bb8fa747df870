"""The port's differentiable engine (``relax=``) against the JAX package.

Mirrors ``tests/test_rl.py``'s differentiability contracts and holds each
piece of the relaxed chain to the reference on the same inputs:

* the soft SE staircase, the soft attachment and ``se_chain_relaxed`` to
  rtol 1e-6 (the same float32 ops; atol 1e-6 bits/s/Hz where the
  surrogate is ~0);
* the segment reductions against the reference's differentiable ones: the
  same primal, and a gradient equal to ``jax.grad``'s where no two rows
  tie at a maximum; the allocators' primal and a finite pf gradient;
* the soft max_cqi allocator to rtol 1e-6 and its properties;
* ``relax=None`` and every flag off: the legacy engine bit for bit, and
  the reference's relaxed engine within the engine contract
  (``torch_parity.check_state``);
* the straight-through forward equals the hard chain (rtol 1e-6) with a
  nonzero finite gradient; the gradient contract itself
  (tests/test_rl.py:47) is in tests/test_torch_relax_grad.py;
* the guards (churn, incremental, faults, mesh) and the fused route,
  which raises on an input that requires grad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.env.crrm_env import expand_action as j_expand
from repro.mac import scheduler as j_sched
from repro.mac import segments as j_seg
from repro.sim import phy as j_phy
from repro.sim import radio as j_radio
from repro.sim.radio import RelaxConfig as JRelax
from repro.sim.scenarios import make_scenario
from repro_torch.kernels import fused_sinr as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.mac import scheduler as t_sched
from repro_torch.mac import segments as t_seg
from repro_torch.sim import phy as t_phy
from repro_torch.sim import radio as t_radio
from repro_torch.sim.faults import FaultConfig
from repro_torch.sim.mobility import ChurnConfig
from repro_torch.sim.radio import RelaxConfig
from torch_parity import ReplayDraws, carried, check_state, np_, pair

OFF = dict(soft_attach=False, cqi_mode="hard", soft_sched=False)


def t_(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------ the pieces
def test_soft_spectral_efficiency_matches_reference():
    db = np.linspace(-15.0, 30.0, 901, dtype=np.float32)
    gamma = (10.0 ** (db / 10.0)).astype(np.float32)
    for sharp in (2.0, 0.5):
        want = np_(j_phy.soft_spectral_efficiency(jnp.asarray(gamma), sharp))
        got = np_(t_phy.soft_spectral_efficiency(t_(gamma), sharp))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["soft", "ste", "hard"])
def test_se_chain_relaxed_matches_reference(mode):
    """Wideband EESM reports over 4 CQI subbands (``dense_urban``'s grid):
    the soft SE to rtol 1e-6, the reported CQI exact."""
    params = make_scenario("dense_urban", n_ues=8, cqi_report="wideband")
    ref, port = pair(params)
    rng = np.random.default_rng(5)
    gamma = (10.0 ** (rng.uniform(-8, 25, (8, 4)) / 10)).astype(np.float32)
    relax_j, relax_t = JRelax(cqi_mode=mode), RelaxConfig(cqi_mode=mode)
    se_j, cqi_j = j_radio.se_chain_relaxed(ref.radio_config(),
                                           jnp.asarray(gamma), relax_j)
    se_t, cqi_t = t_radio.se_chain_relaxed(port.radio_config(), t_(gamma),
                                           relax_t)
    np.testing.assert_allclose(np_(se_t), np_(se_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np_(cqi_t), np_(cqi_j))


def test_soft_attach_sinr_matches_reference():
    rng = np.random.default_rng(3)
    R = (10.0 ** rng.uniform(-13, -7, (16, 7, 4))).astype(np.float32)
    meas = R.sum(axis=-1)
    for tau in (0.1, 1.0):
        want = np_(j_radio.soft_attach_sinr(jnp.asarray(R), jnp.asarray(meas),
                                            tau, 1e-13))
        got = np_(t_radio.soft_attach_sinr(t_(R), t_(meas), tau, 1e-13))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_differentiable_segments_match_reference():
    """The reductions (autograd records them) return the
    reference's differentiable ones: the maxima bit for bit, the sums to
    float32 rounding (rtol 1e-6); their gradients equal ``jax.grad``'s
    (no ties at the maxima: distinct random values)."""
    rng = np.random.default_rng(7)
    data = rng.normal(size=(12, 3)).astype(np.float32)
    seg = np.array([0, 2, 2, 1, 0, 0, 3, 3, 2, 1, 0, 3], np.int32)
    w = rng.normal(size=(4, 3)).astype(np.float32)

    x = t_(data).requires_grad_(True)
    s = t_seg.segment_sum(x, t_(seg), 4)
    m = t_seg.segment_max(x, t_(seg), 4, fill=-1e30)
    d, sj = jnp.asarray(data), jnp.asarray(seg)
    np.testing.assert_allclose(np_(s), np_(j_seg.segment_sum(
        d, sj, 4, differentiable=True)), rtol=1e-6)
    np.testing.assert_array_equal(np_(m), np_(j_seg.segment_max(
        d, sj, 4, fill=-1e30, differentiable=True)))
    (g,) = torch.autograd.grad(((s + 2 * m) * t_(w)).sum(), x)

    def f(d):
        s = j_seg.segment_sum(d, sj, 4, differentiable=True)
        m = j_seg.segment_max(d, sj, 4, fill=-1e30, differentiable=True)
        return ((s + 2 * m) * w).sum()

    np.testing.assert_allclose(np_(g), np_(jax.grad(f)(d)), rtol=1e-6)


def test_soft_max_cqi_allocator_matches_reference_and_its_properties():
    """The softmax share: the full n_rb budget split over the active UEs
    of each nonempty cell, nothing to inactive UEs, the hard winner as
    tau -> 0; and the reference's shares to rtol 1e-6."""
    n_ue, n_cells, n_rb = 8, 3, 12
    se = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (n_ue,),
                                       jnp.float32, 0.1, 5.0))
    a = np.array([0, 0, 0, 1, 1, 2, 2, 2], np.int32)
    active = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)
    for tau in (1.0, 0.3):
        want = np_(j_sched.allocate_max_cqi_soft(
            jnp.asarray(active), jnp.asarray(se), jnp.asarray(a), n_cells,
            n_rb, tau))
        got = np_(t_sched.allocate_max_cqi_soft(t_(active), t_(se), t_(a),
                                                n_cells, n_rb, tau))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    alloc = got
    assert (alloc[~active] == 0.0).all()
    per_cell = np.zeros(n_cells)
    np.add.at(per_cell, a, alloc)
    np.testing.assert_allclose(per_cell, np.full(n_cells, float(n_rb)),
                               rtol=1e-5)
    sharp = np_(t_sched.allocate_max_cqi_soft(t_(active), t_(se), t_(a),
                                              n_cells, n_rb, 1e-4))
    hard = np.zeros(n_ue, np.float32)
    for c in range(n_cells):
        ues = [u for u in range(n_ue) if a[u] == c and active[u]]
        hard[max(ues, key=lambda u: se[u])] = n_rb
    np.testing.assert_allclose(sharp, hard, atol=1e-3)


def _legacy_pf(active, log_w, a, n_cells, n_rb):
    """The weighted split as the port computed it before the relaxed
    engine: a -inf idle weight, in-place reductions, a 1e-30 floor."""
    neg = float("-inf")
    log_w = torch.where(active, log_w, neg)
    cell_max = torch.full((n_cells, log_w.shape[-1]), neg).scatter_reduce_(
        0, a.long()[:, None].expand_as(log_w), log_w, reduce="amax",
        include_self=True)
    w = torch.where(active, torch.exp(log_w - cell_max[a.long()]), 0.0)
    denom = torch.zeros_like(cell_max).index_add_(0, a.long(), w)[a.long()]
    return n_rb * torch.where(denom > 0.0,
                              w / torch.clamp(denom, min=1e-30), 0.0)


@pytest.mark.parametrize("policy", ["pf", "rr"])
def test_differentiable_allocators_keep_the_primal(policy):
    """The allocators the relaxed engine differentiates through (finite
    idle sentinel, 1e-15 floor) allocate what
    the reference's do -- rr exactly, pf to rtol 1e-6 and bit for bit
    what the port's earlier -inf form did -- and pf's gradient is finite
    with an idle UE and a cell with no active UE."""
    rng = np.random.default_rng(11)
    n_ue, n_cells, k = 24, 5, 4
    active_np = rng.random((n_ue, k)) < 0.7
    a_np = rng.integers(0, n_cells - 1, n_ue).astype(np.int32)  # cell 4 empty
    active_np[a_np == 2] = False                                 # cell 2 idle
    log_w_np = rng.normal(size=(n_ue, k)).astype(np.float32)
    cqi_np = rng.integers(0, 16, (n_ue, k)).astype(np.int32)
    active, a, log_w = t_(active_np), t_(a_np), t_(log_w_np)
    leaf = log_w.clone().requires_grad_(True)
    got = t_sched.allocate(policy, active, t_(cqi_np), a, n_cells, 12, 3,
                           leaf)
    want = j_sched.allocate(policy, jnp.asarray(active_np),
                            jnp.asarray(cqi_np), jnp.asarray(a_np), n_cells,
                            12, 3, jnp.asarray(log_w_np), differentiable=True)
    if policy == "rr":
        np.testing.assert_array_equal(np_(got), np_(want))
        return
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6)
    np.testing.assert_array_equal(np_(got), np_(_legacy_pf(
        active, log_w, a, n_cells, 12)))
    (g,) = torch.autograd.grad((got * t_(cqi_np)).sum(), leaf)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0
    assert not g[~active].any()


# ------------------------------------------------------------ the engine
def _uniform_grid_j(ref):
    p = ref.params
    a = jnp.full((ref.n_cells, p.n_subbands), p.power_W / p.n_subbands,
                 jnp.float32)
    return j_expand(p, a)


def _objectives(scenario, n_ues, n_tti, relax_j, relax_t, key=0):
    """(reference objective, port objective, P0 as a numpy grid): the mean
    served Mbit/s of an ``n_tti`` rollout under a power grid, both from
    the reference's initial state, the port on the reference's draws."""
    ref, port = pair(make_scenario(scenario, n_ues=n_ues))
    k = jax.random.PRNGKey(key)
    static_j, state_j, static_t, state_t = carried(ref, k)
    fns_j = ref.episode_fns(radio_mode="dense", relax=relax_j)
    fns_t = port.episode_fns(radio_mode="dense", relax=relax_t)

    def f_j(P):
        return fns_j.rollout(static_j, state_j, n_tti, P)[1].mean() / 1e6

    def f_t(P):
        return fns_t.rollout(static_t, state_t, n_tti, ReplayDraws(k, ref),
                             P)[1].mean() / 1e6

    return f_j, f_t, np_(_uniform_grid_j(ref))


def test_relax_off_is_bitwise_legacy_and_matches_reference():
    """Every relaxation off: the forward pass is the port's legacy engine
    bit for bit, and the reference's relaxed engine (all off) within the
    engine contract."""
    ref, port = pair(make_scenario("dense_urban", n_ues=10))
    k = jax.random.PRNGKey(2)
    static_j, state_j, static_t, state_t = carried(ref, k)
    P = _uniform_grid_j(ref)
    outs = [port.episode_fns(radio_mode="dense", relax=relax).rollout(
                static_t, state_t, 6, ReplayDraws(k, ref), t_(P))
            for relax in (RelaxConfig(**OFF), None)]
    (s_off, t_off), (s_leg, t_leg) = outs
    np.testing.assert_array_equal(np_(t_off), np_(t_leg))
    for a, b in zip(s_off, s_leg):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(np_(a), np_(b))
    s_j, t_j = ref.episode_fns(radio_mode="dense", relax=JRelax(**OFF)) \
        .rollout(static_j, state_j, 6, P)
    np.testing.assert_allclose(np_(t_off), np_(t_j), rtol=1e-4, atol=1.0)
    check_state(s_off, s_j)


def test_ste_forward_matches_hard_with_nonzero_grad():
    """Straight-through CQI: the forward is the hard staircase (to the
    a + (b - a) round trip) and the backward carries the soft surrogate's
    nonzero gradient."""
    _, f_ste, P0 = _objectives("dense_urban", 10, 4, None,
                               RelaxConfig(soft_attach=False, cqi_mode="ste",
                                           soft_sched=False))
    _, f_hard, _ = _objectives("dense_urban", 10, 4, None, None)
    P = t_(P0).requires_grad_(True)
    v = f_ste(P)
    with torch.no_grad():
        np.testing.assert_allclose(float(v), float(f_hard(t_(P0))),
                                   rtol=1e-6)
    (g,) = torch.autograd.grad(v, P)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0, "STE gradient vanished"


# ------------------------------------------------------------ the guards
def test_relax_combination_guards():
    """The reference's four guards: mesh, churn, incremental and faults
    each raise under ``relax`` (the mesh before its not-yet-ported
    error)."""
    _, port = pair(make_scenario("dense_urban", n_ues=8))
    churn = ChurnConfig(arrival_rate_hz=10.0, mean_lifetime_s=1.0,
                        max_arrivals_per_tti=2)
    with pytest.raises(ValueError, match="relax"):
        port.episode_fns(mesh=object(), relax=RelaxConfig())
    with pytest.raises(ValueError, match="relax"):
        port.episode_fns(churn=churn, relax=RelaxConfig())
    with pytest.raises(ValueError, match="dense"):
        port.episode_fns(radio_mode="incremental", relax=RelaxConfig())
    with pytest.raises(ValueError, match="relax"):
        port.episode_fns(faults=FaultConfig(1.0, 0.1, 1.0, 0.1, 10.0),
                         relax=RelaxConfig())


def test_relax_is_a_hashable_cache_key():
    _, port = pair(make_scenario("dense_urban", n_ues=8))
    a = port.episode_fns(radio_mode="dense", relax=RelaxConfig())
    assert port.episode_fns(radio_mode="dense", relax=RelaxConfig()) is a
    assert port.episode_fns(radio_mode="dense",
                            relax=RelaxConfig(cqi_mode="ste")) is not a


def test_fused_route_raises_on_an_input_that_requires_grad():
    """``fused_sinr`` has no backward: every route to it raises, naming the
    inputs, instead of detaching them; without autograd it runs."""
    ref, port = pair(make_scenario("dense_urban", n_ues=8))
    static = port.radio_static()
    U = port.U._data
    P = static.P.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="Pw require grad.*no backward"):
        t_radio.radio_forward(static, U, P=P, backend="fused")
    with pytest.raises(ValueError, match="U require grad"):
        t_radio.radio_forward(static, U.clone().requires_grad_(True),
                              backend="fused")
    cfg = static.cfg
    with pytest.raises(ValueError, match="no backward"):
        t_ops.fused_sinr(U, static.C, P, pathgain_fn=cfg.pathgain_fn,
                         noise_w=cfg.noise_w, boresight=static.bore,
                         n_sectors=cfg.n_sectors)
    fad = port.fading._data.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="fad require grad"):
        t_fused.fused_sinr_accumulate(
            U, static.C, static.P, static.bore, fad,
            pathgain_fn=cfg.pathgain_fn, n_sectors=cfg.n_sectors)
    with torch.no_grad():
        out = t_radio.radio_forward(static, U, P=P, backend="fused")
    want = t_radio.radio_forward(static, U, P=P.detach(), backend="torch")
    np.testing.assert_array_equal(np_(out.a), np_(want.a))

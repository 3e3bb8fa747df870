"""The port's per-TTI telemetry and ``fairness_p`` override against the JAX
package, and telemetry's structural no-op inside the port.

``tti_telemetry``/``summarize`` run on the same numpy inputs in both
packages; engine rollouts with ``telemetry=True`` start from the same
carried state and replay the reference's draws (``torch_parity.run_pair``;
bursty traffic rolls the reference out eagerly).  Contract
(``torch_parity.check_telemetry``): integer KPIs exact; float KPIs rtol
1e-4, since the per-cell segment sums add in another order than XLA's
scatter-add.  ``summarize`` of one stack is computed in numpy by both, so
its floats agree exactly.  Telemetry on vs off in the port: bit-equal
trajectories.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.params import CRRM_parameters as JParams
from repro.obs import telemetry as j_tel
from repro.sim import scenarios as j_scen
from repro_torch import convert
from repro_torch.core.crrm import CRRM
from repro_torch.core.distributed import make_mesh
from repro_torch.core.params import CRRM_parameters
from repro_torch.mac.engine import Draws
from repro_torch.obs import telemetry as t_tel
from torch_mesh import one_rank_group
from torch_parity import DEV, check_state, check_telemetry, np_, run_pair

N_TTI = 8


def step_inputs(seed, n_ues=40, n_cells=5, k=3):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_cells, n_ues).astype(np.int32)
    alloc = rng.uniform(0, 8, (n_ues, k)).astype(np.float32)
    bits = np.where(rng.random(n_ues) < 0.3, 0.0,
                    rng.uniform(0, 1e5, n_ues)).astype(np.float32)
    tput = (bits / 1e-3).astype(np.float32)
    backlog = rng.uniform(0, 1e6, n_ues).astype(np.float32)
    backlog[::7] = np.inf
    stats = (np.int32(11), np.int32(3), np.int32(2), np.float32(1234.5))
    return (n_cells, n_ues, a, alloc, bits, tput, backlog, stats,
            np.int32(4), np.int32(9))


@pytest.mark.parametrize("seed", [0, 1])
def test_tti_telemetry_and_summarize_match_reference(seed):
    args = step_inputs(seed)
    n_cells, n_ues, rest = args[0], args[1], args[2:]
    jargs = [tuple(jnp.asarray(x) for x in r) if isinstance(r, tuple)
             else jnp.asarray(r) for r in rest]
    targs = [tuple(torch.as_tensor(x) for x in r) if isinstance(r, tuple)
             else torch.as_tensor(r) for r in rest]
    tel_j = j_tel.tti_telemetry(n_cells, n_ues, *jargs)
    tel_t = t_tel.tti_telemetry(n_cells, n_ues, *targs)
    check_telemetry(tel_t, tel_j)
    # a stack of three TTIs, carried over leaf by leaf
    stack_j = [j_tel.tti_telemetry(n_cells, n_ues, *[
        tuple(jnp.asarray(x) for x in r) if isinstance(r, tuple)
        else jnp.asarray(r) for r in step_inputs(seed + s)[2:]])
        for s in range(3)]
    stack_j = j_tel.Telemetry(*(None if v[0] is None else np.stack(
        [np_(x) for x in v]) for v in zip(*stack_j)))
    carried = convert.telemetry(stack_j._asdict(), DEV)
    assert carried.served_bits.dtype == torch.float32
    assert carried.harq_acks.dtype == torch.int32
    assert t_tel.summarize(carried, 1e-3) == j_tel.summarize(stack_j, 1e-3)
    assert (t_tel.format_summary(t_tel.summarize(carried))
            == j_tel.format_summary(j_tel.summarize(stack_j)))


def test_stack_and_later_slice_arguments(tmp_path):
    args = step_inputs(0)
    targs = [tuple(torch.as_tensor(x) for x in r) if isinstance(r, tuple)
             else torch.as_tensor(r) for r in args[2:]]
    one = t_tel.tti_telemetry(args[0], args[1], *targs)
    st = t_tel.stack([one, one])
    assert st.served_bits.shape == (2, args[0]) and st.active_ues is None
    # the churn and fault counts are published as given (ported)
    counts = dict(active_count=torch.tensor(3, dtype=torch.int32),
                  cells_down=torch.tensor(1, dtype=torch.int32),
                  reattached=torch.tensor(2, dtype=torch.int32))
    got = t_tel.tti_telemetry(args[0], args[1], *targs, **counts)
    assert (int(got.active_ues), int(got.cells_down),
            int(got.reattach_events)) == (3, 1, 2)
    # the mesh reductions (ported): over a 1-rank mesh every sum is the
    # rank's own, so the KPIs are the unsharded ones bit for bit (2-rank
    # meshes: tests/test_torch_mesh_{engine,env}.py)
    with one_rank_group(tmp_path):
        ue = make_mesh((1,), ("ue",), "cpu").axes("ue")
        meshed = t_tel.tti_telemetry(args[0], args[1], *targs, ue_axes=ue,
                                     **counts)
    for name, x, y in zip(got._fields, got, meshed):
        assert (x is None and y is None) or torch.equal(x, y), name


BASE = dict(n_ues=40, n_cells=7, seed=2, pathloss_model_name="UMa",
            power_W=10.0, extent_m=1500.0)
MILLION = dict(n_cells=19, n_sectors=1, seed=3, pathloss_model_name="UMa",
               power_W=10.0, scheduler_policy="pf", fairness_p=0.5,
               mobility_step_m=20.0, mobility_move_frac=0.1)

CASES = {
    # dense: stop-and-wait HARQ, A3 handover, per-RB fading, bursty traffic
    "dense_handover_harq": (lambda: j_scen.make_scenario(
        "handover_stress", n_ues=40, n_cells=7, mobility_step_m=5.0), {}),
    # dense: HARQ-lite (the telemetry's own ack/nack count)
    "dense_harq_lite": (lambda: JParams(
        **BASE, scheduler_policy="pf", fairness_p=0.5, harq_bler=0.1,
        traffic_model="poisson",
        traffic_params=dict(arrival_rate_hz=300.0)), dict(use_harq=False)),
    # incremental: the million-episode configuration (dirty rows counted)
    "incremental_window": (lambda: JParams(
        n_ues=40, radio_mode="incremental", **MILLION),
        dict(inc_backend="xla")),
    # incremental with the handover tables and HARQ (dense_urban_twin;
    # full buffer, so the reference runs compiled)
    "incremental_twin": (lambda: j_scen.make_scenario(
        "dense_urban_twin", n_ues=40, n_cells=6,
        traffic_model="full_buffer"), dict(inc_backend="xla")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_telemetry_matches_reference(case):
    make, kw = CASES[case]
    params = make()
    out_j, out_t = run_pair(params, n_tti=N_TTI, telemetry=True, **kw)
    (s_j, tput_j, tel_j), (s_t, tput_t, tel_t) = out_j, out_t
    np.testing.assert_allclose(tput_t, tput_j, rtol=1e-4, atol=1.0)
    check_state(s_t, s_j)
    assert tel_t.served_bits.shape == (N_TTI, params.n_cells)
    check_telemetry(tel_t, tel_j)


def test_fairness_override_matches_reference():
    """pf with ``fairness_p`` overridden per call, against the reference's
    traced override; the override moves the trajectory."""
    params = JParams(**BASE, scheduler_policy="pf", fairness_p=0.5,
                     rayleigh_fading=True, mobility_step_m=10.0)
    out_j, out_t = run_pair(params, n_tti=N_TTI, fairness_p=0.1)
    np.testing.assert_allclose(out_t[1], out_j[1], rtol=1e-4, atol=1.0)
    check_state(out_t[0], out_j[0])
    _, base_t = run_pair(params, n_tti=N_TTI)
    assert not np.allclose(base_t[1], out_t[1], rtol=1e-3)


PORT_CASES = [
    dict(n_ues=48, n_cells=7, harq_bler=0.1, traffic_model="poisson",
         rayleigh_fading=True, n_rb_subbands=2, ho_enabled=True,
         mobility_step_m=10.0),
    dict(n_ues=48, n_cells=7, radio_mode="incremental", mobility_step_m=10.0,
         mobility_move_frac=0.25, scheduler_policy="rr"),
    dict(n_ues=48, n_cells=7, harq_bler=0.2, scheduler_policy="max_cqi"),
]


@pytest.mark.parametrize("i", range(len(PORT_CASES)))
def test_telemetry_is_a_structural_no_op(i):
    """Telemetry on vs off: bit-equal throughput and state, through
    ``rollout``, ``step`` and ``run_episode``."""
    p = CRRM_parameters(**PORT_CASES[i])
    out = {}
    for on in (False, True):
        sim = CRRM(p, device="cpu")
        fns = sim.episode_fns(telemetry=on)
        st, s0 = sim.episode_static(), sim.init_episode_state()
        r = fns.rollout(st, s0, 6, Draws(4, "cpu"), None, 0.3)
        one = fns.step(st, r[0], Draws(4, "cpu"))
        run = sim.run_episode(6, draws=Draws(4, "cpu"), telemetry=on)
        out[on] = (r, one, run)
    (r0, one0, run0), (r1, one1, run1) = out[False], out[True]
    assert len(r0) == 2 and len(r1) == 3 and len(one1) == 3
    assert torch.equal(r0[1], r1[1]) and torch.equal(one0[1], one1[1])
    assert torch.equal(run0, run1[0])
    for a, b in ((r0[0], r1[0]), (one0[0], one1[0])):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
    tel = r1[2]
    assert tel.jain.shape == (6,) and one1[2].jain.shape == ()
    assert (tel.dirty_rows is None) == (p.radio_mode == "dense")
    if tel.dirty_rows is not None:
        assert tel.dirty_rows.tolist() == [12] * 6   # 25 % of 48 move

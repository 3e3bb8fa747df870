"""The fault re-pricing over the carried gain (``kernels/reprice_cells``) and
its route in ``radio.radio_update_cells``, on the CPU.

``reprice_cells_plain`` is held bit for bit to the torch re-pricing of
``radio_update_cells`` on every gain layout (G (N, M) at K = 1 and 4, G
(N, M, K) with the unfaded G0), with dark and sleeping cells and exact
ties; ``backend="auto"`` takes it (and no other backend does) where the
state carries no handover tables and the cells are not sharded; a TTI
without a cell change keeps the carried outputs and the carried gain
itself; a storm rollout on ``"auto"`` equals one on ``"torch"``.  The
kernel against its plain version is in ``tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters
from repro_torch.kernels import ops
from repro_torch.kernels import reprice_cells as rck
from repro_torch.mac.engine import Draws
from repro_torch.sim import faults as sim_faults
from repro_torch.sim import radio
from torch_mesh import one_rank_group

STORM = sim_faults.FaultConfig(outage_rate_hz=20.0, mean_outage_s=0.03,
                               sleep_rate_hz=20.0, mean_sleep_s=0.02,
                               sleep_atten_db=10.0)
#: gain layouts: (name, CRRM_parameters overrides)
LAYOUTS = {
    "nm_k1": dict(),
    "nm_k4": dict(n_subbands=4),
    "nmk_g0": dict(rayleigh_fading=True, attach_ignores_fading=True,
                   n_rb_subbands=4),
    "nm_g0": dict(rayleigh_fading=True, attach_ignores_fading=True),
    "nm_faded": dict(rayleigh_fading=True, attach_ignores_fading=False),
}


def carried(layout, n_ues=300, n_cells=13, with_tables=False):
    """(cfg, carried RadioState with gains, P with dark and sleeping
    cells) of a small field."""
    sim = CRRM(CRRM_parameters(n_ues=n_ues, n_cells=n_cells, seed=4,
                               **LAYOUTS[layout]), device="cpu")
    cfg, st = sim.radio_config(), sim.radio_static()
    fad = sim.fading._data if cfg.rayleigh_fading else None
    rs = radio.radio_init(cfg, sim.U._data, st.C, st.bore, fad, st.P,
                          with_tables=with_tables, with_gain=True)
    mult = torch.ones(n_cells)
    mult[[1, 6]] = 0.0                    # DOWN: dark
    mult[[4, 9]] = 0.1                    # SLEEP: 10 dB down
    return cfg, rs, (st.P * mult[:, None]).contiguous()


def clone(rs):
    return radio.RadioState(*(None if x is None else x.clone() for x in rs))


def g0_of(cfg, rs):
    return rs.G0 if cfg.rayleigh_fading and cfg.attach_ignores_fading \
        else None


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls that reach the plain version."""
    calls = []
    real = rck.reprice_cells_plain

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(rck, "reprice_cells_plain", counted)
    return calls


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_equals_the_torch_repricing_bit_for_bit(layout):
    cfg, rs, P = carried(layout)
    assert rs.G.dim() == (3 if layout == "nmk_g0" else 2)
    assert (rs.G0 is not None) == layout.endswith("g0")
    dirty = torch.ones(P.shape[0], dtype=torch.bool)
    want = radio.radio_update_cells(cfg, clone(rs), P, dirty,
                                    backend="torch")
    a, gamma = rck.reprice_cells_plain(rs.G, P, cfg.noise_w, g0_of(cfg, rs))
    se, cqi = radio.se_chain(cfg, gamma)
    assert a.dtype == torch.int32 and gamma.shape == (300, cfg.n_freq)
    assert torch.equal(a, want.a)
    assert torch.equal(se, want.se) and torch.equal(cqi, want.cqi)
    assert not bool(((a == 1) | (a == 6)).any())     # dark cells serve none
    got = radio.radio_update_cells(cfg, clone(rs), P, dirty, backend="auto")
    for name in ("a", "se", "cqi"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("k", [1, 4])
def test_exact_ties_go_to_the_lowest_cell(k):
    n, m = 64, 9
    G = torch.rand((n, m)) * 1e-10
    G[:, 2] = G[:, 5] = G[:, 7] = 1e-8        # three equal best links
    P = torch.full((m, k), 2.0)
    a, gamma = rck.reprice_cells_plain(G, P, 1e-13)
    assert bool((a == 2).all())
    # the wanted power is the tied link's, the other two interfere
    w, tot = 2e-8, (G * 2.0).sum(1, keepdim=True)
    torch.testing.assert_close(gamma, w / (1e-13 + (tot - w)).expand(n, k))


@pytest.mark.parametrize("route", ["torch", "auto"])
def test_a_tti_without_a_cell_change_keeps_the_carried_outputs(route):
    cfg, rs, P = carried("nm_k1")
    before = clone(rs)
    quiet = torch.zeros(P.shape[0], dtype=torch.bool)
    out = radio.radio_update_cells(cfg, rs, P, quiet, backend=route)
    for name in ("a", "se", "cqi"):
        assert torch.equal(getattr(out, name), getattr(before, name)), name
    assert out.G is rs.G                      # carried as it is, no copy
    assert out.meas is None and out.se_all is None
    moved = radio.radio_update_cells(cfg, rs, P, ~quiet, backend=route)
    assert moved.G is rs.G and not torch.equal(moved.a, before.a)


def test_the_unfaded_gain_is_carried_as_it_is():
    cfg, rs, P = carried("nmk_g0")
    dirty = torch.ones(P.shape[0], dtype=torch.bool)
    for route in ("torch", "auto"):
        out = radio.radio_update_cells(cfg, rs, P, dirty, backend=route)
        assert out.G is rs.G and out.G0 is rs.G0


@pytest.mark.parametrize("route,calls", [("auto", 1), ("torch", 0),
                                         (None, 0)])
def test_only_auto_takes_the_one_pass_route(plain_calls, route, calls):
    cfg, rs, P = carried("nm_k1")
    dirty = torch.ones(P.shape[0], dtype=torch.bool)
    radio.radio_update_cells(cfg, rs, P, dirty, backend=route)
    assert len(plain_calls) == calls


def test_handover_tables_keep_the_torch_route(plain_calls):
    cfg, rs, P = carried("nm_k1", with_tables=True)
    assert rs.se_all is not None
    dirty = torch.ones(P.shape[0], dtype=torch.bool)
    want = radio.radio_update_cells(cfg, clone(rs), P, dirty,
                                    backend="torch")
    got = radio.radio_update_cells(cfg, clone(rs), P, dirty, backend="auto")
    assert not plain_calls
    assert torch.equal(got.se_all, want.se_all)
    assert torch.equal(got.meas, want.meas)


def test_a_cell_sharded_state_keeps_the_torch_route(plain_calls, tmp_path):
    cfg, rs, P = carried("nm_k1")
    dirty = torch.ones(P.shape[0], dtype=torch.bool)
    with one_rank_group(tmp_path):
        cell_axis = D.make_mesh((1,), ("cell",), "cpu").axes("cell")
        got = radio.radio_update_cells(cfg, clone(rs), P, dirty,
                                       cell_axis=cell_axis, backend="auto")
    assert not plain_calls
    want = radio.radio_update_cells(cfg, clone(rs), P, dirty,
                                    backend="auto")
    assert torch.equal(got.a, want.a)


def storm_sim(**kw):
    return CRRM(CRRM_parameters(
        n_ues=60, n_cells=7, seed=2, radio_mode="incremental",
        mobility_step_m=10.0, mobility_move_frac=0.25, faults=STORM, **kw),
        device="cpu")


@pytest.mark.parametrize("overrides", [dict(), dict(n_subbands=4),
                                       dict(rayleigh_fading=True)])
def test_storm_rollout_on_auto_equals_torch(plain_calls, overrides):
    sim = storm_sim(**overrides)
    static, state = sim.episode_static(), sim.init_episode_state()
    out = {}
    for route in ("torch", "auto"):
        fns = sim.episode_fns(inc_backend=route)
        assert fns.inc_backend == "torch"          # the rows stay torch
        out[route] = fns.rollout(static, state, 30, Draws(1, "cpu"))
        if route == "torch":
            assert not plain_calls
    assert len(plain_calls) == 30                 # one re-pricing a TTI
    (s_t, t_t), (s_a, t_a) = out["torch"], out["auto"]
    assert torch.equal(t_a, t_t)
    for x, y in zip(s_a, s_t):
        assert (x is None and y is None) or torch.equal(x, y)
    assert bool((s_t.cell_state != 0).any())      # the storm did change cells


def test_wrapper_checks_its_inputs_and_counts_only_kernel_launches():
    G, P = torch.rand((10, 4)), torch.rand((4, 1))
    before = rck.reprice_cells.launches
    a, gamma = ops.reprice_cells(G, P, 1e-13)
    assert rck.reprice_cells.launches == before   # the plain version ran
    assert a.shape == (10,) and gamma.shape == (10, 1)
    with pytest.raises(TypeError, match="float32"):
        rck.reprice_cells(G.double(), P, 1e-13)
    with pytest.raises(TypeError, match="float32"):
        rck.reprice_cells(G, P, 1e-13, G0=G.half())
    with pytest.raises(ValueError, match="shape"):
        rck.reprice_cells(G, torch.rand((5, 1)), 1e-13)
    with pytest.raises(ValueError, match="shape"):
        rck.reprice_cells(torch.rand((10, 4, 2)), torch.rand((4, 3)), 1e-13)
    with pytest.raises(ValueError, match="shape"):
        rck.reprice_cells(G, P, 1e-13, G0=torch.rand((10, 5)))
    with pytest.raises(ValueError, match="contiguous"):
        rck.reprice_cells(torch.rand((4, 10)).t(), P, 1e-13)
    with pytest.raises(ValueError, match="contiguous"):
        rck.reprice_cells(G, torch.rand((2, 4)).t(), 1e-13)
    with pytest.raises(ValueError, match="tensor"):
        rck.reprice_cells(torch.rand(10), P, 1e-13)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rck.reprice_cells(G.to("meta"), P.to("meta"), 1e-13)
    assert rck.reprice_cells.launches == before


def test_work_of_one_pass_over_the_million_ue_field():
    # 4 N M of G, the 127 powers, 4 N of a and 4 N K of gamma
    ops_, nbytes = rck.work(1_000_000, 127, 1)
    assert nbytes == 4 * 127_000_000 + 4 * 127 + 4_000_000 + 4_000_000
    assert ops_ == 1_000_000 * 127 * 4

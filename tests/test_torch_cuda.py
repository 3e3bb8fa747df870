"""The port's hand-written CUDA kernels against their plain PyTorch
versions.

These tests need a CUDA device and the CUDA toolkit: each one asks the
``cuda`` fixture, which skips on a host without a card.  They run on the
card with ``python -m pytest -m gpu tests/test_torch_cuda.py``.

Contract (the fused kernel vs ``fused_sinr_accumulate_plain`` on the same
card and inputs): ``total``/``w_best``/gamma to rtol 1e-4 (sum order and
ulp differences of log10f/powf against PyTorch's kernels); attachment
exact except on rows whose two best measurements differ by less than 1e-5
relative in the plain version (counted; at most 1 % of the rows).  The
pairwise-distance kernel vs ``pairwise_dist_plain``: rtol 1e-6 (the kernel
rounds each product and sum as the plain version's separate kernels do).
The LM serving path, which has no hand-written kernel, is held on the card
to the port on the CPU (reduced configs) and to the reference's full-width
fixture (``tests/lm_fixture.py``); LM training to the reference's
full-width train fixture (``tests/lm_train_fixture.py``), and flash's
memory-exact backward to autograd through the plain forward.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters
from repro_torch.kernels import fused_sinr as fk
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_dist as pdk
from repro_torch.mac.engine import Draws
from repro_torch.sim import pathloss, phy, radio

pytestmark = pytest.mark.gpu

MODELS = {
    "RMa": dict(fc_GHz=0.7),
    "RMa_constant_height": dict(fc_GHz=0.7),
    "RMa_discretised": dict(fc_GHz=0.7),
    "UMa": dict(),
    "UMi": dict(),
    "InH": dict(),
    "power_law": dict(alpha=3.5),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def make_inputs(n, m, k, fading, seed=0, n_sectors=1, extent=2000.0,
                h_bs=25.0, device="cpu"):
    """Deterministic numpy inputs of the kernel, as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    U = np.column_stack([rng.uniform(0, extent, (n, 2)),
                         rng.uniform(1.0, 2.5, (n, 1))]).astype(np.float32)
    n_sites = max(1, -(-m // n_sectors))         # ceil: M need not divide
    sites = np.column_stack([rng.uniform(0, extent, (n_sites, 2)),
                             np.full((n_sites, 1), h_bs)])
    C = np.repeat(sites, n_sectors, axis=0)[:m].astype(np.float32)
    P = rng.uniform(1.0, 10.0, (m, k)).astype(np.float32)
    bore = ((np.arange(m) % n_sectors) * (2 * np.pi / n_sectors)).astype(
        np.float32)
    fad = None
    if fading == "wide":
        fad = rng.exponential(1.0, (n, m)).astype(np.float32)
    elif fading == "rb":
        fad = rng.exponential(1.0, (n, m, k)).astype(np.float32)
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)
    return t(U), t(C), t(P), t(bore), t(fad)


def near_ties(U, C, P, bore, fad, model, n_sectors, attach_on_mean):
    """Mask of the rows whose two best measurements differ < 1e-5 rel."""
    g = radio.pathgains(radio.RadioConfig(model, radio.Antenna_gain(),
                                          n_sectors, 0.0, 1, 1, 1, 1, False,
                                          True, False, 1.0),
                        U, C, bore)
    if fad is not None and not attach_on_mean:
        g = radio.apply_fading(g, fad)
    meas = radio.rsrp(g, P).sum(dim=2)
    if meas.shape[1] < 2:
        return np.zeros(meas.shape[0], bool)
    top2 = torch.topk(meas, 2, dim=1).values
    return ((top2[:, 0] - top2[:, 1]) < 1e-5 * top2[:, 0]).cpu().numpy()


def check_against_plain(args, model, n_sectors, attach_on_mean, idx=None,
                        group=None):
    U, C, P, bore, fad = args
    kw = dict(pathgain_fn=model, n_sectors=n_sectors,
              attach_on_mean=attach_on_mean, idx=idx)
    before = fk.fused_sinr_accumulate.launches
    if group is None:
        got = fk.fused_sinr_accumulate(U, C, P, bore, fad, **kw)
    else:
        got = fk._launch(U, C, P, bore, fad, group=group, **kw)
    torch.cuda.synchronize()
    assert fk.fused_sinr_accumulate.launches == before + 1
    want = fk.fused_sinr_accumulate_plain(U, C, P, bore, fad, **kw)
    total, bval, bidx, wbest = (x.cpu().numpy() for x in got)
    t_p, v_p, i_p, w_p = (x.cpu().numpy() for x in want)
    np.testing.assert_allclose(total, t_p, rtol=1e-4)
    np.testing.assert_allclose(bval, v_p, rtol=1e-4)
    if idx is not None:
        rows = idx.long()
        U, fad = U[rows], None if fad is None else fad[rows]
    ties = near_ties(U, C, P, bore, fad, model, n_sectors, attach_on_mean)
    assert ties.mean() <= 0.01
    np.testing.assert_array_equal(bidx[~ties], i_p[~ties])
    np.testing.assert_allclose(wbest[~ties], w_p[~ties], rtol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("fading,attach_on_mean",
                         [(None, False), ("wide", False), ("wide", True),
                          ("rb", False), ("rb", True)])
@pytest.mark.parametrize("n_sectors", [1, 3])
def test_kernel_matches_plain(cuda, name, fading, attach_on_mean, n_sectors):
    """Every pathloss model x fading mode x sectoring, at a ragged shape
    (N=1000, M=57: neither a multiple of the block nor of the cell tile)."""
    model = pathloss.make_pathloss(name, **MODELS[name])
    h_bs = 35.0 if name.startswith("RMa") else 25.0
    args = make_inputs(1000, 57, 4 if fading == "rb" else 2, fading,
                       seed=sorted(MODELS).index(name), n_sectors=n_sectors,
                       h_bs=h_bs, device=cuda)
    check_against_plain(args, model, n_sectors, attach_on_mean)


def test_kernel_tie_takes_lowest_cell(cuda):
    """Two co-located equal-power cells: the lower index serves."""
    U = torch.tensor([[100.0, 0.0, 1.5], [0.0, 300.0, 1.5]], device=cuda)
    C = torch.tensor([[0.0, 0.0, 25.0], [500.0, 0.0, 25.0],
                      [0.0, 0.0, 25.0]], device=cuda)
    P = torch.full((3, 1), 5.0, device=cuda)
    bore = torch.zeros(3, device=cuda)
    out = fk.fused_sinr_accumulate(U, C, P, bore, None,
                                   pathgain_fn=pathloss.UMa_pathloss())
    assert out[2][:, 0].tolist() == [0, 0]


@pytest.mark.parametrize("group", fk.GROUP_SIZES)
@pytest.mark.parametrize("fading", [None, "wide"])
def test_kernel_exact_ties_across_lanes_take_lowest_cell(cuda, group, fading):
    """Every cell twice: at j and j + 1 (neighbouring lanes of one group)
    and again at j + 40 (another pass of a lane, or another lane).  The
    measurements tie exactly, so the lowest of the copies must serve; with
    wideband fading the tie is on the unfaded mean (attach_on_mean) while
    the serving row carries that cell's own fading."""
    U, C, P, bore, fad = make_inputs(500, 20, 1, fading, seed=4, device=cuda)
    C2 = torch.repeat_interleave(C, 2, dim=0)
    C = torch.cat([C2, C2]).contiguous()             # 80 cells
    P2 = torch.repeat_interleave(P, 2, dim=0)
    P = torch.cat([P2, P2]).contiguous()
    bore = torch.zeros(80, device=cuda)
    if fad is not None:
        fad = torch.rand((500, 80), generator=torch.Generator(
            device=cuda).manual_seed(1), device=cuda) + 0.5
    kw = dict(pathgain_fn=pathloss.UMa_pathloss(),
              attach_on_mean=fad is not None)
    got = fk._launch(U, C, P, bore, fad, group=group, **kw)
    want = fk.fused_sinr_accumulate_plain(U, C, P, bore, fad, **kw)
    a = got[2][:, 0]
    assert torch.equal(a, want[2][:, 0])
    assert (a % 2 == 0).all() and (a < 40).all()
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("n", [1, 33, 1000])
@pytest.mark.parametrize("m", [1, 7, 31, 32, 33, 129, 300, 600])
def test_kernel_ragged_rows_and_cells(cuda, n, m):
    """M around a lane group and past one shared tile (256 cells), N below
    a block's rows; sectored with per-RB fading (K = 3)."""
    args = make_inputs(n, m, 3, "rb", seed=n + m, n_sectors=3, device=cuda)
    check_against_plain(args, pathloss.UMi_pathloss(), 3, False)


@pytest.mark.parametrize("name,group",
                         [(name, fk.GROUP) for name in
                          ("RMa", "RMa_constant_height", "UMa", "UMi")]
                         + [(name, group) for name in ("UMa", "UMi")
                            for group in fk.GROUP_SIZES if group != fk.GROUP])
def test_kernel_cells_of_different_heights(cuda, name, group):
    """Cells of one height share their height-only pathloss terms; here the
    first tile of 256 cells has one height and the second mixes heights,
    so both of the kernel's paths run in one launch."""
    U, C, P, bore, fad = make_inputs(600, 400, 2, "rb", seed=12,
                                     h_bs=30.0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    C[256:, 2] = 10.0 + 25.0 * torch.rand(144, generator=g, device=cuda)
    model = pathloss.make_pathloss(name, **MODELS[name])
    check_against_plain((U, C, P, bore, fad), model, 1, False, group=group)


@pytest.mark.parametrize("k", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("fading", [None, "rb"])
def test_kernel_frequency_chunks(cuda, k, fading):
    args = make_inputs(700, 57, k, fading, seed=k, device=cuda)
    check_against_plain(args, pathloss.UMa_pathloss(), 1, False)


@pytest.mark.parametrize("group", fk.GROUP_SIZES)
@pytest.mark.parametrize("m,k,fading", [(5, 1, None), (57, 4, "rb"),
                                         (127, 1, "wide"), (300, 2, None)])
def test_kernel_each_lane_group_matches_plain(cuda, group, m, k, fading):
    args = make_inputs(999, m, k, fading, seed=m, device=cuda)
    check_against_plain(args, pathloss.UMa_pathloss(), 1, False, group=group)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("fading,attach_on_mean",
                         [(None, False), ("wide", True), ("rb", False)])
def test_kernel_reads_rows_by_index(cuda, dtype, fading, attach_on_mean):
    """Dirty rows read by index, repeats included, against the plain
    version's gather."""
    args = make_inputs(5000, 57, 4 if fading == "rb" else 1, fading, seed=9,
                       n_sectors=3, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    idx = torch.randint(0, 5000, (1500,), generator=g, device=cuda)
    idx[700:] = idx[:800].clone()                   # repeats
    check_against_plain(args, pathloss.UMa_pathloss(), 3, attach_on_mean,
                        idx=idx.to(dtype))


def test_kernel_index_out_of_range_reads_nothing(cuda):
    """The range is the caller's contract: an index out of range reads no
    memory and yields NaN and attachment -1 for its row only."""
    U, C, P, bore, _ = make_inputs(10, 7, 2, None, device=cuda)
    idx = torch.tensor([3, 10, -1, 3], dtype=torch.int32, device=cuda)
    total, bval, bidx, wbest = fk.fused_sinr_accumulate(
        U, C, P, bore, idx=idx, pathgain_fn=pathloss.UMa_pathloss())
    assert bidx[:, 0].tolist()[1:3] == [-1, -1]
    assert torch.isnan(total[1:3]).all() and torch.isnan(bval[1:3]).all()
    assert torch.equal(total[0], total[3]) and bidx[0, 0] >= 0


@pytest.mark.parametrize("fading", [False, True])
def test_radio_update_rows_fused_by_index_matches_torch(cuda, fading):
    """radio_update_rows_fused hands the full positions and fading and the
    dirty index to the kernel; it equals the torch row recompute."""
    p = CRRM_parameters(n_ues=3000, n_cells=19, seed=5,
                        pathloss_model_name="UMa", power_W=10.0,
                        rayleigh_fading=fading, n_rb_subbands=4 if fading
                        else 1, radio_mode="incremental")
    sim = CRRM(p, device=cuda)
    rs = sim.radio_static()
    U, fad = sim.U._data, sim.fading._data if fading else None
    cfg = rs.cfg
    U2 = U.clone()
    idx = radio.pad_indices(list(range(0, 3000, 7)))
    idx = torch.as_tensor(idx, device=cuda)
    U2[idx.long()] += 15.0
    out = {}
    for be, upd in (("torch", radio.radio_update_rows),
                    ("fused", radio.radio_update_rows_fused)):
        st = radio.radio_init(cfg, U, rs.C, rs.bore, fad, rs.P)
        before = fk.fused_sinr_accumulate.launches
        out[be] = upd(cfg, st, U2, rs.C, rs.bore, fad, rs.P, idx)
        assert fk.fused_sinr_accumulate.launches - before == (be == "fused")
    # attachment exact off near ties; CQI and SE exact off the CQI steps
    want = radio.radio_forward(rs, U2, fad=fad)
    G0 = radio.pathgains(cfg, U2, rs.C, rs.bore)
    meas = radio.rsrp(G0 if cfg.attach_ignores_fading or fad is None
                      else radio.apply_fading(G0, fad), rs.P).sum(dim=2)
    top2 = torch.topk(meas, 2, dim=1).values
    ties = (top2[:, 0] - top2[:, 1]) < 1e-5 * top2[:, 0]
    thr = phy.table("CQI_SINR_THRESHOLDS_DB", cuda)
    db = phy.sinr_to_db(want.gamma)
    edge = ((db[..., None] - thr).abs() < 1e-4).any(dim=-1) | ties[:, None]
    assert ties.float().mean() <= 0.01
    f, t = out["fused"], out["torch"]
    assert torch.equal(f.a[~ties], t.a[~ties])
    assert torch.equal(f.cqi[~edge], t.cqi[~edge])
    assert torch.equal(f.se[~edge], t.se[~edge])


def test_torch_argmax_ties_lowest_index_on_cuda(cuda):
    """The attachment, max_cqi and A3 rely on the first maximum."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0]],
                     device=cuda)
    assert torch.argmax(x, dim=1).tolist() == [1, 0]
    s = torch.tensor([[[2], [7]], [[7], [7]], [[1], [7]]], device=cuda)
    assert torch.argmax(s, dim=0)[:, 0].tolist() == [1, 0]


def test_kernel_rejects_wrong_inputs(cuda):
    U, C, P, bore, _ = make_inputs(8, 4, 1, None, device=cuda)
    with pytest.raises(TypeError):
        fk.fused_sinr_accumulate(U.double(), C, P, bore,
                                 pathgain_fn=pathloss.UMa_pathloss())
    with pytest.raises(ValueError):
        fk.fused_sinr_accumulate(U, C, P, bore.cpu(),
                                 pathgain_fn=pathloss.UMa_pathloss())
    with pytest.raises(ValueError, match="cannot express"):
        fk.fused_sinr_accumulate(U, C, P, bore,
                                 pathgain_fn=lambda d2, d3, hb, hu: 1 / d3)


def test_forward_fused_matches_torch_on_cuda(cuda):
    sim = CRRM(CRRM_parameters(n_ues=2000, n_cells=21, n_sectors=3,
                               pathloss_model_name="UMi", h_bs_m=10.0,
                               rayleigh_fading=True, n_rb_subbands=4,
                               extent_m=1200.0, power_W=6.3, seed=1),
               device=cuda)
    rs = sim.radio_static()
    U, fad = sim.U._data, sim.fading._data
    o_t = radio.radio_forward(rs, U, fad=fad)
    o_f = radio.radio_forward(rs, U, fad=fad, backend="fused")
    assert torch.equal(o_f.a, o_t.a)
    # gamma = w / (noise + total - w): the rtol 1e-4 of w and total reaches
    # gamma amplified by its condition number 1 + (w + total) / (noise + u)
    w = radio.wanted(o_t.rsrp, o_t.a)
    u = radio.interference(o_t.rsrp, w)
    kappa = 1.0 + (2 * w + u) / (rs.cfg.noise_w + u)
    assert ((o_f.gamma - o_t.gamma).abs()
            <= 1e-4 * kappa * o_t.gamma.abs()).all()


def test_engine_inc_fused_matches_torch_on_cuda(cuda):
    """The incremental engine through the kernel, against the torch row
    recompute, on the same draws."""
    p = CRRM_parameters(n_ues=4000, n_cells=19, seed=3,
                        pathloss_model_name="UMa", power_W=10.0,
                        scheduler_policy="pf", fairness_p=0.5,
                        mobility_step_m=20.0, mobility_move_frac=0.1,
                        radio_mode="incremental")
    out = {}
    for be in ("torch", "fused"):
        sim = CRRM(p, device=cuda)
        fns = sim.episode_fns(inc_backend=be)
        before = fk.fused_sinr_accumulate.launches
        _, t = fns.rollout(sim.episode_static(), sim.init_episode_state(), 5,
                           Draws(0, cuda))
        out[be] = t.cpu().numpy()
        launched = fk.fused_sinr_accumulate.launches - before
        assert launched == (5 if be == "fused" else 0)
    np.testing.assert_allclose(out["fused"], out["torch"], rtol=1e-4,
                               atol=1.0)


@pytest.mark.parametrize("n,m", [(1, 1), (7, 3), (33, 257), (1000, 57),
                                 (130, 2049), (64, 4100)])
def test_pairwise_dist_matches_plain(cuda, n, m):
    """Ragged shapes: row tiles of 64 and cell tiles of 2048 both cut."""
    rng = np.random.default_rng(n + m)
    U = torch.as_tensor(np.column_stack([
        rng.uniform(0, 5000, (n, 2)), rng.uniform(1, 2.5, n)]).astype(
            np.float32), device=cuda)
    C = torch.as_tensor(np.column_stack([
        rng.uniform(0, 5000, (m, 2)), np.full(m, 25.0)]).astype(np.float32),
        device=cuda)
    before = pdk.pairwise_dist.launches
    d2, d3 = ops.pairwise_dist(U, C)
    torch.cuda.synchronize()
    assert pdk.pairwise_dist.launches == before + 1
    p2, p3 = pdk.pairwise_dist_plain(U, C)
    assert d2.shape == (n, m) and d2.is_cuda
    torch.testing.assert_close(d2, p2, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(d3, p3, rtol=1e-6, atol=0.0)


def test_pairwise_dist_rejects_wrong_inputs(cuda):
    U = torch.zeros((4, 3), device=cuda)
    C = torch.ones((2, 3), device=cuda)
    with pytest.raises(TypeError):
        pdk.pairwise_dist(U.double(), C)
    with pytest.raises(ValueError):
        pdk.pairwise_dist(U, C.cpu())
    with pytest.raises(ValueError, match="at least one"):
        pdk.pairwise_dist(U[:0], C)
    with pytest.raises(ValueError, match="contiguous"):
        pdk.pairwise_dist(U, torch.ones((3, 2), device=cuda).t())


@pytest.mark.parametrize("n_born", [0, 9, 16])
@pytest.mark.parametrize("fading", [False, True])
def test_fused_mover_and_newborn_rows_match_torch(cuda, n_born, fading):
    """The churn path's one index -- the padded mover window and the
    padded newborn rows (a TTI with no birth: all padding on row 0; one at
    the cap of 16) -- through the kernel equals the torch row recompute on
    the same state."""
    from repro_torch.mac.engine import scatter_born
    p = CRRM_parameters(n_ues=3000, n_cells=19, seed=6,
                        pathloss_model_name="UMa", power_W=10.0,
                        rayleigh_fading=fading, radio_mode="incremental")
    sim = CRRM(p, device=cuda)
    rs = sim.radio_static()
    cfg, U = rs.cfg, sim.U._data.clone()
    fad = sim.fading._data.clone() if fading else None
    g = torch.Generator(device=cuda).manual_seed(n_born)
    born = torch.zeros(3000, dtype=torch.bool, device=cuda)
    born[torch.randperm(3000, generator=g, device=cuda)[:n_born]] = True
    born_idx = radio.dirty_indices(born, 16)
    n = torch.tensor(n_born, dtype=torch.int32, device=cuda)
    scatter_born(U, born_idx, torch.rand((16, 3), generator=g, device=cuda)
                 * torch.tensor([2000.0, 2000.0, 0.0], device=cuda)
                 + torch.tensor([0.0, 0.0, 1.5], device=cuda), n)
    if fading:
        scatter_born(fad, born_idx, radio.draw_fading(cfg, g, 16, 19), n)
    movers, _ = radio.window_indices(torch.tensor(2990, device=cuda), 300,
                                     3000)
    U[movers.long()] += 10.0
    idx = torch.cat([movers, born_idx])
    out = {}
    for be, upd in (("torch", radio.radio_update_rows),
                    ("fused", radio.radio_update_rows_fused)):
        st = radio.radio_init(cfg, sim.U._data, rs.C, rs.bore,
                              sim.fading._data if fading else None, rs.P)
        before = fk.fused_sinr_accumulate.launches
        out[be] = upd(cfg, st, U, rs.C, rs.bore, fad, rs.P, idx)
        assert fk.fused_sinr_accumulate.launches - before == (be == "fused")
    want = radio.radio_forward(rs, U, fad=fad)
    G0 = radio.pathgains(cfg, U, rs.C, rs.bore)
    meas = radio.rsrp(G0 if fad is None else radio.apply_fading(G0, fad),
                      rs.P).sum(dim=2)
    top2 = torch.topk(meas, 2, dim=1).values
    ties = (top2[:, 0] - top2[:, 1]) < 1e-5 * top2[:, 0]
    db = phy.sinr_to_db(want.gamma)
    thr = phy.table("CQI_SINR_THRESHOLDS_DB", cuda)
    edge = ((db[..., None] - thr).abs() < 1e-4).any(dim=-1) | ties[:, None]
    f, t = out["fused"], out["torch"]
    assert torch.equal(f.a[~ties], t.a[~ties])
    assert torch.equal(f.a[~ties], want.a[~ties])
    assert torch.equal(f.cqi[~edge], t.cqi[~edge])
    assert torch.equal(f.se[~edge], t.se[~edge])


def test_engine_churn_fused_matches_torch_on_cuda(cuda):
    """Churn in the incremental engine: one kernel launch per TTI (movers
    and newborns in one index), the same trajectory as the torch rows."""
    from repro_torch.mac.engine import seed_churn_state
    from repro_torch.sim.mobility import ChurnConfig
    p = CRRM_parameters(n_ues=4000, n_cells=19, seed=3,
                        pathloss_model_name="UMa", power_W=10.0,
                        scheduler_policy="pf", fairness_p=0.5,
                        mobility_step_m=20.0, mobility_move_frac=0.1,
                        radio_mode="incremental")
    churn = ChurnConfig(arrival_rate_hz=1400.0, mean_lifetime_s=2.0,
                        max_arrivals_per_tti=7)
    out = {}
    for be in ("torch", "fused"):
        sim = CRRM(p, device=cuda)
        fns = sim.episode_fns(inc_backend=be, churn=churn, telemetry=True)
        static = sim.episode_static()
        state = seed_churn_state(sim.init_episode_state(), static, p)
        before = fk.fused_sinr_accumulate.launches
        s, t, tel = fns.rollout(static, state, 8, Draws(0, cuda))
        out[be] = (t.cpu().numpy(), s.active.cpu().numpy())
        launched = fk.fused_sinr_accumulate.launches - before
        assert launched == (8 if be == "fused" else 0)
        assert int(tel.active_ues[-1]) == int(s.active.sum())
    np.testing.assert_array_equal(out["fused"][1], out["torch"][1])
    np.testing.assert_allclose(out["fused"][0], out["torch"][0], rtol=1e-4,
                               atol=1.0)


@pytest.mark.parametrize("n_freq", [1, 4])
def test_batched_segment_reductions_match_unbatched_deterministic(cuda,
                                                                   n_freq):
    """In deterministic mode the flat-id reductions over B envs equal the
    B unbatched reductions on the card."""
    from repro_torch.mac import segments
    g = torch.Generator(device=cuda).manual_seed(0)
    B, n, m = 8, 100_000, 21
    seg = torch.randint(0, m, (B, n), generator=g, device=cuda,
                        dtype=torch.int32)
    data = torch.rand((B, n, n_freq), generator=g, device=cuda)
    torch.use_deterministic_algorithms(True)
    try:
        s_b = segments.segment_sum(data, seg, m)
        x_b = segments.segment_max(data, seg, m)
        for b in range(B):
            assert torch.equal(s_b[b], segments.segment_sum(data[b], seg[b],
                                                            m))
            assert torch.equal(x_b[b], segments.segment_max(data[b], seg[b],
                                                            m))
    finally:
        torch.use_deterministic_algorithms(False)


# ------------------------------------------------------------- the twin
def _cuda_twin(cuda, tmp_path, **kw):
    from repro_torch.sim.mobility import ChurnConfig
    from repro_torch.twin.server import TwinServer
    p = CRRM_parameters(n_ues=4000, n_cells=19, seed=3,
                        pathloss_model_name="UMa", power_W=10.0,
                        scheduler_policy="pf", fairness_p=0.5,
                        mobility_step_m=20.0, mobility_move_frac=0.1,
                        radio_mode="incremental")
    churn = ChurnConfig(arrival_rate_hz=1400.0, mean_lifetime_s=2.0,
                        max_arrivals_per_tti=7)
    return TwinServer(CRRM(p, device=cuda), churn, chunk_tti=10,
                      ckpt_dir=str(tmp_path), inc_backend="fused", **kw)


def test_twin_fused_launches_once_per_tti(cuda, tmp_path):
    """A churn twin under ``"fused"`` launches the kernel once per served
    TTI, movers and newborns in one index."""
    srv = _cuda_twin(cuda, tmp_path)
    assert srv.fns.inc_backend == "fused"
    before = fk.fused_sinr_accumulate.launches
    for _ in range(3):
        k = srv.step_chunk()
    assert fk.fused_sinr_accumulate.launches - before == 30
    assert k["t"] == 30.0 and 0 < k["active_ues"] <= 4000
    assert torch.isfinite(srv.last_tput).all()


def test_twin_restore_resumes_bitwise_deterministic(cuda, tmp_path):
    """In deterministic mode a restored card twin resumes bit for bit: the
    KPIs, throughput and every state leaf of two more chunks."""
    torch.use_deterministic_algorithms(True)
    try:
        srv = _cuda_twin(cuda, tmp_path)
        srv.step_chunk()
        srv.set_power(srv.power * 0.8)
        srv.checkpoint()
        k_ref = [srv.step_chunk() for _ in range(2)]
        tput, final = srv.last_tput, srv.state
        srv2 = _cuda_twin(cuda, tmp_path)
        assert srv2.restore() == 10
        assert srv2.state.U.device.type == "cuda"
        k_res = [srv2.step_chunk() for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    assert k_res == k_ref
    assert torch.equal(srv2.last_tput, tput)
    for name, a, b in zip(final._fields, final, srv2.state):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


def test_twin_raised_chunk_recovers_on_fused(cuda, tmp_path):
    """A chunk that raises under ``"fused"`` rolls back and retries on
    ``"fused"``: the kernel keeps launching, no line degrades."""
    from repro_torch.robust.watchdog import WatchdogConfig
    srv = _cuda_twin(cuda, tmp_path, watchdog=WatchdogConfig(
        max_retries=2, backoff_s=0.0))
    fns = srv.fns
    srv.step_chunk()
    real, boom = srv._chunk, {"armed": True}

    def explode_once(*a):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected kernel failure")
        return real(*a)

    srv._chunk = explode_once
    before = fk.fused_sinr_accumulate.launches
    srv.step_chunk()
    assert fk.fused_sinr_accumulate.launches - before == 10
    assert srv.t == 20 and srv.inc_backend == "fused" and srv.fns is fns
    assert not any("degrad" in line for line in srv.fault_history)


# ------------------------------------------------ the differentiable engine
@pytest.mark.parametrize("scenario", ["dense_urban", "handover_stress"])
def test_relaxed_grad_matches_finite_differences_deterministic(cuda,
                                                               scenario):
    """``tests/test_rl.py``'s check on the card, on the reference's own
    inputs (``tests/relax_fixture.py``): autograd through the relaxed
    8-TTI rollout against central differences, best over the four eps,
    <= 1e-3, in deterministic mode (index_add_ in a fixed order)."""
    import relax_fixture
    torch.use_deterministic_algorithms(True)
    try:
        gv, best, errs = relax_fixture.fd_check(scenario, cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    assert best <= 1e-3, f"{scenario}: grad/FD mismatch {errs} (g.v={gv})"


def test_relaxed_grad_at_the_preset_width_deterministic(cuda):
    """``tests/test_torch_relax_width.py``'s contract on the card: the
    power objective's gradient at 200 UEs over the 2 TTIs both programs
    share equals the reference's ``jax.grad`` (value rtol 1e-5, g.v rtol
    1e-4, every element within 1e-4 * max|g|) and central differences
    (<= 1e-3), in deterministic mode."""
    import relax_fixture
    torch.use_deterministic_algorithms(True)
    try:
        out = relax_fixture.diffopt_check(cuda, "held")
    finally:
        torch.use_deterministic_algorithms(False)
    port, ref = out["port"], out["ref"]
    np.testing.assert_allclose(port["value"], ref["value"], rtol=1e-5)
    np.testing.assert_allclose(port["gv"], ref["gv"], rtol=1e-4)
    g, g_j = port["grad"], ref["grad"]
    assert np.abs(g - g_j).max() <= 1e-4 * np.abs(g_j).max()
    assert min(port["fd_errs"]) <= 1e-3, port["fd_errs"]


def test_fused_kernel_raises_on_an_input_that_requires_grad(cuda):
    U, C, P, bore, fad = make_inputs(64, 7, 2, "rb", device=cuda)
    before = fk.fused_sinr_accumulate.launches
    with pytest.raises(ValueError, match="no backward"):
        fk.fused_sinr_accumulate(U, C, P.requires_grad_(True), bore, fad,
                                 pathgain_fn=pathloss.UMa_pathloss())
    assert fk.fused_sinr_accumulate.launches == before


def test_ppo_resume_is_bitwise_on_the_card_deterministic(cuda, tmp_path):
    """2 iterations + checkpoint + restore + 2 equal 4 uninterrupted
    iterations bit for bit on the card, in deterministic mode."""
    from repro_torch import rl
    from repro_torch.env import CrrmEnv
    from repro_torch.tree import flatten
    env = CrrmEnv(scenario="dense_urban",
                  scenario_overrides=dict(n_ues=12), episode_tti=8,
                  tti_per_step=4, telemetry=True, device=cuda)
    pcfg = rl.PolicyConfig(n_cells=env.n_cells, n_subbands=env.n_subbands,
                           power_W=env.max_cell_power_W)
    cfg = rl.PPOConfig(n_envs=2, n_steps=4)
    torch.use_deterministic_algorithms(True)
    try:
        ts_a, hist_a = rl.train(env, pcfg, cfg, iterations=4, seed=0)
        d = str(tmp_path / "ckpt")
        rl.train(env, pcfg, cfg, iterations=2, seed=0, ckpt_dir=d,
                 ckpt_every=1)
        ts_b, hist_b = rl.train(env, pcfg, cfg, iterations=4, seed=0,
                                ckpt_dir=d, ckpt_every=1)
    finally:
        torch.use_deterministic_algorithms(False)
    assert hist_b == hist_a[2:]
    for (k, a), b in zip(zip(*flatten(ts_a)), flatten(ts_b)[1]):
        assert a.device.type == "cuda" and torch.equal(a, b), k


# ------------------------------------------------------------- the mesh
MESH_EPISODE = dict(n_ues=20_000, n_cells=19, n_sectors=1, seed=3,
                    pathloss_model_name="UMa", power_W=10.0,
                    scheduler_policy="pf", fairness_p=0.5,
                    mobility_step_m=20.0, mobility_move_frac=0.1,
                    radio_mode="incremental")


def test_one_rank_nccl_mesh_matches_plain_rollout_deterministic(cuda,
                                                               tmp_path):
    """The NCCL path as a 1-rank group: the trivial ("ue",) mesh on the
    card reproduces the plain rollout bit for bit (deterministic mode),
    with one fused_sinr launch per TTI."""
    from repro_torch.core.distributed import make_mesh
    from torch_mesh import one_rank_group
    sim = CRRM(CRRM_parameters(**MESH_EPISODE))
    static, state = sim.episode_static(), sim.init_episode_state()
    with one_rank_group(tmp_path, "nccl"):
        mesh = make_mesh((1,), ("ue",))
        outs = []
        torch.use_deterministic_algorithms(True)
        try:
            for m in (None, mesh):
                fns = sim.episode_fns(mesh=m, inc_backend="fused")
                before = fk.fused_sinr_accumulate.launches
                out = fns.rollout(static, state, 5, Draws(3, "cuda"))
                outs.append((out, fk.fused_sinr_accumulate.launches - before))
        finally:
            torch.use_deterministic_algorithms(False)
    (plain, n_plain), (sharded, n_mesh) = outs
    assert n_plain == n_mesh == 5
    assert torch.equal(plain[1], sharded[1])
    for x, y in zip(plain[0], sharded[0]):
        assert (x is None and y is None) or torch.equal(x, y)


def test_two_rank_gloo_mesh_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card with CUDA tensors: the incremental
    episode on a UE mesh of 2 launches fused_sinr once per rank and TTI,
    keeps positions and serving cells exact and the throughput within
    1e-5 (max |d| / max(max |tput|, 1)) of one device."""
    from torch_mesh import run_ranks
    outs = run_ranks(dict(name="card", params=MESH_EPISODE, n_tti=5,
                          fns_kw=dict(inc_backend="fused")), 2, tmp_path)
    for (s1, t1, n1), (s2, t2, n2) in outs:
        assert n1 == n2 == 5
        err = np.abs(t2 - t1).max() / max(np.abs(t1).max(), 1.0)
        assert err <= 1e-5, err
        np.testing.assert_array_equal(s2.U, s1.U)
        np.testing.assert_array_equal(s2.serving, s1.serving)


REPORT_EPISODE = dict(n_ues=4000, n_cells=19, seed=3,
                      pathloss_model_name="UMa", power_W=10.0,
                      scheduler_policy="pf", fairness_p=0.5,
                      mobility_step_m=20.0, mobility_move_frac=0.1,
                      radio_mode="incremental")


def test_trace_on_the_card_holds_the_fused_kernel(cuda, tmp_path):
    """``obs.profile.trace`` of a 3-TTI fused rollout: the Chrome trace
    holds the annotated span and one fused_sinr kernel event per TTI, and
    ``kernel_times`` reads them back."""
    import json
    from repro_torch.obs import annotate, profile, trace
    sim = CRRM(CRRM_parameters(**REPORT_EPISODE), device=cuda)
    fns = sim.episode_fns(inc_backend="fused")
    static, state = sim.episode_static(), sim.init_episode_state()
    with trace(str(tmp_path)) as prof:
        with annotate("rollout"):
            fns.rollout(static, state, 3, Draws(0, cuda))
    events = json.loads((tmp_path / profile.TRACE_FILE).read_text())[
        "traceEvents"]
    assert "rollout" in {e.get("name") for e in events}
    fused = [e for e in events if str(e.get("cat", "")).lower() == "kernel"
             and "fused_sinr" in e["name"]]
    assert len(fused) == 3
    times = profile.kernel_times(prof)
    assert sum(c for k, (_, c) in times.items() if "fused_sinr" in k) == 3


def test_episode_report_on_the_card_launches_once_per_tti(cuda):
    from repro_torch.obs import report
    sim = CRRM(CRRM_parameters(**REPORT_EPISODE), device=cuda)
    art = report.episode_report(sim, 4, inc_backend="fused")
    assert art["kernel_launches"] == {"fused_sinr": 4, "pairwise_dist": 0}
    assert art["backend"] == "cuda" and art["inc_backend"] == "fused"
    assert art["device_ms_per_tti"] > 0 and art["launches_per_tti"] >= 1
    assert art["collective_wire_bytes"] == 0.0
    assert art["analytic_breakdown"]["rows_per_tti"] == 400


# -- the LM serving path --------------------------------------------------------
LM_ARCHS = ["qwen1.5-0.5b", "codeqwen1.5-7b", "yi-6b", "deepseek-67b",
            "granite-moe-1b-a400m", "deepseek-moe-16b", "falcon-mamba-7b",
            "zamba2-1.2b", "qwen2-vl-72b"]


def _lm_run(arch, params, bt, device, n_prompt=6):
    """forward, prefill of ``n_prompt`` positions and the teacher-forced
    decode steps after it, as CPU float32 tensors."""
    cut = lambda a, b: {k: (v[:, :, a:b] if k == "positions" else v[:, a:b])
                        .to(device) for k, v in bt.items()}
    total = bt["positions"].shape[2] if "positions" in bt else \
        bt["tokens"].shape[1]
    out = [arch.forward(params, cut(0, total))]
    last, caches = arch.prefill(params, cut(0, n_prompt), total)
    out.append(last)
    for pos in range(n_prompt, total):
        logits, caches = arch.decode_step(params, cut(pos, pos + 1), caches,
                                          pos)
        out.append(logits)
    return [x.float().cpu() for x in out]


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_reduced_on_the_card_matches_the_cpu(cuda, arch_id):
    """The port on the card against the port on the CPU, same params and
    inputs (reduced config, float32, no TF32): forward, prefill and 3
    decode steps within rtol/atol 1e-4 (sum order of cuBLAS vs the CPU's
    matmuls)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import make_arch
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch_id, reduced=True)
    arch = make_arch(cfg)
    params = arch.init(torch.Generator("cpu").manual_seed(0))
    on_card = _tree_to(params, cuda)
    rng = np.random.default_rng(1)
    if cfg.family == "vlm":
        t = np.arange(9)
        bt = {"embeds": torch.as_tensor(rng.standard_normal(
            (2, 9, cfg.d_model)).astype(np.float32)),
            "positions": torch.as_tensor(np.stack([t, t // 2, t % 3])[:, None]
                                         .repeat(2, axis=1).astype(np.int32))}
    else:
        bt = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, 9)).astype(np.int32))}
    want = _lm_run(arch, params, bt, "cpu")
    got = _lm_run(arch, on_card, bt, cuda)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.fixture(scope="module")
def qwen_full_tree():
    """qwen1.5-0.5b's full-width seeded weights (numpy, ~2.5 GB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import lm_fixture
    return lm_fixture.param_tree(lm_fixture.config("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_full_width_serving_holds_the_reference_fixture(cuda, dtype,
                                                           qwen_full_tree):
    """``ServeEngine`` on qwen1.5-0.5b at full width, held to the
    reference's run (``tests/lm_fixture.py``'s contract: logits within
    1e-3 / 0.25 while the inputs agree, tokens exact off near ties)."""
    import lm_fixture
    res = lm_fixture.check(cuda, dtype, qwen_full_tree)
    assert res["held_steps"] >= len(lm_fixture.PROMPT_LENS) * 2


def test_serve_engine_defaults_to_the_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import make_arch
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(make_arch(get_config("qwen1.5-0.5b", reduced=True)),
                      batch_slots=2, max_len=32)
    assert eng.device.type == "cuda"
    assert eng.params["lm_head"]["kernel"].is_cuda
    eng.submit(np.arange(5), max_new_tokens=4)
    assert len(eng.run()["results"][0]) == 4


# -- LM training ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_full_width_training_holds_the_reference_fixture(cuda, dtype,
                                                            qwen_full_tree):
    """Three AdamW steps of qwen1.5-0.5b at full width, held to the
    reference's run (``tests/lm_train_fixture.py``'s contract: float32
    losses rtol 1e-5, gradient probes within 1e-4 of their leaf's max|g|,
    params within 1e-6 off counted sign flips; bfloat16 losses within
    2e-2)."""
    import lm_train_fixture
    res = lm_train_fixture.check(cuda, dtype, qwen_full_tree)
    assert len(res["loss"]) == lm_train_fixture.STEPS


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_on_the_card_matches_autograd(cuda, causal):
    """The memory-exact backward against autograd through the plain
    forward, on the card, at several blocks with GQA and padding (float32
    within 1e-5 of the largest gradient element)."""
    from repro_torch.models import flash
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(2, 300, 8, 64, device=cuda, generator=gen)
    k = torch.randn(2, 300, 4, 64, device=cuda, generator=gen)
    v = torch.randn(2, 300, 4, 64, device=cuda, generator=gen)
    do = torch.randn(2, 300, 8, 64, device=cuda, generator=gen)
    grads = []
    for fn in (flash.flash_attention, flash.flash_attention_naive_grad):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs, causal=causal, chunk_q=64, chunk_kv=128)
        grads.append(torch.autograd.grad((out * do).sum(), xs))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_train_step_defaults_to_the_card(cuda):
    from repro_torch.launch import train as launch_train
    hist = launch_train.main(["--reduced", "--steps", "3", "--batch", "2",
                              "--seq-len", "16"])
    assert len(hist) == 1 and np.isfinite(hist[0])

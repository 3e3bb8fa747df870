"""The port's physics leaves against the JAX package, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``.  Tolerances:
distances rtol 1e-6 (the same float32 ops); gains rtol 1e-5 (ulp
differences of log10/pow between XLA and PyTorch); integer outputs exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import params as j_params
from repro.sim import antenna as j_antenna
from repro.sim import deploy as j_deploy
from repro.sim import fading as j_fading
from repro.sim import pathloss as j_pathloss
from repro.sim import phy as j_phy
from repro.sim import radio as j_radio
from repro_torch.core import params as t_params
from repro_torch.sim import antenna as t_antenna
from repro_torch.sim import deploy as t_deploy
from repro_torch.sim import fading as t_fading
from repro_torch.sim import pathloss as t_pathloss
from repro_torch.sim import phy as t_phy
from repro_torch.sim import radio as t_radio

RTOL_DIST = 1e-6   # identical float32 op sequence
RTOL_GAIN = 1e-5   # log10/pow ulps between XLA and PyTorch


def test_params_fields_and_defaults_match_reference():
    ref = {f.name: f for f in dataclasses.fields(j_params.CRRM_parameters)}
    port = {f.name: f for f in dataclasses.fields(t_params.CRRM_parameters)}
    assert list(ref) == list(port)
    for name, f in ref.items():
        g = port[name]
        if f.default_factory is not dataclasses.MISSING:
            assert f.default_factory() == g.default_factory(), name
        else:
            assert f.default == g.default, name
    a, b = j_params.CRRM_parameters(), t_params.CRRM_parameters()
    for prop in ("subband_bandwidth_Hz", "subband_noise_W", "n_freq",
                 "rb_per_chunk", "chunk_bandwidth_Hz", "chunk_noise_W"):
        assert getattr(a, prop) == getattr(b, prop), prop


def test_params_validation_matches_reference():
    for bad in (dict(n_subbands=0), dict(fairness_p=2.0), dict(n_rb=0),
                dict(traffic_model="x"), dict(n_rb_subbands=5),
                dict(radio_mode="x"), dict(ho_ttt_tti=0)):
        with pytest.raises(ValueError):
            j_params.CRRM_parameters(**bad)
        with pytest.raises(ValueError):
            t_params.CRRM_parameters(**bad)


def test_params_faults_wait_for_their_slice():
    """A FaultConfig is a valid field, and since the faults slice ``CRRM``
    takes it (it raised before): the engine runs the process by
    default."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.sim.faults import FaultConfig
    with pytest.raises(ValueError, match="FaultConfig"):
        t_params.CRRM_parameters(faults=object())
    p = t_params.CRRM_parameters(n_ues=4, faults=FaultConfig(5.0))
    sim = CRRM(p, device="cpu")
    assert sim.params.faults == FaultConfig(5.0)


def _grid():
    """A distance x height grid: d2d 1 m .. 8 km, UE heights 1 .. 2.5 m."""
    d2d = np.geomspace(1.0, 8000.0, 97).astype(np.float32)[:, None]
    h_ut = np.linspace(1.0, 2.5, 13).astype(np.float32)
    d2d = np.broadcast_to(d2d, (97, 13)).astype(np.float32)
    h_ut = np.broadcast_to(h_ut[None, :], (97, 13)).astype(np.float32)
    return d2d, h_ut


@pytest.mark.parametrize("los", [False, True])
@pytest.mark.parametrize("name,kw,h_bs", [
    ("RMa", dict(fc_GHz=0.7), 35.0),
    ("RMa_constant_height", dict(fc_GHz=0.7), 35.0),
    ("RMa_discretised", dict(fc_GHz=0.7), 35.0),
    ("UMa", dict(), 25.0), ("UMi", dict(), 10.0), ("InH", dict(), 3.0),
    ("power_law", dict(alpha=3.5), 25.0)])
def test_pathloss_models_match_reference(name, kw, h_bs, los):
    d2d, h_ut = _grid()
    d3d = np.sqrt(d2d * d2d + (h_bs - h_ut) ** 2).astype(np.float32)
    hb = np.full_like(d2d, h_bs)
    kw = dict(kw) if name == "power_law" else dict(kw, LOS=los)
    jm = j_pathloss.make_pathloss(name, **kw)
    tm = t_pathloss.make_pathloss(name, **kw)
    want = np.asarray(jm(jnp.asarray(d2d), jnp.asarray(d3d), jnp.asarray(hb),
                         jnp.asarray(h_ut)))
    got = tm(torch.as_tensor(d2d), torch.as_tensor(d3d), torch.as_tensor(hb),
             torch.as_tensor(h_ut))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_GAIN)
    if name != "power_law":
        np.testing.assert_allclose(
            tm.get_pathloss_dB(*(torch.as_tensor(x) for x in
                                 (d2d, d3d, hb, h_ut))).numpy(),
            np.asarray(jm.get_pathloss_dB(d2d, d3d, hb, h_ut)), rtol=1e-6,
            atol=1e-4)


def test_unknown_pathloss_model_raises():
    with pytest.raises(ValueError, match="unknown pathloss"):
        t_pathloss.make_pathloss("nope")


def test_antenna_pattern_and_boresights_match_reference():
    rng = np.random.default_rng(0)
    az = rng.uniform(-np.pi, np.pi, (40, 9)).astype(np.float32)
    ja = j_antenna.Antenna_gain()
    ta = t_antenna.Antenna_gain()
    jb = j_antenna.sector_boresights(3, 3)
    tb = t_antenna.sector_boresights(3, 3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-7)
    np.testing.assert_allclose(
        ta.gain_linear(torch.as_tensor(az), tb).numpy(),
        np.asarray(ja.gain_linear(jnp.asarray(az), jb)), rtol=RTOL_GAIN)
    np.testing.assert_allclose(
        t_antenna.wrap_angle(torch.as_tensor(az * 3)).numpy(),
        np.asarray(j_antenna.wrap_angle(jnp.asarray(az * 3))), rtol=1e-6,
        atol=1e-6)


def test_phy_tables_and_staircase_match_reference():
    db = np.linspace(-10, 25, 3501).astype(np.float32)
    lin = (10 ** (db / 10)).astype(np.float32)
    jc = np.asarray(j_phy.sinr_db_to_cqi(jnp.asarray(db)))
    tc = t_phy.sinr_db_to_cqi(torch.as_tensor(db))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), jc)
    cq = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(
        t_phy.cqi_to_mcs(torch.as_tensor(cq)).numpy(),
        np.asarray(j_phy.cqi_to_mcs(jnp.asarray(cq))))
    mcs = np.arange(-2, 31, dtype=np.int32)
    np.testing.assert_array_equal(
        t_phy.mcs_to_efficiency(torch.as_tensor(mcs)).numpy(),
        np.asarray(j_phy.mcs_to_efficiency(jnp.asarray(mcs))))
    np.testing.assert_allclose(
        t_phy.sinr_to_db(torch.as_tensor(lin)).numpy(),
        np.asarray(j_phy.sinr_to_db(jnp.asarray(lin))), rtol=1e-6, atol=1e-5)
    # CQI/SE of the linear chain: exact away from the staircase steps
    ref_db = np.asarray(j_phy.sinr_to_db(jnp.asarray(lin)))
    thr = np.asarray(j_phy.CQI_SINR_THRESHOLDS_DB)
    away = np.abs(ref_db[:, None] - thr[None, :]).min(axis=1) > 1e-4
    np.testing.assert_array_equal(
        t_phy.spectral_efficiency(torch.as_tensor(lin)).numpy()[away],
        np.asarray(j_phy.spectral_efficiency(jnp.asarray(lin)))[away])
    np.testing.assert_allclose(
        t_phy.shannon_capacity(torch.as_tensor(lin), 1e6, 2, 4).numpy(),
        np.asarray(j_phy.shannon_capacity(jnp.asarray(lin), 1e6, 2, 4)),
        rtol=1e-6)


@pytest.mark.parametrize("rings", [0, 1, 2])
def test_deploy_matches_reference(rings):
    js = j_deploy.hex_sites(rings, 500.0, z=25.0)
    ts = t_deploy.hex_sites(rings, 500.0, z=25.0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_array_equal(
        t_deploy.replicate_sectors(ts, 3).numpy(),
        np.asarray(j_deploy.replicate_sectors(js, 3)))
    g = torch.Generator().manual_seed(0)
    pts = t_deploy.ppp_points(g, 500, 1000.0, z=1.5)
    assert pts.shape == (500, 3) and pts.dtype == torch.float32
    assert (pts[:, :2] >= 0).all() and (pts[:, :2] < 1000.0).all()
    assert (pts[:, 2] == 1.5).all()


def test_fading_pooling_matches_reference_and_draws_are_exp1():
    rng = np.random.default_rng(1)
    fad_rb = rng.exponential(1.0, (5, 7, 12)).astype(np.float32)
    for s in (1, 2, 3, 4, 6, 12):
        np.testing.assert_allclose(
            t_fading.pool_rb_subbands(torch.as_tensor(fad_rb), s).numpy(),
            np.asarray(j_fading.pool_rb_subbands(jnp.asarray(fad_rb), s)),
            rtol=1e-6)
    with pytest.raises(ValueError):
        t_fading.pool_rb_subbands(torch.as_tensor(fad_rb), 5)
    g = torch.Generator().manual_seed(3)
    blk = t_fading.block_rayleigh_power(g, 200, 6, 12, 4)
    assert blk.shape == (200, 6, 12)
    # RBs inside one coherence block share their draw
    assert torch.equal(blk[..., 0], blk[..., 3])
    assert not torch.equal(blk[..., 3], blk[..., 4])
    w = t_fading.rayleigh_power(g, (100_000,))
    assert abs(float(w.mean()) - 1.0) < 0.02 and (w >= 0).all()
    sub = t_fading.subband_rayleigh_power(g, 3, 4, 12, 3, 4)
    assert sub.shape == (3, 4, 4)


def test_dirtiness_indices_match_reference():
    rows = {5, 2, 9}
    np.testing.assert_array_equal(t_radio.pad_indices(rows),
                                  np.asarray(j_radio.pad_indices(rows)))
    mask = np.zeros(20, bool)
    mask[[1, 4, 17]] = True
    for budget in (2, 3, 8, 25):
        np.testing.assert_array_equal(
            t_radio.dirty_indices(torch.as_tensor(mask), budget).numpy(),
            np.asarray(j_radio.dirty_indices(jnp.asarray(mask), budget)))
    for start, n_move, n, off, n_loc in ((17, 6, 20, 0, None),
                                         (3, 4, 20, 0, None),
                                         (18, 5, 20, 10, 10),
                                         (0, 25, 20, 0, None)):
        ji, jc = j_radio.window_indices(jnp.int32(start), n_move, n,
                                        offset=off, n_loc=n_loc)
        ti, tc = t_radio.window_indices(torch.tensor(start), n_move, n,
                                        offset=off, n_loc=n_loc)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert int(tc) == int(jc)


def test_distances_match_reference():
    rng = np.random.default_rng(2)
    U = np.column_stack([rng.uniform(0, 3000, (50, 2)),
                         np.full((50, 1), 1.5)]).astype(np.float32)
    C = np.column_stack([rng.uniform(0, 3000, (9, 2)),
                         np.full((9, 1), 25.0)]).astype(np.float32)
    jd = j_radio.compute_distances(jnp.asarray(U), jnp.asarray(C))
    td = t_radio.compute_distances(torch.as_tensor(U), torch.as_tensor(C))
    for j, t in zip(jd[:2], td[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL_DIST)
    np.testing.assert_allclose(td[2].numpy(), np.asarray(jd[2]), rtol=1e-6,
                               atol=1e-6)


def test_torch_argmax_takes_the_first_maximum_on_cpu():
    x = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]])
    assert torch.argmax(x, dim=1).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(x.numpy()), axis=1)).tolist() \
        == [1, 0]
    s = torch.tensor([[[2], [7]], [[7], [7]], [[1], [7]]])
    assert torch.argmax(s, dim=0)[:, 0].tolist() == [1, 0]

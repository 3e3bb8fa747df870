"""The port's radio chain against the JAX package, on the CPU.

``radio_forward`` with backend ``None`` (the materialised chain) and
``"fused"`` (the kernel's route; its plain version on CPU tensors) against
the reference's ``"xla"`` and ``"pallas"`` (interpret mode) branches, on
every registry scenario at ``n_rb_subbands`` 1 and 4; and the dirty-row
updates against the reference's.  Tolerances: gains and RSRP rtol 1e-5
(log10/pow ulps); gamma rtol 1e-4 times its condition number
(``torch_parity.assert_sinr``); attachment exact with no near ties at
these seeds; CQI/MCS/SE exact away from the CQI steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import radio as j_radio
from repro.sim import scenarios
from repro_torch.core.crrm import CRRM as TCRRM
from repro_torch.sim import radio as t_radio
from torch_parity import (assert_attachment, assert_cqi, assert_sinr,
                          fields_of, np_, pair)

RTOL_GAIN = 1e-5


def shrink(name, **kw):
    base = dict(n_ues=24, n_cells=6)
    base.update(kw)
    return scenarios.make_scenario(name, **base)


def reference_meas(ref, U):
    """The reference's attachment measurement for positions ``U``."""
    rs = ref.radio_static()
    cfg = rs.cfg
    G0 = j_radio.pathgains(cfg, U, rs.C, rs.bore)
    G = j_radio.apply_fading(G0, ref.fading._data)
    use = G0 if (cfg.rayleigh_fading and cfg.attach_ignores_fading) else G
    return np_(j_radio.rsrp(use, rs.P).sum(axis=2))


def report_gamma(cfg, gamma):
    """The SINR the CQI is quantised from (EESM-pooled when wideband)."""
    if cfg.cqi_wideband and cfg.n_rb_subbands > 1:
        return j_radio.pool_report(gamma, cfg.n_rb_subbands, cfg.eesm_beta)
    return gamma


def check_outputs(got, want, ref, U, R_ref):
    cfg = ref.radio_config()
    assert_attachment(got.a, want.a, reference_meas(ref, U))
    w = j_radio.wanted(R_ref, want.a)
    u = j_radio.interference(R_ref, w)
    assert_sinr(got.gamma, want.gamma, w, u, cfg.noise_w)
    g_rep = report_gamma(cfg, want.gamma)
    for field in ("cqi", "mcs", "se"):
        assert_cqi(getattr(got, field), getattr(want, field), g_rep)
    assert np_(got.cqi).dtype == np.int32


@pytest.mark.parametrize("n_rb_subbands", [1, 4])
@pytest.mark.parametrize("name", scenarios.scenario_names())
def test_radio_forward_matches_reference(name, n_rb_subbands):
    ref, port = pair(shrink(name, n_rb_subbands=n_rb_subbands))
    U, fad = ref.U._data, ref.fading._data
    rs_j, rs_t = ref.radio_static(), port.radio_static()
    Ut, fadt = port.U._data, port.fading._data
    want = j_radio.radio_forward(rs_j, U, fad=fad, backend="xla")
    got = t_radio.radio_forward(rs_t, Ut, fad=fadt)
    np.testing.assert_allclose(np_(got.G), np_(want.G), rtol=RTOL_GAIN)
    np.testing.assert_allclose(np_(got.rsrp), np_(want.rsrp),
                               rtol=RTOL_GAIN)
    check_outputs(got, want, ref, U, want.rsrp)
    # the fused route against the reference's Pallas kernel
    want_f = j_radio.radio_forward(rs_j, U, fad=fad, backend="pallas")
    got_f = t_radio.radio_forward(rs_t, Ut, fad=fadt, backend="fused")
    assert got_f.G is None and got_f.rsrp is None
    check_outputs(got_f, want_f, ref, U, want.rsrp)


@pytest.mark.parametrize("name", ["dense_urban", "rural_macro",
                                  "indoor_hotspot", "handover_stress"])
def test_dirty_row_updates_match_reference(name):
    """radio_init + radio_update_rows (and the fused rows where the regime
    allows them) against the reference's, after moving four UEs."""
    ref, port = pair(shrink(name))
    rs_j, rs_t = ref.radio_static(), port.radio_static()
    cfg_j, cfg_t = rs_j.cfg, rs_t.cfg
    U, fad = ref.U._data, ref.fading._data
    ho = ref.params.ho_enabled
    moved = jnp.array([3, 7, 11, 19])
    U2 = U.at[moved].add(jnp.array([30.0, -12.0, 0.0], U.dtype))
    idx = jnp.array([3, 7, 11, 19, 19, 0, 0, 0], jnp.int32)   # padded
    t = lambda x: torch.as_tensor(np_(x))
    f_j = fad if cfg_j.rayleigh_fading else None
    f_t = None if f_j is None else t(f_j)
    st_j = j_radio.radio_init(cfg_j, U, rs_j.C, rs_j.bore, f_j, rs_j.P,
                              with_tables=ho)
    want = j_radio.radio_update_rows(cfg_j, st_j, U2, rs_j.C, rs_j.bore, f_j,
                                     rs_j.P, idx)
    backends = ["torch"] if ho else ["torch", "fused"]
    R2 = j_radio.radio_forward(rs_j, U2, fad=fad, backend="xla")
    for be in backends:
        st_t = t_radio.radio_init(cfg_t, t(U), rs_t.C, rs_t.bore, f_t,
                                  rs_t.P, with_tables=ho)
        upd = (t_radio.radio_update_rows if be == "torch"
               else t_radio.radio_update_rows_fused)
        got = upd(cfg_t, st_t, t(U2), rs_t.C, rs_t.bore, f_t, rs_t.P, t(idx))
        if ho:
            np.testing.assert_allclose(np_(got.meas), np_(want.meas),
                                       rtol=RTOL_GAIN)
            R = R2.rsrp
            total = R.sum(axis=1)
            gamma_all = R / (cfg_j.noise_w + (total[:, None, :] - R))
            assert_cqi(got.cqi_all, want.cqi_all, gamma_all)
            assert_cqi(got.se_all, want.se_all, gamma_all)
            assert got.a is None and got.se is None
        else:
            assert_attachment(got.a, want.a, reference_meas(ref, U2))
            assert_cqi(got.cqi, want.cqi, R2.gamma)
            assert_cqi(got.se, want.se, R2.gamma)
            assert got.meas is None and got.se_all is None


def test_fused_rows_reject_table_carries():
    ref, port = pair(shrink("handover_stress"))
    rs = port.radio_static()
    st = t_radio.radio_init(rs.cfg, port.U._data, rs.C, rs.bore,
                            port.fading._data, rs.P, with_tables=True)
    with pytest.raises(ValueError, match="se_all"):
        t_radio.radio_update_rows_fused(rs.cfg, st, port.U._data, rs.C,
                                        rs.bore, port.fading._data, rs.P,
                                        torch.zeros(4, dtype=torch.int32))


def test_radio_update_window_and_mask_paths_agree():
    """radio_update(window=...) == radio_update(mask) == a fresh init."""
    _, port = pair(shrink("rural_macro"))
    rs = port.radio_static()
    U = port.U._data
    U2 = U.clone()
    U2[[22, 23, 0], :2] += 40.0
    mk = lambda: t_radio.radio_init(rs.cfg, U, rs.C, rs.bore, None, rs.P)
    mask = torch.zeros(24, dtype=torch.bool)
    mask[[22, 23, 0]] = True
    a = t_radio.radio_update(rs, mk(), U2, mask, budget=4)
    b = t_radio.radio_update(rs, mk(), U2, None, budget=4,
                             window=(torch.tensor(22), 3))
    c = t_radio.radio_init(rs.cfg, U2, rs.C, rs.bore, None, rs.P)
    for x, y, z in zip(a, b, c):
        if x is not None:
            assert torch.equal(x, y) and torch.equal(x, z)


def test_cell_update_from_carried_gains_matches_fresh_init():
    _, port = pair(shrink("handover_stress"))
    rs = port.radio_static()
    U, fad = port.U._data, port.fading._data
    st = t_radio.radio_init(rs.cfg, U, rs.C, rs.bore, fad, rs.P,
                            with_gain=True)
    P2 = rs.P.clone()
    P2[2] = 0.0
    dirty = torch.zeros(rs.P.shape[0], dtype=torch.bool)
    dirty[2] = True
    got = t_radio.radio_update_cells(rs.cfg, st, P2, dirty)
    want = t_radio.radio_init(rs.cfg, U, rs.C, rs.bore, fad, P2,
                              with_gain=True)
    for x, y in zip(got, want):
        if x is not None:
            assert torch.equal(x, y)
    assert not (got.a == 2).any()
    same = t_radio.radio_update_cells(rs.cfg, st, P2, dirty & False)
    assert torch.equal(same.se, st.se)


def test_backend_selection_is_a_function_of_the_configuration():
    p = shrink("dense_urban", antenna_phi_3dB_deg=60.0)
    port = TCRRM(__import__("repro_torch.core.params", fromlist=["x"])
                 .CRRM_parameters(**fields_of(p)), device="cpu")
    rs = port.radio_static()
    reason = t_radio.fused_unsupported_reason(rs.cfg)
    assert "non-stock sector pattern" in reason
    with pytest.raises(ValueError, match="cannot express"):
        t_radio.radio_forward(rs, port.U._data, backend="fused")
    auto = t_radio.radio_forward(rs, port.U._data, backend="auto")
    assert auto.G is not None            # "auto" took the torch chain
    with pytest.raises(ValueError, match="backend"):
        t_radio.radio_forward(rs, port.U._data, backend="pallas")
    custom = rs.cfg._replace(pathgain_fn=lambda d2, d3, hb, hu: 1.0 / d3,
                             n_sectors=1)
    assert "PATHLOSS_MODELS" in t_radio.fused_unsupported_reason(custom)
    ok = t_radio.radio_forward(
        t_radio.RadioStatic(rs.C, rs.P, rs.bore, rs.cfg._replace(
            antenna=type(rs.cfg.antenna)())), port.U._data, backend="auto")
    assert ok.G is None                  # stock pattern: "auto" fused


def test_fading_draw_shapes_and_generator_reproducibility():
    _, port = pair(shrink("dense_urban"))
    cfg = port.radio_config()
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = t_radio.draw_fading(cfg, g1, 24, 6)
    b = t_radio.draw_fading(cfg, g2, 24, 6)
    assert a.shape == (24, 6, 4) and torch.equal(a, b)
    port.resample_fading(torch.Generator().manual_seed(7))
    assert torch.equal(port.fading._data, a)

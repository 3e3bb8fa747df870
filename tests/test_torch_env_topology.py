"""The port's ``CrrmEnv(resample_topology=True)`` against the JAX package.

Each reset redraws the UE field and fading from its seed and reruns the
radio chain; the port replays the reference's topology and fading draws
(``torch_parity.env_pair``), so positions and fading are exact.  Contract:
attachment exact (no near ties at these seeds), CQI/SE exact off the CQI
steps, the PF seed and the first step as ``torch_parity.check_env_step``
(rtol 1e-4, integers exact).  The reference's state carried over with
``repro_torch.convert`` steps in the port exactly as the port's own.
"""
import jax
import numpy as np
import pytest
import torch

from repro.sim import radio as j_radio
from repro_torch import convert
from torch_parity import (DEV, RUNNABLE_SCENARIOS, assert_attachment,
                          assert_cqi, bursty, check_env_step, check_state,
                          env_pair, np_)


@pytest.mark.parametrize("name", RUNNABLE_SCENARIOS)
def test_resampled_reset_matches_reference(name):
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
    with jax.disable_jit(bursty(ref)):
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
    with jax.disable_jit(bursty(ref)):     # the replayed draws as above
        out_c = port.step(carried, port.uniform_action())
    check_env_step(out_c, out_j)
    assert torch.equal(out_c[0].ep.U, out_t[0].ep.U)
    with pytest.raises(ValueError, match="resample_topology"):
        port.step_autoreset(st, None, 1)

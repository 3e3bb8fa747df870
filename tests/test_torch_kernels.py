"""The port's fused-kernel module against the JAX package, on the CPU.

The reference runs its Pallas kernel in interpret mode
(``repro.kernels.ops.fused_sinr(..., interpret=True)``) with small tiles,
so its padding of ragged edges is exercised; the port runs
``fused_sinr_accumulate_plain`` and ``ops.fused_sinr`` on CPU tensors (the
route the fused backend takes for CPU tensors).  Tolerances: total and w
to rtol 1e-4 (sum order and log10/pow ulps; the contract of
tests/test_kernel_vs_crrm.py); u to 1e-4 of the total (it is a
difference); gamma to rtol 1e-4 times its condition number
(``torch_parity.assert_sinr``); attachment exact with no near ties at these
seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.sim import pathloss as j_pathloss
from repro_torch.kernels import fused_sinr as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.sim import pathloss as t_pathloss
from torch_parity import assert_sinr, near_tie_rows, np_

RTOL = 1e-4
NOISE_W = 1e-13
MODELS = {
    "RMa": dict(fc_GHz=0.7), "RMa_constant_height": dict(fc_GHz=0.7),
    "RMa_discretised": dict(fc_GHz=0.7), "UMa": dict(), "UMi": dict(),
    "InH": dict(), "power_law": dict(alpha=3.5)}


def inputs(n, m, k, fading, seed, n_sectors=1, h_bs=25.0, extent=2000.0):
    rng = np.random.default_rng(seed)
    U = np.column_stack([rng.uniform(0, extent, (n, 2)),
                         rng.uniform(1.0, 2.5, (n, 1))]).astype(np.float32)
    n_sites = max(1, m // n_sectors)
    sites = np.column_stack([rng.uniform(0, extent, (n_sites, 2)),
                             np.full((n_sites, 1), h_bs)])
    C = np.repeat(sites, n_sectors, axis=0)[:m].astype(np.float32)
    P = rng.uniform(1.0, 10.0, (m, k)).astype(np.float32)
    bore = ((np.arange(m) % n_sectors) * (2 * np.pi / n_sectors)).astype(
        np.float32)
    fad = {None: None,
           "wide": rng.exponential(1.0, (n, m)).astype(np.float32),
           "rb": rng.exponential(1.0, (n, m, k)).astype(np.float32)}[fading]
    return U, C, P, bore, fad


def run_both(U, C, P, bore, fad, name, n_sectors, attach_on_mean,
             noise_w=NOISE_W):
    jm = j_pathloss.make_pathloss(name, **MODELS[name])
    tm = t_pathloss.make_pathloss(name, **MODELS[name])
    if name == "RMa_discretised":
        # the Pallas kernel cannot trace this model (its LUTs would be
        # captured constants), so the reference is its materialised chain
        ref = reference_chain(U, C, P, bore, fad, jm, n_sectors,
                              attach_on_mean, noise_w)
    else:
        ref = j_ops.fused_sinr(
            jnp.asarray(U), jnp.asarray(C), jnp.asarray(P), pathgain_fn=jm,
            noise_w=noise_w, boresight=jnp.asarray(bore),
            fad=None if fad is None else jnp.asarray(fad),
            attach_on_mean=attach_on_mean, n_sectors=n_sectors, bn=16, bm=8,
            interpret=True)
    t = lambda x: None if x is None else torch.as_tensor(x)
    got = t_ops.fused_sinr(t(U), t(C), t(P), pathgain_fn=tm, noise_w=noise_w,
                           boresight=t(bore), fad=t(fad),
                           attach_on_mean=attach_on_mean, n_sectors=n_sectors)
    return ref, got


def reference_chain(U, C, P, bore, fad, model, n_sectors, attach_on_mean,
                    noise_w):
    """(gamma, a, w, u) through the reference's materialised radio chain."""
    from repro.sim import radio as j_radio
    from repro.sim.antenna import Antenna_gain
    cfg = j_radio.RadioConfig(model, Antenna_gain(), n_sectors, noise_w, 1,
                              1, 1, 1, False, True, False, 1.0)
    G0 = j_radio.pathgains(cfg, jnp.asarray(U), jnp.asarray(C),
                           jnp.asarray(bore))
    G = G0 if fad is None else j_radio.apply_fading(G0, jnp.asarray(fad))
    R = j_radio.rsrp(G, jnp.asarray(P))
    a = j_radio.attachment(j_radio.rsrp(G0, jnp.asarray(P))
                           if attach_on_mean else R)
    gamma, w, u = j_radio.sinr(R, a, noise_w)
    return gamma, a, w, u


def check(ref, got, meas_ref):
    g_r, a_r, w_r, u_r = (np_(x) for x in ref)
    g_t, a_t, w_t, u_t = (np_(x) for x in got)
    assert near_tie_rows(meas_ref).sum() == 0
    assert a_t.dtype == np.int32
    np.testing.assert_array_equal(a_t, a_r)
    np.testing.assert_allclose(w_t, w_r, rtol=RTOL)
    total = w_r + u_r
    assert_sinr(g_t, g_r, w_r, u_r, NOISE_W, rtol=RTOL)
    assert (np.abs(u_t - u_r) <= RTOL * total).all()


def reference_meas(U, C, P, bore, fad, name, n_sectors, attach_on_mean):
    """The reference's wideband measurement, for the near-tie count."""
    from repro.sim import radio as j_radio
    from repro.sim.antenna import Antenna_gain
    cfg = j_radio.RadioConfig(j_pathloss.make_pathloss(name, **MODELS[name]),
                              Antenna_gain(), n_sectors, 0.0, 1, 1, 1, 1,
                              False, True, False, 1.0)
    g = j_radio.pathgains(cfg, jnp.asarray(U), jnp.asarray(C),
                          jnp.asarray(bore))
    if fad is not None and not attach_on_mean:
        g = j_radio.apply_fading(g, jnp.asarray(fad))
    return np_(j_radio.rsrp(g, jnp.asarray(P)).sum(axis=2))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_sinr_matches_reference_per_pathloss_model(name):
    """Every pathloss model, unfaded, omni, N and M off the tile grid."""
    h_bs = 35.0 if name.startswith("RMa") else 25.0
    args = inputs(37, 13, 2, None, seed=sorted(MODELS).index(name), h_bs=h_bs)
    ref, got = run_both(*args, name, 1, False)
    check(ref, got, reference_meas(*args, name, 1, False))


@pytest.mark.parametrize("fading,attach_on_mean",
                         [(None, False), ("wide", False), ("wide", True),
                          ("rb", False), ("rb", True)])
@pytest.mark.parametrize("n_sectors", [1, 3])
def test_fused_sinr_matches_reference_fading_and_sectors(
        fading, attach_on_mean, n_sectors):
    k = 4 if fading == "rb" else 1
    args = inputs(45, 21, k, fading, seed=11 + n_sectors, n_sectors=n_sectors)
    ref, got = run_both(*args, "UMa", n_sectors, attach_on_mean)
    check(ref, got, reference_meas(*args, "UMa", n_sectors, attach_on_mean))


def test_plain_accumulator_layout_matches_reference():
    """The raw accumulator: shapes, dtypes and values of all four outputs."""
    from repro.kernels import fused_sinr as j_fused
    U, C, P, bore, fad = inputs(16, 8, 2, "rb", seed=5)
    jm, tm = j_pathloss.UMa_pathloss(), t_pathloss.UMa_pathloss()
    ref = j_fused.fused_sinr_accumulate(
        jnp.asarray(U), jnp.asarray(C), jnp.asarray(P),
        jnp.asarray(bore)[:, None], jnp.asarray(fad), pathgain_fn=jm, bn=8,
        bm=8, interpret=True)
    got = t_fused.fused_sinr_accumulate_plain(
        *(torch.as_tensor(x) for x in (U, C, P, bore, fad)), pathgain_fn=tm)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape
        assert np_(g).dtype == np_(r).dtype
        np.testing.assert_allclose(np_(g), np_(r), rtol=RTOL)


def test_tie_goes_to_the_lowest_cell_index():
    """Two co-located equal-power cells: both packages serve from the
    lower index."""
    U = np.array([[100.0, 0.0, 1.5], [0.0, 300.0, 1.5]], np.float32)
    C = np.array([[0.0, 0.0, 25.0], [500.0, 0.0, 25.0], [0.0, 0.0, 25.0]],
                 np.float32)
    P = np.full((3, 1), 5.0, np.float32)
    bore = np.zeros(3, np.float32)
    ref, got = run_both(U, C, P, bore, None, "UMa", 1, False)
    assert np_(ref[1]).tolist() == [0, 0]
    assert np_(got[1]).tolist() == [0, 0]


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    U, C, P, bore, _ = (torch.as_tensor(x) if x is not None else None
                        for x in inputs(8, 4, 1, None, seed=0))
    before = t_fused.fused_sinr_accumulate.launches
    t_fused.fused_sinr_accumulate(U, C, P, bore,
                                  pathgain_fn=t_pathloss.UMa_pathloss())
    # a CPU tensor runs the plain version, which is not a launch
    assert t_fused.fused_sinr_accumulate.launches == before
    with pytest.raises(TypeError):
        t_fused.fused_sinr_accumulate(U.double(), C, P, bore,
                                      pathgain_fn=t_pathloss.UMa_pathloss())
    with pytest.raises(ValueError, match="shape"):
        t_fused.fused_sinr_accumulate(U, C, P[:2], bore,
                                      pathgain_fn=t_pathloss.UMa_pathloss())
    with pytest.raises(ValueError, match="attach_on_mean"):
        t_fused.fused_sinr_accumulate(U, C, P, bore, attach_on_mean=True,
                                      pathgain_fn=t_pathloss.UMa_pathloss())


def test_every_model_describes_itself_to_the_kernel():
    """Kernel ids are distinct per formula family and parameter tuples
    fit the kernel's parameter block."""
    ids = set()
    for name, kw in MODELS.items():
        model_id, params = t_pathloss.make_pathloss(name, **kw).kernel_spec()
        assert all(isinstance(v, float) for v in params)
        assert len(params) <= 64
        ids.add(model_id)
    assert len(ids) == 6   # constant-height RMa shares the RMa formulas

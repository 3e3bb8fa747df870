"""The port's ``sim/shadowing.py`` against the JAX package.

Contract: ``los_probability`` and ``mixed_pathgain`` at rtol 1e-6; the
sampled functions (``sample_los``, ``shadow_fading_gain``) on the
reference's own uniforms and normals, the LOS states exact (no uniform
within 1e-6 of its probability at these inputs) and the gains at rtol
1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from repro.sim import pathloss as j_pl
from repro.sim import shadowing as j_sh
from repro_torch.sim import pathloss as t_pl
from repro_torch.sim import shadowing as t_sh
from torch_parity import np_

SCENARIOS = ("RMa", "UMa", "UMi", "InH")
RTOL_GAIN = 1e-5    # the pathloss models' contract (tests/test_torch_leaves.py)


def distances(n=400, m=6, seed=0):
    d2d = np.random.default_rng(seed).uniform(0.0, 3000.0, (n, m)).astype(
        np.float32)
    d2d[0, :4] = [0.0, 1.2, 10.0, 18.0]          # the formulas' edges
    return d2d


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_los_probability_matches_reference(scenario):
    d2d = distances()
    want = np_(j_sh.los_probability(scenario, d2d))
    got = t_sh.los_probability(scenario, torch.tensor(d2d))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np_(got), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        t_sh.los_probability("nope", torch.tensor(d2d))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sampled_los_and_shadowing_match_reference(scenario):
    d2d = distances(seed=1)
    key = jax.random.PRNGKey(4)
    los_j = j_sh.sample_los(key, scenario, d2d)
    u = np_(jax.random.uniform(key, d2d.shape))
    p = np_(j_sh.los_probability(scenario, d2d))
    assert not (np.abs(u - p) < 1e-6).any()
    los_t = t_sh.sample_los(None, scenario, torch.tensor(d2d),
                            u=torch.tensor(u))
    np.testing.assert_array_equal(np_(los_t), np_(los_j))
    for n_sectors in (1, 3):
        k = jax.random.PRNGKey(9)
        g_j = j_sh.shadow_fading_gain(k, scenario, los_j, n_sectors)
        k1, k2 = jax.random.split(k)
        n_sites = d2d.shape[1] // n_sectors
        normals = (torch.tensor(np_(jax.random.normal(k1, (d2d.shape[0],
                                                           n_sites)))),
                   torch.tensor(np_(jax.random.normal(k2, d2d.shape))))
        g_t = t_sh.shadow_fading_gain(None, scenario, los_t, n_sectors,
                                      normals=normals)
        np.testing.assert_allclose(np_(g_t), np_(g_j), rtol=1e-6)


def test_sampled_functions_draw_from_the_generator():
    d2d = torch.tensor(distances(n=2000))
    g = torch.Generator().manual_seed(0)
    los = t_sh.sample_los(g, "UMa", d2d)
    assert los.dtype == torch.bool
    # LOS frequency follows the probability (2000 x 7 links)
    assert abs(float(los.float().mean())
               - float(t_sh.los_probability("UMa", d2d).mean())) < 0.02
    gain = t_sh.shadow_fading_gain(g, "UMa", los, n_sectors=1)
    db = -10.0 * torch.log10(gain)
    assert abs(float(db[~los].std()) - 6.0) < 0.3


@pytest.mark.parametrize("models,rtol", [
    # power laws: the gains themselves agree to float32 ulps
    ((("power_law", dict(alpha=2.0)), ("power_law", dict(alpha=3.5))),
     1e-6),
    # UMa LOS/NLOS: the mixture exact, the dB-formula gains at the
    # pathloss models' own contract (tests/test_torch_leaves.py)
    ((("UMa", dict(LOS=True)), ("UMa", dict(LOS=False))), RTOL_GAIN)])
def test_mixed_pathgain_matches_reference(models, rtol):
    rng = np.random.default_rng(3)
    d2d = rng.uniform(10.0, 2000.0, (300, 5)).astype(np.float32)
    d3d = np.sqrt(d2d ** 2 + 23.5 ** 2).astype(np.float32)
    los = rng.random((300, 5)) < 0.4
    (n_los, kw_los), (n_nlos, kw_nlos) = models
    want = j_sh.mixed_pathgain(j_pl.make_pathloss(n_los, **kw_los),
                               j_pl.make_pathloss(n_nlos, **kw_nlos), los,
                               d2d, d3d, 25.0, 1.5)
    t_los = t_pl.make_pathloss(n_los, **kw_los)
    t_nlos = t_pl.make_pathloss(n_nlos, **kw_nlos)
    args = [torch.tensor(x) for x in (d2d, d3d)] + [25.0, 1.5]
    got = t_sh.mixed_pathgain(t_los, t_nlos, torch.tensor(los), *args)
    np.testing.assert_allclose(np_(got), np_(want), rtol=rtol)
    assert torch.equal(got, torch.where(torch.tensor(los),
                                        t_los.get_pathgain(*args),
                                        t_nlos.get_pathgain(*args)))

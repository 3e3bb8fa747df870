"""Gradients of the port's relaxed engine against the JAX package.

The differentiability contract of ``tests/test_rl.py:47``, held on the
reference's own inputs and draws (``torch_parity.ReplayDraws``): through
an 8-TTI relaxed rollout at 12 UEs on ``dense_urban`` and
``handover_stress``, torch autograd against central differences
(directional, best over the reference test's four eps) <= 1e-3, and
against the reference's ``jax.grad`` -- the directional derivative to
rtol 1e-4, every element within 1e-4 * max|g| (no attachment sits near a
tie at these inputs: the values agree to rtol 1e-5).  The card runs the
same check from ``tests/relax_fixture.py``'s copy of those inputs, which
is held to the reference here (``tests/make_relax_fixture.py`` writes
it).  The forward pieces of the relaxed chain
are in tests/test_torch_relax.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_relax_fixture
import relax_fixture
from repro.sim.radio import RelaxConfig as JRelax
from repro_torch.sim.radio import RelaxConfig
from test_torch_relax import _objectives, t_
from torch_parity import np_


@pytest.mark.parametrize("scenario", ["dense_urban", "handover_stress"])
def test_grad_matches_finite_differences_and_reference(scenario):
    """The directional derivative along the reference test's random
    direction: autograd against central differences, best over the four
    eps of ``tests/test_rl.py``, <= 1e-3; against the reference's
    ``jax.grad`` on the same inputs and draws to rtol 1e-4, and every
    element within 1e-4 * max|g|."""
    f_j, f_t, P0 = _objectives(scenario, 12, 8, JRelax(), RelaxConfig())
    v_j, g_j = jax.value_and_grad(f_j)(jnp.asarray(P0))
    P = t_(P0).requires_grad_(True)
    val = f_t(P)
    (g,) = torch.autograd.grad(val, P)
    g, g_j = np_(g), np_(g_j)
    assert np.isfinite(g).all(), "non-finite gradient"
    np.testing.assert_allclose(float(val.detach()), float(v_j), rtol=1e-5)
    v = np_(jax.random.normal(jax.random.PRNGKey(1), P0.shape, jnp.float32))
    v = v / np.linalg.norm(v) * np.linalg.norm(P0)
    gv, gv_j = float((g * v).sum()), float((g_j * v).sum())
    np.testing.assert_allclose(gv, gv_j, rtol=1e-4)
    assert np.abs(g - g_j).max() <= 1e-4 * np.abs(g_j).max()
    best = float("inf")
    with torch.no_grad():
        for eps in (1e-1, 3e-2, 1e-2, 3e-3):
            fd = float(f_t(t_(P0 + eps * v)) - f_t(t_(P0 - eps * v))) \
                / (2 * eps)
            best = min(best, abs(gv - fd) / max(abs(fd), 1e-12))
    assert best <= 1e-3, (f"{scenario}: grad/FD directional mismatch "
                          f"{best:.2e} (g.v={gv:.4g})")


@pytest.mark.parametrize("scenario", relax_fixture.SCENARIOS)
def test_fd_fixture_holds_the_reference_inputs(scenario):
    """``tests/data/relax_fd_*.npz`` (the card's copy of the check above)
    is the reference's data bit for bit, and the check on it passes here
    too: best over the four eps <= 1e-3."""
    want = make_relax_fixture.build(scenario)
    with np.load(relax_fixture.path(scenario)) as f:
        assert sorted(f.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(f[k], want[k], err_msg=k)
    _, best, errs = relax_fixture.fd_check(scenario, torch.device("cpu"))
    assert best <= 1e-3, errs

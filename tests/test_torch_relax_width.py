"""The relaxed power objective at ``dense_urban``'s preset width against
the JAX package.

``rl.diffopt.make_power_objective`` at 200 UEs and ``u = 0`` on the
reference's drop and draws (``tests/data/relax_diffopt_dense_urban.npz``,
which the card reads too).  Over the horizon that both programs share,
the first 2 TTIs as 2 segments, the port's gradient equals ``jax.grad``'s
-- the objective to rtol 1e-5, the derivative along the stored direction
to rtol 1e-4, every element within 1e-4 * max|g| (measured 0, 1.2e-5 and
1.3e-5) -- and central differences to <= 1e-3, as in
``tests/test_rl.py:47``.  Over ``optimize_power_plan``'s defaults (4
segments x 10 TTIs) a one-ulp drained-backlog residue parts the programs
from the third TTI on (``tests/relax_fixture.py``); the file keeps the
reference's numbers there for the card to print beside its own, and
``tests/test_torch_relax_width_fixture.py`` holds them equal to the
reference.
"""
import numpy as np
import pytest
import torch

import relax_fixture

CPU = torch.device("cpu")


@pytest.mark.parametrize("horizon", ["held", "full"])
def test_diffopt_gradient_at_the_preset_width(horizon):
    """The shared horizon holds the contract above.  The full horizon
    holds a finite gradient only; its agreement is measured (ROADMAP
    queue 3), not held."""
    out = relax_fixture.diffopt_check(CPU, horizon)
    port, ref = out["port"], out["ref"]
    assert np.isfinite(port["grad"]).all(), "non-finite gradient"
    if horizon == "full":
        return
    np.testing.assert_allclose(port["value"], ref["value"], rtol=1e-5)
    np.testing.assert_allclose(port["gv"], ref["gv"], rtol=1e-4)
    g, g_j = port["grad"], ref["grad"]
    assert np.abs(g - g_j).max() <= 1e-4 * np.abs(g_j).max()
    assert min(port["fd_errs"]) <= 1e-3, port["fd_errs"]

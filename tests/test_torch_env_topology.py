"""The port's ``CrrmEnv(resample_topology=True)`` against the JAX package.

Each reset redraws the UE field and fading from its seed and reruns the
radio chain; the port replays the reference's topology and fading draws
(``torch_parity.env_pair``), so positions and fading are exact.  Contract
(``torch_parity.check_resampled_reset``): attachment exact (no near ties
at these seeds), CQI/SE exact off the CQI steps, the PF seed and the first
step as ``torch_parity.check_env_step`` (rtol 1e-4, integers exact).  The
reference's state carried over with ``repro_torch.convert`` steps in the
port exactly as the port's own.  The step is one TTI, so the reference
steps compiled (see ``check_resampled_reset``).
"""
import pytest

from torch_parity import RUNNABLE_SCENARIOS, check_resampled_reset


@pytest.mark.parametrize("name", RUNNABLE_SCENARIOS)
def test_resampled_reset_matches_reference(name):
    check_resampled_reset(name)

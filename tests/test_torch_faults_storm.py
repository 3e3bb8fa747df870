"""The port's fault process on the ``outage_storm`` preset against the
JAX package under Poisson traffic: the engine in the dense radio mode
(the incremental mode: ``tests/test_torch_faults_storm_incremental.py``;
the env: ``tests/test_torch_faults_storm_env.py``).  The storm's A3,
mobility and fading make the eager reference compile a set of primitives
of its own, so these cases have a file of their own beside
tests/test_torch_faults.py, whose helpers and contract they share: ``cell_state``, attachment and RB grants exact,
throughput and backlog rtol 1e-4; Poisson traffic runs the reference
eagerly.
"""
import jax  # noqa: F401  (the parity suites import both packages)
import pytest

from test_torch_faults import check_storm


@pytest.mark.parametrize("radio_mode,policy,traffic", [
    ("dense", "rr", "poisson")])
def test_storm_engine_matches_reference(radio_mode, policy, traffic):
    """The dense Poisson-traffic case of ``test_torch_faults.check_storm``
    (rr grants; the reference eager); the incremental one runs in
    tests/test_torch_faults_storm_incremental.py, the full-buffer ones in
    tests/test_torch_faults.py."""
    check_storm(radio_mode, policy, traffic)

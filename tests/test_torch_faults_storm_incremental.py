"""The port's fault process on the ``outage_storm`` preset against the
JAX package under Poisson traffic: the engine in the incremental radio
mode (the dense mode: ``tests/test_torch_faults_storm.py``, whose
contract and helpers these cases share with tests/test_torch_faults.py:
``cell_state``, attachment and RB grants exact, throughput and backlog
rtol 1e-4; Poisson traffic runs the reference eagerly).  A file of its
own keeps each storm file's eager reference under a minute.
"""
import jax  # noqa: F401  (the parity suites import both packages)
import pytest

from test_torch_faults import check_storm


@pytest.mark.parametrize("radio_mode,policy,traffic", [
    ("incremental", "rr", "poisson")])
def test_storm_engine_matches_reference(radio_mode, policy, traffic):
    """The incremental Poisson-traffic case of
    ``test_torch_faults.check_storm`` (rr grants; the reference eager)."""
    check_storm(radio_mode, policy, traffic)

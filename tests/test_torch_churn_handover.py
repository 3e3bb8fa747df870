"""Churn in the full twin regime, the port against the JAX package:
carried fading with newborn rows redrawn, newborns attached at once under
A3, HARQ and bursty traffic, on the reference's draws.  The contract and
helpers of tests/test_torch_churn.py; a file of its own because its
Poisson traffic runs the reference eagerly, whose compiles of this regime
take most of a minute.
"""
from repro.core.params import CRRM_parameters as JParams
from test_torch_churn import BASE, check_pair, churn_pair


def test_churn_with_handover_fading_and_harq_matches_reference():
    """Carried fading (newborn rows redrawn), newborns attached at once
    under A3, HARQ, bursty traffic: the full regime of the twin preset."""
    params = JParams(**dict(BASE, n_ues=24), rayleigh_fading=True,
                     ho_enabled=True, harq_bler=0.2,
                     traffic_model="poisson",
                     traffic_params=dict(arrival_rate_hz=300.0,
                                         packet_size_bits=12_000.0))
    check_pair(*churn_pair(params, n_tti=15))

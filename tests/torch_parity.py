"""Shared helpers of the ``test_torch_*`` parity tests: building the same
simulator in both packages and holding integer outputs to the contract.

Contract for quantised outputs: attachment exact, except rows whose two
best wideband measurements differ by less than 1e-5 relative in the
reference (counted; at the test seeds there are none); CQI exact, except
where the reference's SINR lies within 1e-4 dB of a CQI threshold.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.crrm import CRRM as JCRRM
from repro.sim import phy as j_phy
from repro_torch import convert

DEV = torch.device("cpu")


def np_(x):
    """numpy view of a JAX array, a tensor, or None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fields_of(params):
    """The reference params as a field dict the port accepts."""
    d = {f.name: getattr(params, f.name)
         for f in dataclasses.fields(params)}
    d["faults"] = None          # the fault process is a later slice
    return d


def pair(params):
    """(reference CRRM, port CRRM) on the same roots."""
    ref = JCRRM(params)
    roots = {k: np_(getattr(ref, k)._data)
             for k in ("U", "C", "P", "boresight", "fading")}
    roots["buffer"] = np_(ref.buffer._data)
    port = convert.crrm_from_reference(fields_of(params), roots, DEV)
    return ref, port


def near_tie_rows(meas_ref):
    """Rows whose two best reference measurements differ < 1e-5 relative."""
    m = np.sort(np_(meas_ref), axis=1)
    if m.shape[1] < 2:
        return np.zeros(m.shape[0], bool)
    return (m[:, -1] - m[:, -2]) < 1e-5 * np.abs(m[:, -1])


def assert_attachment(a_port, a_ref, meas_ref):
    ties = near_tie_rows(meas_ref)
    assert ties.sum() == 0, f"{ties.sum()} near-tie rows at this seed"
    a_port, a_ref = np_(a_port), np_(a_ref)
    assert a_port.dtype == np.int32
    np.testing.assert_array_equal(a_port, a_ref)


def assert_sinr(gamma, gamma_ref, w_ref, u_ref, noise_w, rtol=1e-4):
    """gamma = w / (noise + total - w) to ``rtol`` times its condition number.

    The relative errors of w and total (rtol 1e-4: sum order, ulps of
    log10/pow) reach gamma amplified by kappa = 1 + (w + total) /
    (noise + u): 1 where interference or noise dominate, about 2 * gamma
    where the wanted power dominates and u is a small difference of two
    large sums.  ``rtol * kappa`` is that propagated bound.
    """
    g, g_r = np_(gamma), np_(gamma_ref)
    w_r, u_r = np_(w_ref).astype(np.float64), np_(u_ref).astype(np.float64)
    kappa = 1.0 + (2 * w_r + u_r) / (noise_w + u_r)
    bad = np.abs(g - g_r) > rtol * kappa * np.abs(g_r)
    assert not bad.any(), (
        f"{bad.sum()} SINR entries off: got {g[bad][:5]}, want {g_r[bad][:5]}")


def near_threshold(gamma_ref):
    """Entries whose reference SINR (dB) is within 1e-4 dB of a CQI step."""
    db = np_(j_phy.sinr_to_db(jnp.asarray(np_(gamma_ref))))
    thr = np_(j_phy.CQI_SINR_THRESHOLDS_DB)
    return np.abs(db[..., None] - thr).min(axis=-1) < 1e-4


def assert_cqi(port, ref, gamma_ref):
    """CQI (or a quantity it determines) exact away from the staircase."""
    edge = near_threshold(gamma_ref)
    assert edge.mean() < 0.01, f"{edge.sum()} entries sit on a CQI step"
    np.testing.assert_array_equal(np_(port)[~edge], np_(ref)[~edge])

"""A cell seeded DOWN is dark, in the port as in the JAX package.

The reference's case of tests/test_faults.py, held to the contract of
tests/test_torch_faults.py (whose helpers it uses) on the reference's
draws: ``cell_state``, attachment and RB grants exact, throughput and
backlog rtol 1e-4.  Its Poisson traffic runs the reference eagerly, whose
compiles take a file of their own to stay under a minute.
"""
import numpy as np

from repro.core.params import CRRM_parameters as JParams
from repro.sim import faults as j_faults
from repro_torch.sim.faults import DOWN, UP
from test_torch_faults import BASE, FROZEN, check_pair, fault_pair
from torch_parity import np_


def test_down_cell_is_dark():
    """A cell seeded DOWN (frozen chain) serves zero bits, is granted
    zero RBs and is nobody's serving cell; the port matches the reference
    on the same draws."""
    dark, cs = 2, np.full(5, UP, np.int32)
    cs[dark] = DOWN
    params = JParams(**dict(BASE, n_ues=32, n_cells=5),
                     faults=j_faults.FaultConfig(**FROZEN))
    out_j, out_t = fault_pair(params, n_tti=15, key=1, cell_state=cs)
    check_pair(out_j, out_t)
    s, _, telem = out_t
    assert float(telem.served_bits[:, dark].sum()) == 0.0
    assert float(telem.granted_rb[:, dark].sum()) == 0.0
    assert not (s.serving == dark).any()
    assert float(telem.served_bits.sum()) > 0.0
    np.testing.assert_array_equal(np_(s.cell_state), cs)

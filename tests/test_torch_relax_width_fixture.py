"""The committed fixture of the relaxed power objective at
``dense_urban``'s preset width (``tests/data/relax_diffopt_dense_urban.npz``,
which the card reads) against the JAX package: its inputs are the
reference's bit for bit, and its numbers the reference's.  The port's
gradient at that width: ``tests/test_torch_relax_width.py``.
"""
import numpy as np

import make_relax_fixture
import relax_fixture


def test_diffopt_fixture_holds_the_reference():
    """The committed inputs are the reference's bit for bit, and its value,
    gradient and central-difference errors at both horizons to rtol
    1e-6."""
    want = make_relax_fixture.build_diffopt()
    got = relax_fixture.read(relax_fixture.DIFFOPT["scenario"], "diffopt")
    assert sorted(got) == sorted(want)
    for k in want:
        if "_ref_" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

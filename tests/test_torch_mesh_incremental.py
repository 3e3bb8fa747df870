"""The port's sharded incremental engine against one device.

``tests/test_smart_update_scan.py``'s incremental mesh case on 2 gloo
ranks -- rr with A3 handover tables under Poisson traffic through the
torch rows -- and the fused route (its plain version on the CPU) under pf
at full buffer, each UE shard patching its own window movers.  Held, as in
tests/test_torch_mesh_engine.py (whose helpers run them), to the
reference's single-device incremental rollout and to the port's own (rr
bitwise, pf within 1e-5), and to the sharded dense rollout on the same
mesh and draws (rtol 1e-5, atol 1e-2).
"""
import numpy as np
import pytest

from test_torch_mesh_engine import (PO, check_reference, check_single_device,
                                    ue_mesh_runs)
from torch_mesh import same_on_every_rank

WINDOW = dict(radio_mode="incremental", mobility_step_m=20.0,
              mobility_move_frac=0.125)
INC_CASES = {
    "inc_ho_rr": (True, WINDOW,
                  dict(rayleigh_fading=True, attach_ignores_fading=True,
                       scheduler_policy="rr", ho_enabled=True, **PO)),
    "inc_fused_pf": (False, dict(WINDOW, inc_backend="fused"),
                     dict(rayleigh_fading=True, attach_ignores_fading=True,
                          scheduler_policy="pf", fairness_p=0.5)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ue_mesh_runs(INC_CASES, tmp_path_factory.mktemp("mesh_inc"),
                        dense_arms=True)


@pytest.mark.parametrize("name", list(INC_CASES))
def test_incremental_mesh_matches_reference(runs, name):
    check_reference(runs, name)


@pytest.mark.parametrize("name", list(INC_CASES))
def test_incremental_mesh_matches_port_single_device(runs, name):
    check_single_device(runs, name, INC_CASES[name])


@pytest.mark.parametrize("name", list(INC_CASES))
def test_incremental_mesh_matches_dense_mesh(runs, name):
    outs = runs[0][0]
    np.testing.assert_allclose(outs[name][1], outs[f"{name}/dense"][1],
                               rtol=1e-5, atol=1e-2)


def test_every_rank_returns_the_same_bits(runs):
    same_on_every_rank(runs[0])

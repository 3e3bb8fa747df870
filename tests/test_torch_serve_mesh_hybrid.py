"""``ServeEngine(arch, mesh)`` for the hybrid family against the
reference's ``ServeEngine`` on the same meshes: reduced zamba2-1.2b
(Mamba-2 and the shared attention block), 2 slots, ``max_len`` 64, the
reference test's two requests.

The reference's engine runs in one subprocess that forces 4 host devices
and builds Auto (1, 1) and (1, 2) meshes (``tests/lm_mesh_parity.py``,
``serve_on_meshes``); the port's engine serves the reference engine's own
params on a 1-rank gloo group (1, 1) and on two gloo ranks (1, 2), where
each rank computes its half of the Mamba heads (its ``in_proj`` block the
x and z columns of its channels, its ``h`` / ``conv`` cache blocks) and of
the shared block's attention heads.
Held under ``tests/lm_fixture.py``'s contract: logits within 1e-3 while a
slot's inputs agree, tokens exact off counted near ties.  The SSM
family: ``tests/test_torch_serve_mesh_ssm.py``; (2, 2):
``tests/test_torch_serve_mesh_data_ssm.py``.
"""
import pytest

import lm_mesh_parity as lmp
from lm_train_parity import one_thread  # noqa: F401  (autouse)

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return lmp.serve_on_meshes([ARCH], tmp_path_factory)


@pytest.mark.parametrize("shape", lmp.SERVE_MESHES)
def test_engine_holds_the_reference_s(served, shape):
    ref, _, port = served
    lmp.hold_served(ref, port, ARCH, shape)


def test_each_rank_holds_its_channel_block(served):
    lmp.hold_channel_blocks(served[2], ARCH)

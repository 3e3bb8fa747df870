"""``ServeEngine(arch, mesh)`` against the reference's ``ServeEngine`` on
the same meshes, for reduced granite-moe-1b-a400m (8 experts, 4 per rank;
the router's columns on ``model``), 2 slots, ``max_len`` 64, the
reference test's two requests.

The reference's engine runs in one subprocess that forces 4 host devices
and builds Auto (1, 1) and (1, 2) meshes (``tests/lm_mesh_parity.py``,
``serve_on_meshes``).  The port's engine serves the reference engine's
own params (saved by the subprocess, through ``convert.lm_params``):
(1, 1) on a 1-rank gloo group in the pytest process, (1, 2) on two gloo
ranks.  Held under ``tests/lm_fixture.py``'s contract: logits within
1e-3 while a slot's inputs agree, tokens exact off counted near ties.
Each rank of (1, 2) holds its half of the experts, heads and vocab, and
its attention computes 2 of the 4 heads.  The dense configs and the HLO
parser: ``tests/test_torch_serve_mesh.py``.
"""
import pytest

import lm_mesh_parity as lmp
from lm_train_parity import one_thread  # noqa: F401  (autouse)

ARCHS = ["granite-moe-1b-a400m"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return lmp.serve_on_meshes(ARCHS, tmp_path_factory)


@pytest.mark.parametrize("shape", lmp.SERVE_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_holds_the_reference_s(served, arch, shape):
    ref, _, port = served
    lmp.hold_served(ref, port, arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_model_block(served, arch):
    blocks = lmp.hold_blocks(served[2], arch)
    assert blocks["layers/moe/wi_gate"] == (2, 4, 128, 256)
    assert blocks["layers/moe/router"] == (2, 128, 4)

"""The step-1 gradient of ``train.step``'s sharded step with
tensor-parallel Mamba layers, leaf by leaf, against the reference's own
sharded gradient on an Auto mesh of the same shape, from the reference's
initial state (``lm_mesh_parity.reference_grads`` / ``port_grads``):
reduced zamba2-1.2b (Mamba-2: ``B_proj`` and ``C_proj`` replicated,
feeding the rank's heads; the shared attention block), float32 compute,
``SyntheticLM`` batch 4 x 32, on (1, 2) ((2, 2):
``tests/test_torch_lm_mesh_grads_hybrid_dp.py``).  The loss tests' AdamW
steps cannot see a leaf's gradient scale (AdamW's first update is its
sign); this holds it.  Contract: each leaf's norm within
``lm_mesh_parity.GRAD_NORM_RTOL`` (1e-4) of the reference's.  The ssm
family: ``tests/test_torch_lm_mesh_grads_ssm.py``.
"""
import pytest

import lm_mesh_parity as lmp
from lm_train_parity import one_thread  # noqa: F401  (autouse)

SHAPE = (1, 2)
RUN = dict(lmp.ADAMW, arch="zamba2-1.2b", cfg={"dtype": "float32"},
           batch=(4, 32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return lmp.reference_grads(RUN, [SHAPE],
                               tmp_path_factory.mktemp("ref"))[SHAPE]


@pytest.mark.parametrize("shape", [SHAPE], ids=["1x2"])
def test_step1_gradient_holds_the_reference(reference, shape, tmp_path):
    got = lmp.port_grads(RUN, [shape], tmp_path)[shape]
    lmp.hold_grads(got, reference, f"{RUN['arch']} {shape}")

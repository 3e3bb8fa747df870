"""The card's mesh-train fixture pipeline at the reduced config: the
reference's sharded run as ``tests/make_lm_mesh_fixture.py`` builds it
(``jit_train_step`` on an Auto (1, 1) mesh), against
``tests/lm_mesh_fixture.py``'s port run through ``train.loop.train(mesh=)``
on a 1-rank gloo mesh and its hold (float32 losses rtol 1e-5, bfloat16
within 2e-2) -- the card runs the same at full width against the
committed file.  The bfloat16 cast of the layer weights rounds every f32
layer leaf (the norm scales, computed in float32, too) and, through its
transpose, their gradients: on bfloat16 compute the first step's loss is
the port's unsharded one bit for bit (the weights reach the matmuls in
bfloat16 either way, the scales start at 1), the later steps are not; on
float32 compute the unsharded run misses the sharded reference.
"""
import numpy as np
import pytest

import lm_fixture
import lm_mesh_fixture as lmf
import make_lm_mesh_fixture
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro_torch.core.distributed import make_mesh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_fixture_pipeline_on_the_reduced_config(dtype, tmp_path):
    cfg = lm_fixture.config(dtype, reduced=True)
    tree = lm_fixture.param_tree(cfg)
    want = make_lm_mesh_fixture.build(dtype, tree, reduced=True)
    with torch_mesh.one_rank_group(tmp_path):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        losses, state = lmf.run(cfg, tree, mesh)
    out = lmf.hold(losses, dtype, want)
    assert len(out["loss"]) == lmf.STEPS
    plain, _ = lmf.run(cfg, tree, None, device="cpu")
    if dtype == "bfloat16":
        assert plain[0].tobytes() == losses[0].tobytes()
    else:
        assert np.abs(plain / want["loss"] - 1).max() > 1e-6
    assert plain.tobytes() != losses.tobytes()

"""``train.loop.train(mesh=)`` with tensor-parallel compute on the
``model`` axis against the reference's own sharded loop on Auto meshes
of the same shapes (``tests/lm_mesh_parity.py``): reduced granite-moe-1b-a400m (8 experts, top-2: 4 experts per rank, the router's columns on ``model``; its vocab of 512 on ``model``), AdamW
(``warmup_cosine(3e-3, 5, 60)``, no weight decay), ``SyntheticLM``
batch 4 x 32, 10 steps, every step logged, on (2, 2) (four gloo ranks:
the batch on ``data`` as well; (1, 2): ``tests/test_torch_lm_mesh_train_moe.py``).  Contract: logged losses within rtol 1e-5 over the first 4
steps, and over 10 within ``lm_mesh_parity.RTOL_10_MOE``: the reference's
own runs on different meshes part by up to 1.75e-3 (its top-2 routing meets near ties) by step 10
(measured); every rank holds its ``model`` block of the tensor-parallel
weights.
"""
import pytest

import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)

ARCH = "granite-moe-1b-a400m"
RUNS = [dict(lmp.ADAMW, arch=ARCH, mesh=(2, 2))]


@pytest.fixture(scope="module")
def reference():
    return lmp.reference_losses(RUNS)


@pytest.mark.parametrize("i", [0], ids=["2x2"])
def test_mesh_holds_the_reference(tmp_path, reference, i):
    run = lmp.start_from_reference(RUNS[i], tmp_path / "ckpt")
    world = run["mesh"][0] * run["mesh"][1]
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [run]}, world,
                                tmp_path)
    torch_mesh.same_on_every_rank([o[0]["hist"] for o in outs])
    lmp.hold(outs[0][0]["hist"], reference[i], f"{ARCH} {run['mesh']}",
             lmp.RTOL_10_MOE)
    blocks = outs[0][0]["blocks"]
    assert blocks["layers/attn/wq"] == (2, 128, 2, 32)
    assert blocks["layers/attn/wo"] == (2, 2, 32, 128)
    assert blocks["embed/embedding"] == (256, 128)
    assert blocks["layers/moe/wi_gate"] == (2, 4, 128, 256)
    assert blocks["layers/moe/router"] == (2, 128, 4)

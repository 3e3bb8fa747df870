"""``train.loop.train(mesh=)`` of the SSM family with tensor-parallel Mamba
layers on the ``model`` axis, against the reference's own sharded loop
on Auto meshes of the same shapes (``tests/lm_mesh_parity.py``), from
the reference's initial state (restored onto the mesh: each ``in_proj``
block the x and z columns of the rank's channels): reduced falcon-
mamba-7b (Mamba-1: each rank computes its half of the 256 channels,
``x_proj`` and ``out_proj`` row-parallel; the loss vocab-parallel),
AdamW (``warmup_cosine(3e-3, 5, 60)``, no weight decay), ``SyntheticLM``
batch 4 x 32, 4 steps, every step logged, on (2, 2) (four gloo ranks;
(1, 2): ``tests/test_torch_lm_mesh_train_ssm.py``).  Contract: logged
losses within rtol 1e-5 (``lm_mesh_parity.RTOL_4``); every rank holds
its ``model`` block of the Mamba weights.  Strategy ``"dp"``:
``tests/test_torch_lm_mesh_train_ssm_strategy_dp.py``.  The hybrid family:
``tests/test_torch_lm_mesh_train_hybrid.py``.
"""
import pytest

import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)

ARCH = "falcon-mamba-7b"
MESHES = [(2, 2)]
RUNS = [dict(lmp.ADAMW, arch=ARCH, mesh=m, steps=4) for m in MESHES]


@pytest.fixture(scope="module")
def reference():
    return lmp.reference_losses(RUNS)


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[f"{m[0]}x{m[1]}" for m in MESHES])
def test_mesh_holds_the_reference(tmp_path, reference, i):
    run = lmp.start_from_reference(RUNS[i], tmp_path / "ckpt")
    world = run["mesh"][0] * run["mesh"][1]
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [run]}, world,
                                tmp_path)
    torch_mesh.same_on_every_rank([o[0]["hist"] for o in outs])
    lmp.hold(outs[0][0]["hist"], reference[i], f"{ARCH} {run['mesh']}",
             lmp.RTOL_4)
    blocks = outs[0][0]["blocks"]
    assert blocks["layers/ssm/in_proj"] == (2, 128, 256)
    assert blocks["layers/ssm/x_proj"] == (2, 128, 40)
    assert blocks["layers/ssm/out_proj"] == (2, 128, 128)
    assert blocks["lm_head/kernel"] == (128, 256)

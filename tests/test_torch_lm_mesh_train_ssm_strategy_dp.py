"""``train.loop.train(mesh=)`` of the SSM family under strategy ``"dp"``
(the one the dry-run picks for falcon-mamba-7b: the batch on both axes,
nothing tensor-parallel) against the reference's own ``"dp"`` loop on an
Auto (2, 2) mesh (``tests/lm_mesh_parity.py``), from the reference's
initial state: reduced falcon-mamba-7b widened to d_model 256, so that
``in_proj``'s 1024 columns shard on ``("data", "model")`` -- each rank
a contiguous block, no x and z interleave (``sharding.xz_ranks``) --
AdamW (``warmup_cosine(3e-3, 5, 60)``, no weight decay), ``SyntheticLM``
batch 4 x 32, 4 steps, every step logged, four gloo ranks.  Contract:
logged losses within rtol 1e-5 (``lm_mesh_parity.RTOL_4``).  The ``"2d"``
runs: ``tests/test_torch_lm_mesh_train_ssm{,_dp}.py``.
"""
import pytest

import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)

ARCH = "falcon-mamba-7b"
RUNS = [dict(lmp.ADAMW, arch=ARCH, mesh=(2, 2), steps=4, strategy="dp",
             cfg={"d_model": 256})]


@pytest.fixture(scope="module")
def reference():
    return lmp.reference_losses(RUNS)


@pytest.mark.parametrize("i", [0], ids=["2x2-dp-d256"])
def test_mesh_holds_the_reference(tmp_path, reference, i):
    run = lmp.start_from_reference(RUNS[i], tmp_path / "ckpt")
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [run]}, 4,
                                tmp_path)
    torch_mesh.same_on_every_rank([o[0]["hist"] for o in outs])
    lmp.hold(outs[0][0]["hist"], reference[i], f"{ARCH} {run['mesh']} dp",
             lmp.RTOL_4)
    # (L, D, 2 din) = (2, 256, 1024): a contiguous quarter of the columns
    assert outs[0][0]["blocks"]["layers/ssm/in_proj"] == (2, 256, 256)

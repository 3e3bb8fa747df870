"""``train.loop.train(mesh=)`` against the reference's sharded loop on a
(4, 1) mesh of four gloo ranks (``tests/lm_mesh_parity.py``): reduced
qwen1.5-0.5b, the batch over 'data', 'model' of one; the AdamW run of
``test_torch_lm_mesh_train.py`` (losses within rtol 1e-5 over 4 steps,
1e-4 over 10).
"""
import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)

RUN = dict(lmp.ADAMW, mesh=(4, 1))


def test_data_mesh_holds_the_reference(tmp_path):
    ref = lmp.reference_losses([RUN])
    run = lmp.start_from_reference(RUN, tmp_path / "ckpt")
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [run]}, 4,
                                tmp_path)
    torch_mesh.same_on_every_rank([o[0]["hist"] for o in outs])
    lmp.hold(outs[0][0]["hist"], ref[0], "(4, 1)")
    assert outs[0][0]["counts"]["all-reduce"] > 0

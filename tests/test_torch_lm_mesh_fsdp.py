"""``train.loop.train(mesh=)`` against the reference's sharded loop on
four gloo ranks (``tests/lm_mesh_parity.py``) where the ZeRO-3 blocks are
cut over the batch axes: a widened qwen (vocab 2048, d_ff 1024: past the
rules' 1024 floor) on a (2, 2) mesh under the "dp" strategy, where the
embedding, the head and the MLP weights are blocks over both axes,
gathered per layer and reduce-scattered in the backward.  The AdamW run
of ``test_torch_lm_mesh_train.py``; the 10-step hold is
``lm_mesh_parity.RTOL_10_WIDE`` (the reference's own spread across
meshes), the first 4 steps 1e-5.
"""
import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)

RUN = dict(lmp.ADAMW, mesh=(2, 2), strategy="dp", cfg=lmp.WIDE)


def test_fsdp_mesh_holds_the_reference(tmp_path):
    ref = lmp.reference_losses([RUN])
    run = lmp.start_from_reference(RUN, tmp_path / "ckpt")
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [run]}, 4,
                                tmp_path)
    torch_mesh.same_on_every_rank([o[0]["hist"] for o in outs])
    lmp.hold(outs[0][0]["hist"], ref[0], "(2, 2) dp", lmp.RTOL_10_WIDE)

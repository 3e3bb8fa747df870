"""``train.loop.train(mesh=)`` with FSDP and tensor parallelism together
against the reference's own sharded loop on an Auto (2, 2) mesh
(``tests/lm_mesh_parity.py``): reduced qwen1.5-0.5b at d_model 1024, so
that under "2d" the projections' D dimension is sharded over ``data`` and
their heads or F columns over ``model`` -- each layer gathers its
``data`` blocks, keeps its ``model`` block, and sums its gradients over
``data``.  AdamW (``warmup_cosine(3e-3, 5, 60)``, no weight decay),
``SyntheticLM`` batch 4 x 32, 4 steps on four gloo ranks.  Contract:
logged losses within rtol 1e-5; the ranks hold the blocks of both axes.
"""
import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)

RUN = dict(lmp.ADAMW, mesh=(2, 2), steps=4, cfg={"d_model": 1024})


def test_fsdp_and_tp_hold_the_reference(tmp_path):
    want = lmp.reference_losses([RUN])[0]
    run = lmp.start_from_reference(RUN, tmp_path / "ckpt")
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [run]}, 4,
                                tmp_path)
    torch_mesh.same_on_every_rank([o[0]["hist"] for o in outs])
    lmp.hold(outs[0][0]["hist"], want, "qwen d_model 1024 (2, 2)")
    blocks = outs[0][0]["blocks"]
    assert blocks["layers/attn/wq"] == (2, 512, 2, 32)
    assert blocks["layers/mlp/wi_gate"] == (2, 512, 128)
    assert blocks["lm_head/kernel"] == (512, 256)

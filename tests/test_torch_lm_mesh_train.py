"""``train.loop.train(mesh=)`` (ZeRO-3 over ``torch.distributed``) against
the reference's own sharded loop on Auto meshes of the same shapes, on
reduced qwen1.5-0.5b on the CPU: AdamW (``warmup_cosine(3e-3, 5, 60)``, no
weight decay), ``SyntheticLM`` batch 4 x 32, 10 steps, every step logged
(``tests/lm_mesh_parity.py``).

Meshes (1, 1) (a 1-rank gloo group in the pytest process) and (2, 2)
(four gloo ranks: heads, the MLP, the embedding and the head sharded on
'model', the batch on 'data').  Even (1, 1) computes the layers on
bfloat16-rounded weights, as the reference's sharded loop does, so the
port's unsharded step misses the reference's (1, 1) loop (checked here
too); the sharded one holds it.
"""
import numpy as np
import pytest

import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro_torch.core.distributed import make_mesh
from repro_torch.train.loop import train

RUNS = [dict(lmp.ADAMW, mesh=(1, 1)), dict(lmp.ADAMW, mesh=(2, 2))]


@pytest.fixture(scope="module")
def reference():
    return lmp.reference_losses(RUNS)


def test_one_rank_mesh_holds_the_reference(tmp_path, reference):
    run = lmp.start_from_reference(RUNS[0], tmp_path / "ckpt")
    with torch_mesh.one_rank_group(tmp_path):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        arch, opt, data = torch_mesh.lm_setup(run)
        state, hist = train(arch, opt, mesh, data, steps=run["steps"],
                            ckpt_dir=run["dir"], log_every=1)
    lmp.hold(hist, reference[0], "(1, 1)")
    assert int(state["step"]) == run["steps"]
    # the unsharded loop on the same start: off the sharded reference
    unsharded = lmp.start_from_reference(RUNS[0], tmp_path / "plain")
    arch, opt, data = torch_mesh.lm_setup(unsharded)
    _, plain = train(arch, opt, None, data, steps=4, ckpt_dir=unsharded[
        "dir"], log_every=1, device="cpu")
    gap = np.abs(np.asarray(plain) / reference[0][:4] - 1).max()
    assert gap > 10 * lmp.RTOL_4, gap


def test_two_by_two_mesh_holds_the_reference(tmp_path, reference):
    run = lmp.start_from_reference(RUNS[1], tmp_path / "ckpt")
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [run]}, 4,
                                tmp_path)
    torch_mesh.same_on_every_rank([o[0]["hist"] for o in outs])
    lmp.hold(outs[0][0]["hist"], reference[1], "(2, 2)")
    # the sharded leaves were gathered and their gradients reduced
    assert outs[0][0]["counts"]["all-reduce"] > 0

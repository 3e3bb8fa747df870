"""A sharded run resumed on another mesh continues the same run (elastic,
as ``tests/test_elastic_restore.py`` restores the reference's checkpoint
onto another mesh): reduced qwen1.5-0.5b, the AdamW run of
``tests/lm_mesh_parity.py``.  On four gloo ranks, 10 steps uninterrupted
on (2, 2); 5 steps on (2, 2) with a checkpoint, resumed on (4, 1) to 10;
the same 5-step checkpoint resumed on a 1-rank (1, 1) mesh in the pytest
process.

Contract (the loop's): the resumed runs' logged losses within rtol 1e-4
of the uninterrupted run's over steps 6-10, their final params within
rtol 2e-4 / atol 2e-5.  The checkpoints hold global leaves, so the
resumed mesh takes its own blocks of them.
"""
import numpy as np
import pytest

import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro_torch.core.distributed import make_mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import train
from repro_torch.tree import flatten


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    full = lmp.start_from_reference(dict(lmp.ADAMW, mesh=(2, 2),
                                         params=True), d / "full")
    part = lmp.start_from_reference(dict(lmp.ADAMW, mesh=(2, 2), steps=5,
                                         ckpt_every=5), d / "part")
    part1 = dict(part, dir=str(d / "part1"))
    lmp.start_from_reference(part1, d / "part1")
    resumed = dict(part, mesh=(4, 1), steps=10, params=True)
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [
        full, part, part1, resumed]}, 4, d)
    torch_mesh.same_on_every_rank([[r["hist"] for r in o] for o in outs])
    return outs[0], part1


def test_resume_on_another_mesh(runs):
    out, _ = runs
    full, part, _, resumed = out
    assert len(part["hist"]) == 5 and len(resumed["hist"]) == 5
    np.testing.assert_allclose(part["hist"], full["hist"][:5], rtol=1e-6)
    np.testing.assert_allclose(resumed["hist"], full["hist"][5:], rtol=1e-4)
    for a, b in zip(resumed["params"], full["params"]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_resume_on_one_rank(runs, tmp_path):
    out, part1 = runs
    assert ckpt.latest_step(part1["dir"]) == 5
    with torch_mesh.one_rank_group(tmp_path):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        arch, opt, data = torch_mesh.lm_setup(part1)
        state, hist = train(arch, opt, mesh, data, steps=10,
                            ckpt_dir=part1["dir"], log_every=1)
    np.testing.assert_allclose(hist, out[0]["hist"][5:], rtol=1e-4)
    for a, b in zip(flatten(state["params"])[1], out[0]["params"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-5)
    assert int(state["step"]) == 10

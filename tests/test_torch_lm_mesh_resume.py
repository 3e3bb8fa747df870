"""A sharded run resumed on another mesh continues the same run (elastic,
as ``tests/test_elastic_restore.py`` restores the reference's checkpoint
onto another mesh): reduced qwen1.5-0.5b, the AdamW run of
``tests/lm_mesh_parity.py``.  On four gloo ranks, 10 steps uninterrupted
on (2, 2); 5 steps on (2, 2) with a checkpoint, resumed on (4, 1), on
(2, 2) and on a 1-rank (1, 1) mesh in the pytest process, each to 10.
The (2, 2) runs compute tensor-parallel on ``model``, so their
checkpoints hold leaves the loop assembled from ``model`` blocks.

Contract (the loop's): the resumed runs' logged losses within rtol 1e-4
of the uninterrupted run's over steps 6-10, their final params within
rtol 2e-4 / atol 2e-5.  The checkpoints hold global leaves, so the
resumed mesh takes its own blocks of them.

The params of a run that changes mesh are held to the same run
uninterrupted across the change: 5 steps on (2, 2), then its state
carried in memory (no checkpoint) onto the new mesh for 5 more
(``torch_mesh.continue_run``).  Against the (2, 2) run's own steps 6-10
they part as far as the reference's own runs part between meshes: its
10-step AdamW runs on (2, 2) and (4, 1) differ by up to 7.3e-3 in 394
of the embedding's 65536 entries, since sum-order noise in near-zero
gradients flips AdamW's sign-like steps (measured).  A resume on (2, 2)
itself is held to the uninterrupted (2, 2) run.

An SGD-momentum run (its momentum restored onto the new mesh) resumed
on one rank is held to its uninterrupted (2, 2) twin as well.
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

TWIN = ((4, 1), "2d", 10)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    start = lambda run, name: lmp.start_from_reference(run, d / name)
    full = start(dict(lmp.ADAMW, mesh=(2, 2), params=True), "full")
    five = dict(lmp.ADAMW, mesh=(2, 2), steps=5, ckpt_every=5)
    part = start(dict(five, switch=TWIN, params=True), "part")
    part22 = start(five, "part22")
    part1 = start(dict(five, state=True), "part1")
    sgdm = dict(opt=("sgdm", {}))
    full_s = start(dict(full, **sgdm), "full_s")
    part_s = start(dict(five, **sgdm), "part_s")
    resumed = dict(part, mesh=(4, 1), steps=10, params=True, switch=None)
    resumed22 = dict(part22, steps=10, params=True)
    outs = torch_mesh.run_ranks({"name": "lm_train", "runs": [
        full, part, part22, part1, full_s, part_s, resumed, resumed22]},
        4, d)
    torch_mesh.same_on_every_rank([[r["hist"] for r in o] for o in outs])
    return dict(zip(["full", "part", "part22", "part1", "full_s", "part_s",
                     "resumed", "resumed22"], outs[0]), dirs={
        "part1": part1, "part_s": part_s})


def hold_resumed(got, hist, params, what):
    """The loop's contract: the losses of steps 6-10 (``hist``), the final
    params."""
    np.testing.assert_allclose(got["hist"], hist, rtol=1e-4,
                               err_msg=what)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                   err_msg=what)


def test_resume_on_another_mesh(runs):
    full, part, resumed = runs["full"], runs["part"], runs["resumed"]
    assert len(part["hist"]) == 10 and len(resumed["hist"]) == 5
    np.testing.assert_allclose(part["hist"][:5], full["hist"][:5],
                               rtol=1e-6)
    np.testing.assert_allclose(resumed["hist"], full["hist"][5:], rtol=1e-4)
    hold_resumed(resumed, part["hist"][5:], part["params"], "(4, 1)")


def test_resume_on_the_same_mesh(runs):
    full, part22 = runs["full"], runs["part22"]
    np.testing.assert_allclose(part22["hist"], full["hist"][:5], rtol=1e-6)
    hold_resumed(runs["resumed22"], full["hist"][5:], full["params"],
                 "(2, 2)")


def _one_rank(tmp_path, run, state=None):
    """``run`` resumed from its checkpoint on a 1-rank (1, 1) mesh to 10
    steps, or with ``state`` carried on from it in memory: the losses of
    steps 6-10 and the final params."""
    tmp_path.mkdir()
    with torch_mesh.one_rank_group(tmp_path):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        if state is not None:
            hist, st = torch_mesh.continue_run(run, mesh, state, 10)
        else:
            arch, opt, data = torch_mesh.lm_setup(run)
            st, hist = train(arch, opt, mesh, data, steps=10,
                             ckpt_dir=run["dir"], log_every=1)
    assert int(st["step"]) == 10
    return {"hist": hist, "params": [x.numpy() for x in
                                     flatten(st["params"])[1]]}


def test_resume_on_one_rank(runs, tmp_path):
    part1 = runs["dirs"]["part1"]
    assert ckpt.latest_step(part1["dir"]) == 5
    got = _one_rank(tmp_path / "resume", part1)
    np.testing.assert_allclose(got["hist"], runs["full"]["hist"][5:],
                               rtol=1e-4)
    state = torch_mesh._torch_tree(runs["part1"]["state"])
    twin = _one_rank(tmp_path / "twin", part1, state)
    hold_resumed(got, twin["hist"], twin["params"], "(1, 1)")


def test_resume_sgdm_on_one_rank(runs, tmp_path):
    part_s = runs["dirs"]["part_s"]
    assert ckpt.latest_step(part_s["dir"]) == 5
    got = _one_rank(tmp_path / "resume", part_s)
    full_s = runs["full_s"]
    hold_resumed(got, full_s["hist"][5:], full_s["params"], "sgdm (1, 1)")

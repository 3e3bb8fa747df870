"""The block layout of a Mamba ``in_proj`` (D, 2 din) on the ``model``
axis: the spec stays the reference's (columns on ``model``), but rank r's
block is the columns it computes on -- x block r followed by z block r --
cut and put back by ``parallel.zero.block`` / ``assemble``, the one place
every path goes through (the serving engine's draw and ``load_params``,
``train.step.block_tree`` / ``unblock_tree``, the checkpoint's restore by
shardings).

On (1, 2), (2, 2) and (1, 4) meshes of gloo ranks (``tests/torch_mesh.py``,
job ``mamba_layout``), on the reference's params of reduced zamba2-1.2b
(``convert.lm_params``): each rank's ``in_proj`` block equals those
columns of the global leaf, every other leaf's block is its contiguous
block, and assembling every rank's blocks gives the reference's global
leaves bit for bit.  Under ``"dp"`` nothing computes tensor-parallel:
falcon-mamba-7b widened to d_model 256 (``in_proj`` columns 1024, on
``("data", "model")``) on (2, 2) keeps each leaf's contiguous block and
assembles it bit for bit.  A checkpoint written by ``train(mesh=)`` on (1, 2)
(2 AdamW steps of reduced falcon-mamba-7b, job ``lm_train``) holds the
global leaves, and restores exactly on (2, 1) (two gloo ranks) and on
(1, 1) (one rank in this process).
"""
import numpy as np
import pytest

import lm_mesh_parity as lmp
import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro_torch.tree import flatten

MESHES = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def params():
    cases = lmp.tp_cases({"zamba2": ("zamba2-1.2b", {}, "layout")},
                         lambda cfg, kind, rng: {})
    return {k: v.numpy() for k, v in zip(*flatten(cases["zamba2"]
                                                  ["params"]))}


@pytest.fixture(scope="module")
def layouts(params, tmp_path_factory):
    return {shape: torch_mesh.run_ranks(
        {"name": "mamba_layout", "mesh": shape, "params": _tree(params)},
        shape[0] * shape[1], tmp_path_factory.mktemp("layout"))
        for shape in MESHES}


def _tree(params):
    tree = {}
    for key, x in params.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree


def _leaves(tree):
    return {k: np.asarray(v) for k, v in zip(*flatten(tree))}


@pytest.mark.parametrize("shape", MESHES)
def test_in_proj_block_is_the_rank_s_x_and_z_columns(params, layouts,
                                                     shape):
    w = params["layers/ssm/in_proj"]                    # (L, D, 2 din)
    din, m = w.shape[-1] // 2, shape[1]
    c = din // m
    for out in layouts[shape]:
        r = out["coord"]["model"]
        got = _leaves(out["blocks"])["layers/ssm/in_proj"]
        want = np.concatenate([w[..., r * c:(r + 1) * c],
                               w[..., din + r * c:din + (r + 1) * c]], -1)
        np.testing.assert_array_equal(got, want)
        # the rank's conv channels are the same channels
        conv = params["layers/ssm/conv_w"]
        np.testing.assert_array_equal(
            _leaves(out["blocks"])["layers/ssm/conv_w"],
            conv[:, r * c:(r + 1) * c])


@pytest.mark.parametrize("shape", MESHES)
def test_assembled_blocks_are_the_reference_s_leaves(params, layouts,
                                                     shape):
    for out in layouts[shape]:
        got = _leaves(out["assembled"])
        assert sorted(got) == sorted(params)
        for key, want in params.items():
            assert got[key].tobytes() == want.tobytes(), key


def test_dp_keeps_contiguous_blocks(tmp_path_factory):
    cases = lmp.tp_cases({"falcon": ("falcon-mamba-7b", {"d_model": 256},
                                     "layout")}, lambda cfg, kind, rng: {})
    params = {k: v.numpy() for k, v in zip(*flatten(cases["falcon"]
                                                    ["params"]))}
    outs = torch_mesh.run_ranks(
        {"name": "mamba_layout", "mesh": (2, 2), "strategy": "dp",
         "params": _tree(params)}, 4, tmp_path_factory.mktemp("dp"))
    w = params["layers/ssm/in_proj"]                    # (L, D, 2 din)
    assert w.shape[-1] == 1024
    c = w.shape[-1] // 4
    for out in outs:
        assert out["specs"]["layers/ssm/in_proj"] == [
            None, None, ["data", "model"]]
        r = 2 * out["coord"]["data"] + out["coord"]["model"]
        np.testing.assert_array_equal(
            _leaves(out["blocks"])["layers/ssm/in_proj"],
            w[..., r * c:(r + 1) * c])
        got = _leaves(out["assembled"])
        for key, want in params.items():
            assert got[key].tobytes() == want.tobytes(), key


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    run = dict(lmp.ADAMW, arch="falcon-mamba-7b", steps=2, ckpt_every=2,
               dir=str(d / "ckpt"), state=True)
    write = torch_mesh.run_ranks(
        {"name": "lm_train", "runs": [dict(run, mesh=(1, 2)),
                                      dict(run, mesh=(2, 1))]}, 2, d)
    with torch_mesh.one_rank_group(tmp_path_factory.mktemp("one")):
        one = torch_mesh.JOBS["lm_train"]({"runs": [dict(run,
                                                         mesh=(1, 1))]})
    return write[0], one[0]


def test_checkpoint_written_on_1x2_restores_exactly(checkpoint):
    (on_12, on_21), on_11 = checkpoint
    want = _leaves(on_12["state"])
    assert len(on_12["hist"]) == 2 and on_21["hist"] == [] == on_11["hist"]
    for name, got in (("(2, 1)", on_21), ("(1, 1)", on_11)):
        got = _leaves(got["state"])
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].tobytes() == want[key].tobytes(), (name, key)
    assert on_12["blocks"]["layers/ssm/in_proj"] == (2, 128, 256)
    assert on_21["blocks"]["layers/ssm/in_proj"] == (2, 128, 512)

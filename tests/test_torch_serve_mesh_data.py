"""``ServeEngine(arch, mesh)`` on meshes whose data axis holds two ranks,
where the reference's engine raises (ROADMAP queue 3): held to the port's
own unsharded engine.

Gloo ranks (``tests/torch_mesh.py``, job ``serve_mesh``) serve
reduced qwen1.5-0.5b, yi-6b (its cache's sequence on ``model``) and
granite-moe-1b-a400m on (2, 1) and (2, 2) meshes -- the two slots on the
batch axes, one per rank pair -- from the engine's own seeded draw (cut to
each rank's blocks as drawn), beside the unsharded engine of the same
seed on each rank; plus qwen at temperature 0.8 (every rank draws the
same Gumbel noise), and qwen at d_model 1024, whose weights' D
dimension is also sharded over ``data`` on (2, 2).  Held: the same tokens, and every step's logits
within rtol 1e-5 of their largest magnitude.  The layouts the engine
cannot serve raise: strategy ``"dp"``, Mamba-2 heads that do not divide
over ``model`` > 1, a batch that does not divide the batch axes, the VLM
family.  So do an
engine's blocks computed on outside its sharded compute
(``arch.forward(eng.params, ...)``) and, under tensor parallelism, a
weight that did not come through the layer gather.
"""
import dataclasses

import pytest

import torch_mesh
from lm_mesh_parity import tp_close as close
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config

MESHES = [(2, 1), (2, 2)]
CASES = {
    "qwen": ("qwen1.5-0.5b", {}),
    "yi": ("yi-6b", {}),
    "granite": ("granite-moe-1b-a400m", {}),
    "qwen_sampled": ("qwen1.5-0.5b", {"temperature": 0.8, "seed": 3}),
    "qwen_fsdp": ("qwen1.5-0.5b", {}),
}
#: d_model 1024: on (2, 2) the weights' D dimension is sharded over 'data'
OVER = {"qwen_fsdp": {"d_model": 1024}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = {name: {"cfg": dataclasses.replace(
        get_config(arch, reduced=True), **OVER.get(name, {})),
        "params": None, "unsharded": True, "kw": kw}
        for name, (arch, kw) in CASES.items()}
    qwen = get_config("qwen1.5-0.5b", reduced=True)
    refusals = {
        "dp": (qwen, {"batch_slots": 2}, "dp"),
        # one Mamba-2 head of 256 channels: its heads do not divide
        "ssm": (dataclasses.replace(get_config("zamba2-1.2b",
                                               reduced=True),
                                    ssm_head_dim=256),
                {"batch_slots": 2}, "2d"),
        "slots": (qwen, {"batch_slots": 3}, "2d"),
        "vlm": (get_config("qwen2-vl-72b", reduced=True),
                {"batch_slots": 2}, "2d"),
    }
    out = {}
    for shape in MESHES:
        out[shape] = torch_mesh.run_ranks(
            {"name": "serve_mesh", "mesh": shape, "cases": cases,
             "refusals": refusals}, shape[0] * shape[1],
            tmp_path_factory.mktemp("data"))
    return out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_holds_the_unsharded_one(results, shape, name):
    for rank, out in enumerate(results[shape]):
        got, want = out[name]["mesh"], out[name]["unsharded"]
        assert got["tokens"] == want["tokens"], rank
        assert len(got["steps"]) == len(want["steps"]) == 6
        for t, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            close(g, w, f"{name} rank {rank} step {t}")
        # the batch axes split the slots: the logits are assembled
        assert got["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("shape", MESHES)
def test_unservable_layouts_raise(results, shape):
    refusals = results[shape][0]["refusals"]
    assert "'2d'" in refusals["dp"]
    assert "frontend" in refusals["vlm"]
    assert "do not divide" in refusals["slots"]
    if shape == (2, 2):
        assert "Mamba" in refusals["ssm"]
    else:
        # model holds one rank: the SSM family is served on the data axis
        assert "ssm" not in refusals


@pytest.mark.parametrize("shape", MESHES)
def test_blocks_outside_their_layout_raise(results, shape):
    out = results[shape][0]
    # (2, 2) blocks every case's weights on 'model'; on (2, 1) only the
    # d_model 1024 qwen's are blocks (over 'data'), the others whole
    blocked = sorted(CASES) if shape == (2, 2) else ["qwen_fsdp"]
    for name in sorted(CASES):
        msg = out[name]["outside"]
        if name in blocked:
            assert msg is not None and "inside zero3 only" in msg, name
        else:
            assert msg is None, (name, msg)
    if shape == (2, 2):
        assert "did not come through gather_leaf" in out["unmarked"]
    else:
        assert out["unmarked"] is None

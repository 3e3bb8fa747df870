"""``ServeEngine(arch, mesh)`` for the SSM and hybrid families on a (2, 2)
mesh, where the reference's engine raises (ROADMAP queue 3): held to the
port's own unsharded engine.

Four gloo ranks (``tests/torch_mesh.py``, job ``serve_mesh``) serve
reduced falcon-mamba-7b and zamba2-1.2b -- the two slots on the data
axis, the Mamba channels (zamba2: heads) and the shared attention's heads
on ``model`` -- from the engine's own seeded draw (cut to each rank's
blocks as drawn), beside the unsharded engine of the same seed on each
rank.  Held: the same tokens, and every step's logits within rtol 1e-5 of
their largest magnitude (``lm_mesh_parity.TP_RTOL``).
"""
import pytest

import torch_mesh
from lm_mesh_parity import tp_close as close
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config

SHAPE = (2, 2)
ARCHS = {"falcon": "falcon-mamba-7b", "zamba2": "zamba2-1.2b"}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = {name: {"cfg": get_config(arch, reduced=True), "params": None,
                    "unsharded": True} for name, arch in ARCHS.items()}
    return torch_mesh.run_ranks({"name": "serve_mesh", "mesh": SHAPE,
                                 "cases": cases}, 4,
                                tmp_path_factory.mktemp("ssm"))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_engine_holds_the_unsharded_one(results, name):
    for rank, out in enumerate(results):
        got, want = out[name]["mesh"], out[name]["unsharded"]
        assert got["tokens"] == want["tokens"], rank
        assert len(got["steps"]) == len(want["steps"]) == 6
        for t, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            close(g, w, f"{name} rank {rank} step {t}")
        assert got["counts"]["all-reduce"] > 0
        assert out[name]["blocks"]["layers/ssm/in_proj"][-1] == 256

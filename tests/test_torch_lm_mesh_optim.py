"""Each optimizer's sharded update against its own unsharded update, on
four gloo ranks: AdamW, Adafactor and SGD with momentum over two steps of
random gradients, on a params tree whose leaves pass the rules' 1024 FSDP
floor (the embedding, a stacked MLP, an attention projection, norms, a
head), on (2, 2) under "2d" and "dp" and on (4, 1).  The blocks go through
``train.optim``'s ``shards=`` -- the global norm, Adafactor's row and
column statistics (whose own specs differ from their param's) and its
update RMS summed across ranks -- and are gathered back.

Contract: only the reductions' sum order differs, so the updates agree
within rtol 1e-6: optimizer states and metrics (``grad_norm``, ``lr``)
within rtol 1e-6; params within rtol 1e-6 plus :data:`ATOL` = 1e-6 of the
largest update (2 x the peak lr of 1e-2), for the elements that a step
brings near 0.
"""
import numpy as np
import pytest

import torch_mesh
from lm_train_parity import one_thread  # noqa: F401  (autouse)

MESHES = [((2, 2), "2d"), ((2, 2), "dp"), ((4, 1), "2d")]
OPTS = ("adamw", "adafactor", "sgdm")
ATOL = 1e-6 * 2 * 1e-2


def tree(rng, scale):
    """d_model 1024 (the FSDP floor) beside small other dims, so every
    matrix is cut over the batch axes and, under "2d", over 'model'."""
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"embed": {"embedding": f(64, 1024)},
            "layers": {"attn": {"wq": f(2, 1024, 4, 32)},
                       "ln1": {"scale": 1.0 + f(2, 1024)},
                       "mlp": {"wi_gate": f(2, 1024, 64),
                               "wo": f(2, 64, 1024)}},
            "final_norm": {"scale": 1.0 + f(1024)},
            "lm_head": {"kernel": f(1024, 64)}}


@pytest.fixture(scope="module")
def updates(tmp_path_factory):
    rng = np.random.default_rng(0)
    job = {"name": "optim", "meshes": MESHES, "params": tree(rng, 0.02),
           "grads": [tree(rng, 1e-3), tree(rng, 1e-3)]}
    outs = torch_mesh.run_ranks(job, 4, tmp_path_factory.mktemp("ranks"))
    return outs[0]


@pytest.mark.parametrize("name", OPTS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}-{m[1]}")
def test_sharded_update_equals_unsharded(updates, mesh, name):
    r = updates[(tuple(mesh[0]), mesh[1], name)]
    # the tree is really cut over the batch axes somewhere
    assert any(ax not in (None, "model") for sp in r["specs"] for ax in sp)
    assert len(r["full"]) == len(r["sharded"])
    for k, (a, b) in enumerate(zip(r["sharded"], r["full"])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=ATOL,
                                   err_msg=f"{name} {mesh} leaf {k}")
    for full, sharded in r["metrics"]:
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(sharded[key], full[key], rtol=1e-6)

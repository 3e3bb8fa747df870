"""Tensor parallelism on the ``model`` axis (``repro_torch.parallel.tp``)
module by module: each sharded function on (1, 2) and (2, 2) meshes of
gloo ranks (``tests/torch_mesh.py``, job ``tp_modules``) against the
port's unsharded function on the same weights -- the reference's params of
reduced configs (``convert.lm_params``), each rank holding its block of
every leaf under the rules' spec.

Modules: the vocab-parallel embedding and the embedding with D on
``model`` (vocab 511), the vocab-parallel head and tied unembedding, the
SwiGLU MLP (F columns / rows), a whole attention + MLP block of
qwen1.5-0.5b (KV heads on ``model``) and of yi-6b (1 KV head: ``head_dim``
on ``model``, K/V assembled), the MoE layer of granite-moe-1b-a400m (8
experts, 4 per rank) and its whole block.  Contract (float32): outputs,
the rank's block of every weight gradient and the input gradients within
rtol 1e-5 of each tensor's largest magnitude (the psums change the sum
order).  Also the four collectives' values and gradients, and their
all-reduce count.
"""
import numpy as np
import pytest
import torch

import lm_mesh_parity as lmp
from lm_mesh_parity import TP_MESHES as MESHES
from lm_mesh_parity import tp_close as close
from lm_train_parity import one_thread  # noqa: F401  (autouse)

#: case -> (arch, config overrides, kind)
CASES = {
    "embed_vocab": ("qwen1.5-0.5b", {}, "embed"),
    "embed_dmodel": ("qwen1.5-0.5b", {"vocab_size": 511}, "embed"),
    "lm_head": ("qwen1.5-0.5b", {}, "lm_head"),
    "lm_head_whole": ("qwen1.5-0.5b", {"vocab_size": 511}, "lm_head"),
    "unembed_vocab": ("qwen1.5-0.5b", {"tie_embeddings": True}, "unembed"),
    "unembed_dmodel": ("qwen1.5-0.5b", {"tie_embeddings": True,
                                        "vocab_size": 511}, "unembed"),
    "mlp": ("qwen1.5-0.5b", {}, "mlp"),
    "block_qwen": ("qwen1.5-0.5b", {}, "block"),
    "block_yi": ("yi-6b", {}, "block"),
    "moe_granite": ("granite-moe-1b-a400m", {}, "moe"),
    "block_granite": ("granite-moe-1b-a400m", {}, "block"),
}


def _inputs(cfg, kind, rng):
    if kind == "embed":
        return {"x": rng.integers(0, cfg.vocab_size, (2, 8)).astype(
            np.int64)}
    return {"x": rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return lmp.tp_run("tp_modules", lmp.tp_cases(CASES, _inputs),
                      tmp_path_factory)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_module_holds_the_unsharded_one(results, shape, name):
    for rank, out in enumerate(results[shape]):
        res = out[name]
        want, got = res["out"]
        assert got.shape == want.shape
        close(got, want, f"{name} rank {rank}: output")
        for key, (g_want, g_got) in res["grads"].items():
            assert g_got.shape == res["blocks"][key]
            close(g_got, g_want, f"{name} rank {rank}: grad {key}")
        for i, (g_want, g_got) in enumerate(res["arg_grads"]):
            close(g_got, g_want, f"{name} rank {rank}: input grad {i}")


@pytest.mark.parametrize("shape", MESHES)
def test_blocks_are_the_rank_s_model_block(results, shape):
    """Each rank holds half of every TP-sharded weight: the heads, KV
    heads or head_dim, F columns/rows, experts, vocab rows/columns."""
    out = results[shape][0]
    want = {("block_qwen", "attn/wq"): (128, 2, 32),
            ("block_qwen", "attn/wk"): (128, 2, 32),
            ("block_qwen", "attn/wo"): (2, 32, 128),
            ("block_yi", "attn/wq"): (128, 2, 32),
            ("block_yi", "attn/wk"): (128, 1, 16),
            ("mlp", "wi_gate"): (128, 128), ("mlp", "wo"): (128, 128),
            ("moe_granite", "wi_gate"): (4, 128, 256),
            ("moe_granite", "router"): (128, 4),
            ("embed_vocab", "embedding"): (256, 128),
            ("embed_dmodel", "embedding"): (511, 64),
            ("lm_head", "kernel"): (128, 256),
            ("lm_head_whole", "kernel"): (128, 511)}
    for (case, key), shape_ in want.items():
        assert out[case]["blocks"][key] == shape_, (case, key)


@pytest.mark.parametrize("shape", MESHES)
def test_collectives(results, shape):
    """psum (backward: identity), copy (backward: psum), assemble
    (backward: the rank's block) and split (backward: assembled) on two
    ranks, each one all-reduce each way where it has one."""
    outs = [o["collectives"] for o in results[shape]]
    base = np.arange(6.0).reshape(2, 3)
    for o in outs:
        r = o["index"]
        xr, cr = base + 10 * r, base * (r + 1)
        np.testing.assert_array_equal(o["psum"][0], 2 * base + 10)
        np.testing.assert_array_equal(o["psum"][1], cr)
        np.testing.assert_array_equal(o["copy"][0], xr)
        np.testing.assert_array_equal(o["copy"][1], 3 * base)
        np.testing.assert_array_equal(o["assemble"][0],
                                      np.concatenate([base, base + 10], 1))
        big = np.arange(12.0).reshape(2, 6)
        np.testing.assert_array_equal(o["assemble"][1],
                                      big[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(o["split"][0], xr[r:r + 1])
        g = np.stack([base[0], 2 * base[0]])
        np.testing.assert_array_equal(o["split"][1], g)
        # forward psum + assemble + split's backward + copy's backward
        assert o["counts"] == {"all-reduce": 4}


def test_a_block_outside_tensor_parallelism_raises():
    """A weight marked as the rank's ``model`` block is refused where no
    tensor-parallel axis is active: it would give one rank's partial
    sum."""
    from repro_torch.models import layers
    from repro_torch.parallel import act_sharding
    w = {"wi_gate": torch.ones(4, 8), "wi_up": torch.ones(4, 8),
         "wo": torch.ones(8, 4)}
    w["wi_gate"]._model_dim = 1
    with pytest.raises(ValueError, match="no tensor-parallel axis"):
        layers.mlp(w, torch.ones(1, 2, 4), torch.float32)
    w["wi_gate"]._model_dim = None
    assert layers.mlp(w, torch.ones(1, 2, 4), torch.float32).shape == \
        (1, 2, 4)

"""Tensor-parallel compute of whole models on the ``model`` axis: reduced
VLM and encoder-decoder configs on (1, 2) and (2, 2) meshes of gloo ranks
(``tests/torch_mesh.py``, job ``tp_models``) against the port's unsharded
model on the same weights (the reference's params through
``convert.lm_params``), each rank holding its block of every leaf.

* The serving engine's compute (``act_sharding.zero3(train=False)``):
  logits and the rank's block of every weight gradient, for qwen2-vl
  (M-RoPE) and seamless-m4t (encoder-decoder: both attentions on the
  rank's heads).
* A train step's compute (``train=True``): bfloat16-rounded layer weights
  and the residual carried between layers as the rank's sequence block
  (its recorded shape), logits against the unsharded forward on the same
  rounded weights.

The dense and MoE configs: ``tests/test_torch_lm_mesh_tp.py``; the SSM
and hybrid ones: ``tests/test_torch_lm_mesh_tp_ssm.py``.
Contract (float32): within rtol 1e-5 of each tensor's largest magnitude.
"""
import numpy as np
import pytest

import lm_mesh_parity as lmp
import lm_parity as lp
from lm_mesh_parity import TP_MESHES as MESHES
from lm_mesh_parity import tp_close as close
from lm_train_parity import one_thread  # noqa: F401  (autouse)

#: case -> (arch, config overrides, kind)
CASES = {
    "vlm": ("qwen2-vl-72b", {}, "forward"),
    "encdec": ("seamless-m4t-large-v2", {}, "forward"),
    "train_encdec": ("seamless-m4t-large-v2", {}, "train"),
}


def _inputs(cfg, kind, rng):
    if cfg.family == "encdec":
        return {"batch": {
            "src_embeds": rng.standard_normal((2, 6, cfg.d_model))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (2, 8))
            .astype(np.int32)}}
    return {"batch": lp.batch(cfg, 2, 8, seed=int(rng.integers(1 << 30)))}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return lmp.tp_run("tp_models", lmp.tp_cases(CASES, _inputs),
                      tmp_path_factory)


FORWARD = sorted(k for k, v in CASES.items() if v[2] == "forward")
TRAIN = sorted(k for k, v in CASES.items() if v[2] == "train")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", FORWARD)
def test_forward_and_gradients(results, shape, name):
    for rank, out in enumerate(results[shape]):
        want, got = out[name]["out"]
        close(got, want, f"{name} rank {rank}: logits")
        for key, (g_want, g_got) in out[name]["grads"].items():
            close(g_got, g_want, f"{name} rank {rank}: grad {key}")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", TRAIN)
def test_train_step_compute(results, shape, name):
    """Sequence-parallel residuals: the carry between layers is the
    rank's half of the 8 positions (of the encoder's 6)."""
    for rank, out in enumerate(results[shape]):
        want, got = out[name]["out"]
        close(got, want, f"{name} rank {rank}: logits")
        carries = out[name]["carries"]
        assert carries and all(c[1] in (3, 4) for c in carries), carries

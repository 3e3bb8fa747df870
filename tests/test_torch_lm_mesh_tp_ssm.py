"""Tensor-parallel compute of whole models on the ``model`` axis: reduced
SSM and hybrid configs on (1, 2) and (2, 2) meshes of gloo ranks
(``tests/torch_mesh.py``, job ``tp_models``) against the port's unsharded
model on the same weights (the reference's params through
``convert.lm_params``), each rank holding its block of every leaf.

* The serving engine's compute (``act_sharding.zero3(train=False)``):
  logits and the rank's block of every weight gradient, for falcon-mamba
  and zamba2 (their Mamba layers on the rank's channels and heads, each
  ``in_proj`` block the x and z columns of those channels; zamba2's
  shared attention on the rank's heads; the sums in another order reach
  the later layers' scans, whose gradients are held within rtol 1e-4:
  measured up to 2.3e-5 of the leaf's largest magnitude on ``A_log``
  while the Mamba layers were gathered whole).
* A train step's compute (``train=True``): bfloat16-rounded layer weights
  and the SSM residual carried whole between layers (``residual_ssm``:
  its recorded shape holds all 8 positions), logits against the
  unsharded forward on the same rounded weights.

The dense and MoE configs: ``tests/test_torch_lm_mesh_tp.py``.
Contract (float32): within rtol 1e-5 of each tensor's largest magnitude,
the scans' gradients as above.
"""
import pytest

import lm_mesh_parity as lmp
import lm_parity as lp
from lm_mesh_parity import TP_MESHES as MESHES
from lm_mesh_parity import tp_close as close
from lm_train_parity import one_thread  # noqa: F401  (autouse)

SCAN_RTOL = 1e-4
#: case -> (arch, config overrides, kind)
CASES = {
    "ssm": ("falcon-mamba-7b", {}, "forward"),
    "hybrid": ("zamba2-1.2b", {}, "forward"),
    "train_hybrid": ("zamba2-1.2b", {}, "train"),
}


def _inputs(cfg, kind, rng):
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
            close(g_got, g_want, f"{name} rank {rank}: grad {key}",
                  rtol=SCAN_RTOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", TRAIN)
def test_train_step_compute(results, shape, name):
    """SSM residuals: the carry between layers is the whole sequence of 8
    positions on every rank (the scan runs over it in order)."""
    for rank, out in enumerate(results[shape]):
        want, got = out[name]["out"]
        close(got, want, f"{name} rank {rank}: logits")
        carries = out[name]["carries"]
        assert carries and all(c[1] == 8 for c in carries), carries

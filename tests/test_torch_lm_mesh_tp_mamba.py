"""Tensor-parallel Mamba layers on the ``model`` axis, module by module:
each rank computes its block of the ``d_inner`` channels (Mamba-2: of the
heads) on (1, 2), (2, 2) and (1, 4) meshes of gloo ranks
(``tests/torch_mesh.py``, job ``tp_modules``), against the port's
unsharded layer on the same weights -- the reference's params of reduced
falcon-mamba-7b (Mamba-1) and zamba2-1.2b (Mamba-2, its ``ssd`` form and
the ``scan`` form), each rank holding its block of every leaf (its
``in_proj`` block the x and z columns it computes on).

For each layer: the forward of a sequence (training), a prefill of 8
tokens from a carried state (h0, conv0), and a one-token decode step from
one; and falcon-mamba at d_model 1024, whose Mamba weights' D dimension
is also sharded over ``data`` on (2, 2) (a prefill of 4 tokens).  Held: the output, the new ``h`` and ``conv`` (the rank's channel
blocks, assembled), the rank's block of every weight gradient --
``x_proj``'s (row-parallel, its r + 2n outputs a psum whose gradient is
summed once) and the whole ``B_proj`` / ``C_proj``'s included -- and the
gradients of the input and the initial state, within rtol 1e-5 of each
tensor's largest magnitude (``lm_mesh_parity.TP_RTOL``).  The
all-reduces: one psum of ``out_proj`` per layer (Mamba-1: also the psum of
``x_proj``).
"""
import numpy as np
import pytest

import lm_mesh_parity as lmp
from lm_mesh_parity import tp_close as close
from lm_train_parity import one_thread  # noqa: F401  (autouse)

MESHES = [(1, 2), (2, 2), (1, 4)]
#: case -> (arch, config overrides, kind, sequence, with a carried state)
LAYERS = {
    "mamba1": ("falcon-mamba-7b", {}),
    "mamba2_ssd": ("zamba2-1.2b", {}),
    "mamba2_scan": ("zamba2-1.2b", {"ssm_impl": "scan"}),
}
STEPS = {"forward": (8, False), "prefill": (8, True), "decode": (1, True)}
CASES = {f"{layer}_{step}": (arch, over, "mamba")
         for layer, (arch, over) in LAYERS.items() for step in STEPS}
#: d_model 1024: on (2, 2) the Mamba weights' D dimension is also sharded
#: over 'data' (the gather keeps the model block, x and z columns too)
CASES["mamba1_fsdp_prefill"] = ("falcon-mamba-7b", {"d_model": 1024},
                                "mamba")


def _inputs(cfg, kind, rng):
    return {}


def _state_inputs(cases):
    rng = np.random.default_rng(11)
    for name, c in cases.items():
        cfg = c["cfg"]
        s, state = STEPS[name.rsplit("_", 1)[1]]
        if "fsdp" in name:
            s = 4
        c["x"] = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        if not state:
            continue
        h = ((2, cfg.d_inner, cfg.ssm_state) if cfg.ssm_variant == "mamba1"
             else (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
        c["h0"] = rng.standard_normal(h).astype(np.float32)
        c["conv0"] = rng.standard_normal(
            (2, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)
    return cases


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = _state_inputs(lmp.tp_cases(CASES, _inputs))
    return lmp.tp_run("tp_modules", cases, tmp_path_factory, MESHES)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_mamba_layer_on_the_rank_s_channels(results, shape, name):
    for rank, out in enumerate(results[shape]):
        r = out[name]
        want, got = r["out"]
        close(got, want, f"{name} rank {rank}: output and state")
        for key, (g_want, g_got) in r["grads"].items():
            close(g_got, g_want, f"{name} rank {rank}: grad {key}")
        for i, (g_want, g_got) in enumerate(r["arg_grads"]):
            close(g_got, g_want, f"{name} rank {rank}: input grad {i}")
        mp, d = shape[1], (1024 if "fsdp" in name else 128)
        din = 2 * d                   # the reduced configs' d_inner
        dp = shape[0] if d >= 1024 else 1
        assert r["blocks"]["ssm/in_proj"] == (d // dp, 2 * din // mp)
        assert r["blocks"]["ssm/out_proj"][0] == din // mp
        if name.startswith("mamba1"):
            assert r["blocks"]["ssm/x_proj"][0] == din // mp
        else:
            assert r["blocks"]["ssm/B_proj"] == (128, 16)
            assert r["blocks"]["ssm/dt_proj"] == (128, 8 // mp)


@pytest.mark.parametrize("shape", MESHES)
def test_gradients_of_replicated_values_are_summed_once(results, shape):
    """``x_proj`` (Mamba-1) and ``B_proj`` / ``C_proj`` (Mamba-2) feed
    every rank's channels through replicated values: a gradient summed
    twice (or not at all) would be off by a factor of the ``model``
    size."""
    for out in results[shape]:
        for name, key in (("mamba1_prefill", "ssm/x_proj"),
                          ("mamba2_ssd_prefill", "ssm/B_proj"),
                          ("mamba2_scan_forward", "ssm/C_proj")):
            g_want, g_got = out[name]["grads"][key]
            ratio = np.abs(g_got).sum() / np.abs(g_want).sum()
            assert abs(ratio - 1) < 1e-4, (name, key, ratio)

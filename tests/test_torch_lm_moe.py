"""The MoE LMs of the port (granite-moe-1b-a400m, deepseek-moe-16b) and
``models.moe`` against the reference, at the reduced configs on the
reference's params (``tests/lm_parity.py``: rtol/atol 1e-4): forward,
prefill and three teacher-forced decode steps (deepseek-moe-16b also with
the int8 cache); ``moe_layer`` with capacity drops (the configs' factor
1.25, a router skewed toward one expert) and without (factor 8), the
stable top-k's ties, the capacity rule and the balancing loss."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.configs import get_config as j_get_config
from repro.models import moe as j_moe
from repro_torch.models import moe as t_moe

ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return lp.runs(request.param)


@pytest.fixture(scope="module")
def int8_run():
    return lp.runs("deepseek-moe-16b", kv_cache_dtype="int8")


@pytest.fixture(scope="module")
def no_drop_run():
    """The reference test's pin: no token capacity-dropped."""
    return lp.runs("granite-moe-1b-a400m", moe_capacity_factor=8.0)


def test_init_tree_is_the_reference_s(run):
    lp.check_init_tree(run[0])


def test_forward_logits(run):
    lp.check_forward(*run[1:])


def test_prefill_logits_and_caches(run):
    lp.check_prefill(*run[1:])


def test_teacher_forced_decode(run):
    lp.check_decode(*run[1:])


def test_decode_matches_forward_without_drops(no_drop_run):
    lp.check_decode_matches_forward(no_drop_run[2])


def test_int8_cache_prefill(int8_run):
    lp.check_prefill(*int8_run[1:])


def test_int8_cache_decode(int8_run):
    lp.check_decode(*int8_run[1:])


@pytest.fixture(scope="module")
def moe_pair():
    return lp.pair("deepseek-moe-16b")


def _layer(p, factor, skew):
    """The reduced deepseek-moe config at capacity ``factor``, its layer-0
    MoE params (shared expert included) with the router's column 0 raised
    by ``skew``, and inputs."""
    jcfg = dataclasses.replace(p.jcfg, moe_capacity_factor=factor)
    jm = jax.tree_util.tree_map(lambda a: a[0], p.jparams["layers"]["moe"])
    jm["router"] = jm["router"].at[:, 0].add(skew)
    x = np.random.default_rng(4).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    return jcfg, lp.port_config(jcfg), jm, x


def _drops(tcfg, tm, x):
    """Tokens routed past their expert's capacity, from the port's routing."""
    probs = torch.softmax(torch.as_tensor(x) @ tm["router"], dim=-1)
    _, top_e = t_moe.top_k(probs, tcfg.n_experts_per_token)
    b, s, k = top_e.shape
    flat = torch.nn.functional.one_hot(top_e, tcfg.n_experts).reshape(
        b, s * k, -1)
    return int((flat.cumsum(1) > t_moe.expert_capacity(tcfg, s)).logical_and(
        flat > 0).sum())


@pytest.mark.parametrize("factor,skew", [(1.25, 0.0), (1.25, 3.0),
                                         (8.0, 0.0)])
def test_moe_layer_matches_reference(moe_pair, factor, skew):
    jcfg, tcfg, jm, x = _layer(moe_pair, factor, skew)
    tm = lp.torch_tree(jm)
    want = np.asarray(j_moe.moe_layer(jm, jnp.asarray(x), jcfg, jnp.float32))
    got = t_moe.moe_layer(tm, torch.as_tensor(x), tcfg, torch.float32).numpy()
    lp.assert_close(got, want, "moe_layer")
    drops = _drops(tcfg, tm, x)
    if skew:
        assert drops > 0, "the skewed router must overflow an expert"
    if factor == 8.0:
        assert drops == 0


def test_top_k_ties_take_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.1, 0.3, 0.0]], np.float32)
    jv, je = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, te = t_moe.top_k(torch.as_tensor(probs), 3)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), [[1, 2, 4]])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("seq_len", [1, 7, 32, 4096])
def test_expert_capacity(seq_len):
    for arch in ARCHS:
        cfg = j_get_config(arch)
        assert t_moe.expert_capacity(lp.port_config(cfg), seq_len) == \
            j_moe.expert_capacity(cfg, seq_len)


def test_load_balancing_loss():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 9, 8)).astype(np.float32)
    top_e = rng.integers(0, 8, (2, 9, 2)).astype(np.int32)
    want = float(j_moe.load_balancing_loss(jnp.asarray(logits),
                                           jnp.asarray(top_e), 8))
    got = float(t_moe.load_balancing_loss(torch.as_tensor(logits),
                                          torch.as_tensor(top_e), 8))
    assert got == pytest.approx(want, rel=1e-6)

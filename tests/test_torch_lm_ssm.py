"""The attention-free LM of the port (falcon-mamba-7b, Mamba-1) and
``models.mamba``'s Mamba-1 against the reference, at the reduced config
on the reference's params (``tests/lm_parity.py``: rtol/atol 1e-4):
forward, prefill (SSM state and conv caches) and three teacher-forced
decode steps; ``mamba1_forward`` over several chunks from a given
``h0``/``conv0`` and ``mamba1_decode``.  The port scans each chunk step by
step where the reference runs an associative scan: the same recurrence
summed in another order (measured below 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.models import mamba as j_mamba
from repro_torch.models import mamba as t_mamba


@pytest.fixture(scope="module")
def run():
    return lp.runs("falcon-mamba-7b")


def test_init_tree_is_the_reference_s(run):
    lp.check_init_tree(run[0])


def test_forward_logits(run):
    lp.check_forward(*run[1:])


def test_prefill_logits_and_caches(run):
    lp.check_prefill(*run[1:])


def test_teacher_forced_decode(run):
    lp.check_decode(*run[1:])


def test_decode_matches_forward(run):
    lp.check_decode_matches_forward(run[2])


@pytest.fixture(scope="module")
def ssm_pair():
    return lp.pair("falcon-mamba-7b")


def _block(p, chunk):
    """The config at ``ssm_chunk`` and layer 1's Mamba-1 params."""
    jcfg = dataclasses.replace(p.jcfg, ssm_chunk=chunk)
    jb = jax.tree_util.tree_map(lambda a: a[1], p.jparams["layers"]["ssm"])
    return jcfg, lp.port_config(jcfg), jb, lp.torch_tree(jb)


def _state(cfg, b, seed=6):
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((b, cfg.d_inner, cfg.ssm_state)).astype(
        np.float32)
    conv0 = rng.standard_normal((b, cfg.ssm_conv - 1, cfg.d_inner)).astype(
        np.float32)
    return h0, conv0


@pytest.mark.parametrize("s,chunk,with_state", [(11, 4, True), (11, 4, False),
                                                (8, 128, True)])
def test_mamba1_forward_from_a_state(ssm_pair, s, chunk, with_state):
    jcfg, tcfg, jb, tb = _block(ssm_pair, chunk)
    x = np.random.default_rng(7).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    h0, conv0 = _state(jcfg, 2) if with_state else (None, None)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.as_tensor(a)
    want = j_mamba.mamba1_forward(jb, j(x), jcfg, jnp.float32, h0=j(h0),
                                  conv0=j(conv0), return_state=True)
    got = t_mamba.mamba1_forward(tb, t(x), tcfg, torch.float32, h0=t(h0),
                                 conv0=t(conv0), return_state=True)
    for g, w, what in zip(got, want, ("y", "h", "conv")):
        lp.assert_close(lp.np_(g), np.asarray(w), what)


def test_mamba1_decode(ssm_pair):
    jcfg, tcfg, jb, tb = _block(ssm_pair, 128)
    h0, conv0 = _state(jcfg, 3)
    x = np.random.default_rng(8).standard_normal(
        (3, 1, jcfg.d_model)).astype(np.float32)
    want = j_mamba.mamba1_decode(jb, jnp.asarray(x), jcfg, jnp.float32,
                                 jnp.asarray(h0), jnp.asarray(conv0))
    got = t_mamba.mamba1_decode(tb, torch.as_tensor(x), tcfg,
                                torch.float32, torch.as_tensor(h0),
                                torch.as_tensor(conv0))
    for g, w, what in zip(got, want, ("y", "h", "conv")):
        lp.assert_close(lp.np_(g), np.asarray(w), what)


@pytest.mark.parametrize("s", [1, 3, 9])
def test_causal_conv(s):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = j_mamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    got = t_mamba._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                               torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

"""The hybrid LM of the port (zamba2-1.2b: Mamba-2 blocks with a shared
attention block on concat([x, x0]) after every group, the SSD dual form)
and ``models.mamba``'s Mamba-2 against the reference, at the reduced
config on the reference's params (``tests/lm_parity.py``: rtol/atol
1e-4): forward, prefill (SSM state, conv and the shared block's K/V
caches) and three teacher-forced decode steps; ``mamba2_forward`` on the
scan path and on the SSD path, each held to the reference's same path,
from a given ``h0``/``conv0``, and ``mamba2_decode``.  The reference's run
is shared by the module's tests (~20 s)."""
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
    return lp.runs("zamba2-1.2b")


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


def test_caches_hold_every_group(run):
    cfg = run[0].tcfg
    caches = run[2]["prefill_cache"]
    groups = -(-cfg.n_layers // cfg.hybrid_attn_every)
    assert caches["k"].shape[0] == groups and caches["h"].shape[0] == \
        cfg.n_layers
    assert np.abs(caches["k"]).sum(axis=(1, 2, 3, 4)).min() > 0


@pytest.fixture(scope="module")
def hybrid_pair():
    return lp.pair("zamba2-1.2b")


def _block(p, impl, chunk):
    """The config at ``ssm_impl``/``ssm_chunk`` and layer 0's Mamba-2
    params."""
    jcfg = dataclasses.replace(p.jcfg, ssm_impl=impl, ssm_chunk=chunk)
    jb = jax.tree_util.tree_map(lambda a: a[0], p.jparams["layers"]["ssm"])
    return jcfg, lp.port_config(jcfg), jb, lp.torch_tree(jb)


def _state(cfg, b, seed=6):
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((b, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state)).astype(np.float32)
    conv0 = rng.standard_normal((b, cfg.ssm_conv - 1, cfg.d_inner)).astype(
        np.float32)
    return h0, conv0


@pytest.mark.parametrize("impl", ["scan", "ssd"])
@pytest.mark.parametrize("s,chunk,with_state", [(13, 4, True), (13, 4, False),
                                                (6, 64, True)])
def test_mamba2_forward(hybrid_pair, impl, s, chunk, with_state):
    jcfg, tcfg, jb, tb = _block(hybrid_pair, impl, chunk)
    x = np.random.default_rng(7).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    h0, conv0 = _state(jcfg, 2) if with_state else (None, None)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.as_tensor(a)
    want = j_mamba.mamba2_forward(jb, j(x), jcfg, jnp.float32, h0=j(h0),
                                  conv0=j(conv0), return_state=True)
    got = t_mamba.mamba2_forward(tb, t(x), tcfg, torch.float32, h0=t(h0),
                                 conv0=t(conv0), return_state=True)
    for g, w, what in zip(got, want, ("y", "h", "conv")):
        lp.assert_close(lp.np_(g), np.asarray(w), what)


def test_ssd_dual_form(hybrid_pair):
    cfg = hybrid_pair.jcfg
    rng = np.random.default_rng(10)
    b, S, H, P, n = 2, 11, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    dt = np.abs(rng.standard_normal((b, S, H))).astype(np.float32) * 0.1
    Bm = rng.standard_normal((b, S, n)).astype(np.float32)
    Cm = rng.standard_normal((b, S, n)).astype(np.float32)
    xh = rng.standard_normal((b, S, H, P)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    h0 = rng.standard_normal((b, H, P, n)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    args = (dt, Bm, Cm, xh, A, h0)
    want = j_mamba._mamba2_ssd_chunks(*map(jnp.asarray, args), 4, S,
                                      jnp.asarray(D))
    got = t_mamba._mamba2_ssd_chunks(*map(torch.as_tensor, args), 4, S,
                                     torch.as_tensor(D))
    for g, w in zip(got, want):
        lp.assert_close(g.numpy(), np.asarray(w), "ssd")


@pytest.mark.parametrize("impl", ["scan", "ssd"])
def test_mamba2_decode(hybrid_pair, impl):
    jcfg, tcfg, jb, tb = _block(hybrid_pair, impl, 64)
    h0, conv0 = _state(jcfg, 3)
    x = np.random.default_rng(8).standard_normal(
        (3, 1, jcfg.d_model)).astype(np.float32)
    want = j_mamba.mamba2_decode(jb, jnp.asarray(x), jcfg, jnp.float32,
                                 jnp.asarray(h0), jnp.asarray(conv0))
    got = t_mamba.mamba2_decode(tb, torch.as_tensor(x), tcfg,
                                torch.float32, torch.as_tensor(h0),
                                torch.as_tensor(conv0))
    for g, w, what in zip(got, want, ("y", "h", "conv")):
        lp.assert_close(lp.np_(g), np.asarray(w), what)

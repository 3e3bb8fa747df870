"""The encoder-decoder family (seamless-m4t-large-v2, ``models.encdec``)
of the port against the reference's model functions, at the reduced
config on the reference's own params (``tests/lm_parity.py``): the init
tree, forward logits over stub ``src_embeds``, prefill's last logits and
its caches (self ``k``/``v`` and cross ``xk``/``xv``), three
teacher-forced decode steps with their caches, and the reference test's
own check that decode matches the teacher-forced forward.  Also
``make_arch``'s ``init_cache`` with and without ``enc_len``, a source
longer than the flash chunks, and ``convert.lm_params`` on the tree.

Tolerances: ``lm_parity``'s rtol/atol 1e-4 on logits and caches; decode
against forward 2e-2 (the reference test's).
"""
import jax
import numpy as np
import pytest
import torch

from lm_train_parity import one_thread  # noqa: F401  (autouse)
import lm_parity as lp
from repro_torch import convert

ARCH = "seamless-m4t-large-v2"
B, S_SRC = 2, 10
S_PROMPT, N_EXTRA = lp.S_PROMPT, lp.N_EXTRA


def encdec_batch(cfg, s_src=S_SRC, seed=1):
    rng = np.random.default_rng(seed)
    bt = lp.batch(cfg, B, S_PROMPT + N_EXTRA, seed)
    bt["src_embeds"] = rng.standard_normal((B, s_src, cfg.d_model)) \
        .astype(np.float32)
    return bt


def teacher_forced(arch, params, bt, side):
    conv = lp.to_jax if side == "ref" else lp.to_torch
    forward, prefill, decode = arch.forward, arch.prefill, arch.decode_step
    if side == "ref":
        forward, decode = jax.jit(forward), jax.jit(decode)
        prefill = jax.jit(prefill, static_argnums=2)
    total = S_PROMPT + N_EXTRA
    out = {"forward": lp.np_(forward(params, conv(bt)))}
    prompt = {"src_embeds": bt["src_embeds"],
              "tokens": bt["tokens"][:, :S_PROMPT]}
    last, caches = prefill(params, conv(prompt), total)
    out["prefill"] = lp.np_(last)
    out["prefill_cache"] = lp.np_tree(caches)
    out["decode"], out["decode_cache"] = [], []
    for j in range(N_EXTRA):
        pos = S_PROMPT + j
        logits, caches = decode(
            params, conv({"tokens": bt["tokens"][:, pos:pos + 1]}), caches,
            pos)
        out["decode"].append(lp.np_(logits))
        out["decode_cache"].append(lp.np_tree(caches))
    return out


@pytest.fixture(scope="module")
def run():
    p = lp.pair(ARCH)
    bt = encdec_batch(p.jcfg)
    return (p, teacher_forced(p.ja, p.jparams, bt, "ref"),
            teacher_forced(p.ta, p.tparams, bt, "port"))


def test_init_tree_is_the_reference_s(run):
    lp.check_init_tree(run[0])


def test_forward_logits(run):
    lp.check_forward(*run[1:])


def test_prefill_logits_and_caches(run):
    _, ref, port = run
    assert set(port["prefill_cache"]) == {"k", "v", "xk", "xv"}
    lp.check_prefill(ref, port)


def test_teacher_forced_decode(run):
    lp.check_decode(*run[1:])


def test_decode_matches_forward(run):
    lp.check_decode_matches_forward(run[2])


def test_init_cache_shapes(run):
    p = run[0]
    want = lp.np_tree(p.ja.init_cache(2, 8, 5))
    got = lp.np_tree(p.ta.init_cache(2, 8, 5, device="cpu"))
    assert lp.tree_signature(got) == lp.tree_signature(want)
    assert lp.tree_signature(lp.np_tree(p.ta.init_cache(2, 8))) == \
        lp.tree_signature(lp.np_tree(p.ja.init_cache(2, 8)))


def test_long_source_over_several_chunks():
    """A source and a target longer than the flash chunks (padded q rows
    and kv, non-causal cross-attention over several kv blocks)."""
    p = lp.pair(ARCH, attn_chunk_q=4, attn_chunk_kv=8)
    bt = encdec_batch(p.jcfg, s_src=21, seed=3)
    ref = jax.jit(p.ja.forward)(p.jparams, lp.to_jax(bt))
    got = p.ta.forward(p.tparams, lp.to_torch(bt))
    lp.assert_close(lp.np_(got), np.asarray(ref), "forward, long source")


def test_lm_params_refuses_a_decoder_only_tree(run):
    p = run[0]
    dense = lp.pair("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="not a"):
        convert.lm_params(lp.np_tree(dense.jparams), p.tcfg, "cpu")
    meta = p.ta.init(torch.Generator(), device="meta")
    assert all(x.device.type == "meta"
               for x in jax.tree_util.tree_leaves(meta))

"""The LM building blocks of the port against the reference, module by
module: ``models.layers`` (rmsnorm, RoPE, SwiGLU, embeddings, heads),
``models.attention`` (naive, grouped decode attention with GQA), the
forward of ``models.flash`` at ragged lengths, with GQA and with
``q_offset``, the int8 KV quantizer, ``models.config`` and every config
file, ``models.registry`` and ``convert.lm_params``/``lm_cache``.

Tolerances: float32 throughout; flash and attention rtol/atol 1e-5 (the
same blocks summed in the same order, ulps of exp), elementwise ops
1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro import configs as j_configs
from repro.models import attention as j_attn
from repro.models import flash as j_flash
from repro.models import layers as j_layers
from repro.models import registry as j_registry
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.models import attention as t_attn
from repro_torch.models import flash as t_flash
from repro_torch.models import layers as t_layers
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_tf

RNG = np.random.default_rng(12)


def f32(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(lp.np_(got), np.asarray(want), rtol=tol,
                               atol=tol)


J, T = jnp.asarray, torch.as_tensor


# -- config files and the registry ------------------------------------------
def test_arch_ids_are_the_reference_s():
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    assert t_configs.LM_ARCH_IDS == j_configs.LM_ARCH_IDS
    assert len(t_configs.LM_ARCH_IDS) == 10


@pytest.mark.parametrize("arch_id", j_configs.LM_ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_reference_s(arch_id, reduced):
    want = j_configs.get_config(arch_id, reduced=reduced)
    got = t_configs.get_config(arch_id, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.d_inner, got.ssm_heads, got.is_attention_free,
            got.supports_long_context) == (
        want.d_inner, want.ssm_heads, want.is_attention_free,
        want.supports_long_context)


def test_crrm_ppp_has_no_lm_config():
    assert t_configs.get_config("crrm-ppp") is None
    assert t_configs.get_config("crrm-ppp", reduced=True) is None


@pytest.mark.parametrize("arch_id", j_configs.LM_ARCH_IDS)
def test_shape_applicability_is_the_reference_s(arch_id):
    cfg = j_configs.get_config(arch_id)
    assert t_registry.SHAPES == j_registry.SHAPES
    for shape in j_registry.SHAPES:
        assert t_registry.shape_applicable(
            t_configs.get_config(arch_id), shape) == \
            j_registry.shape_applicable(cfg, shape)


def test_encdec_waits_for_its_slice():
    cfg = t_configs.get_config("seamless-m4t-large-v2", reduced=True)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        t_registry.make_arch(cfg)


# -- layers --------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x, scale = f32(2, 5, 64, scale=3.0), f32(64)
    got = t_layers.rmsnorm({"scale": T(scale)},
                           T(x).to(t_layers._dtype(dtype)), 1e-6)
    want = j_layers.rmsnorm({"scale": J(scale)},
                            J(x).astype(j_layers._dtype(dtype)), 1e-6)
    assert str(got.dtype).endswith(dtype)
    close(got.float(), np.asarray(want, np.float32),
          1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    x = f32(2, 7, 3, 32)
    pos = RNG.integers(0, 4000, (2, 7)).astype(np.int32)
    close(t_layers.apply_rope(T(x), T(pos), theta),
          j_layers.apply_rope(J(x), J(pos), theta), 1e-4)
    close(t_layers.rope_freqs(32, theta), j_layers.rope_freqs(32, theta),
          1e-6)


def test_mlp_embed_and_heads():
    x = f32(2, 5, 16)
    p = {"wi_gate": f32(16, 40), "wi_up": f32(16, 40), "wo": f32(40, 16)}
    close(t_layers.mlp(lp.torch_tree(p), T(x), torch.float32),
          j_layers.mlp(jax.tree_util.tree_map(J, p), J(x), jnp.float32))
    emb = f32(50, 16)
    tok = RNG.integers(0, 50, (2, 5)).astype(np.int32)
    close(t_layers.embed({"embedding": T(emb)}, T(tok), torch.float32),
          j_layers.embed({"embedding": J(emb)}, J(tok), jnp.float32))
    close(t_layers.unembed({"embedding": T(emb)}, T(x)),
          j_layers.unembed({"embedding": J(emb)}, J(x)))
    k = f32(16, 50)
    close(t_layers.lm_head({"kernel": T(k)}, T(x)),
          j_layers.lm_head({"kernel": J(k)}, J(x)))


def test_dense_init_is_truncated_at_two_std():
    gen = torch.Generator("cpu").manual_seed(0)
    w = t_layers.dense_init(gen, (256, 512), 256)
    std = 1.0 / 16.0
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert float(w.std()) == pytest.approx(0.88 * std, rel=0.02)
    again = t_layers.dense_init(torch.Generator("cpu").manual_seed(0),
                                (256, 512), 256)
    assert torch.equal(w, again)


# -- attention --------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [4, 2, 1])
def test_naive_attention(causal, kv_heads):
    q, k, v = f32(2, 6, 4, 8), f32(2, 6, kv_heads, 8), f32(2, 6, kv_heads, 8)
    close(t_attn.naive_attention(T(q), T(k), T(v), causal=causal),
          j_attn.naive_attention(J(q), J(k), J(v), causal=causal))


@pytest.mark.parametrize("kv_heads,cache_len", [(2, 7), (8, 1), (1, 10),
                                                (4, 10)])
def test_decode_attention_grouped(kv_heads, cache_len):
    q = f32(2, 1, 8, 16)
    kc, vc = f32(2, 10, kv_heads, 16), f32(2, 10, kv_heads, 16)
    close(t_attn.decode_attention(T(q), T(kc), T(vc), cache_len),
          j_attn.decode_attention(J(q), J(kc), J(vc), cache_len))


def test_qkv_project_with_bias_and_output():
    cfg = lp.pair("qwen1.5-0.5b").jcfg
    p = {"wq": f32(128, 4, 32), "wk": f32(128, 4, 32), "wv": f32(128, 4, 32),
         "wo": f32(4, 32, 128), "bq": f32(4, 32), "bk": f32(4, 32),
         "bv": f32(4, 32)}
    x = f32(2, 3, 128)
    jp, tp = jax.tree_util.tree_map(J, p), lp.torch_tree(p)
    for g, w in zip(t_attn.qkv_project(tp, T(x), T(x), cfg, torch.float32),
                    j_attn.qkv_project(jp, J(x), J(x), cfg, jnp.float32)):
        close(g, w, 1e-4)
    ctx = f32(2, 3, 4, 32)
    close(t_attn.attn_output(tp, T(ctx), torch.float32),
          j_attn.attn_output(jp, J(ctx), jnp.float32), 1e-4)


# -- flash ---------------------------------------------------------------------
@pytest.mark.parametrize("sq,skv,cq,ckv,q_offset,causal,kv_heads", [
    (13, 13, 4, 5, 0, True, 4),      # ragged: both padded
    (16, 16, 16, 16, 0, True, 4),    # one block
    (5, 12, 2, 5, 7, True, 4),       # decode-like block with an offset
    (9, 9, 4, 4, 0, True, 2),        # GQA repeat
    (7, 11, 3, 4, 0, False, 1),      # non-causal, MQA
    (1, 10, 512, 1024, 9, True, 2),  # one query at the end of the keys
])
def test_flash_forward(sq, skv, cq, ckv, q_offset, causal, kv_heads):
    q = f32(2, sq, 4, 8)
    k, v = f32(2, skv, kv_heads, 8), f32(2, skv, kv_heads, 8)
    kw = dict(causal=causal, chunk_q=cq, chunk_kv=ckv, q_offset=q_offset)
    got = t_flash.flash_attention(T(q), T(k), T(v), **kw)
    close(got, j_flash.flash_attention(J(q), J(k), J(v), **kw))
    close(t_attn.chunked_attention(T(q), T(k), T(v), **kw),
          j_attn.chunked_attention(J(q), J(k), J(v), **kw))
    assert got.shape == q.shape


def test_flash_masks_the_padded_keys():
    """A non-causal call whose last KV block holds one key and three
    padded ones: ``kv_valid`` masks the padding."""
    q, k, v = f32(1, 3, 2, 8), f32(1, 5, 2, 8), f32(1, 5, 2, 8)
    kw = dict(causal=False, chunk_q=3, chunk_kv=4)
    close(t_flash.flash_attention(T(q), T(k), T(v), **kw),
          j_flash.flash_attention(J(q), J(k), J(v), **kw))


# -- the int8 cache quantizer -------------------------------------------------
def test_quantize_kv():
    x = f32(2, 5, 4, 32, scale=3.0)
    tq, ts = t_tf._quantize_kv(T(x))
    jq, js = j_tf._quantize_kv(J(x))
    assert tq.dtype == torch.int8
    lp.assert_int8_cache(tq.numpy(), np.asarray(jq), "quantize")
    close(ts, js, 1e-6)
    close(t_tf._dequantize_kv(tq, ts, torch.float32),
          j_tf._dequantize_kv(jq, js, jnp.float32), 1e-5)


# -- convert ---------------------------------------------------------------------
def test_lm_params_refuses_a_foreign_tree():
    p = lp.pair("qwen1.5-0.5b")
    tree = lp.np_tree(p.jparams)
    with pytest.raises(ValueError, match="lm_head/kernel"):
        convert.lm_params({k: v for k, v in tree.items() if k != "lm_head"},
                          p.tcfg, "cpu")
    short = dataclasses.replace(p.tcfg, n_layers=3)
    with pytest.raises(ValueError, match="shapes differ at .*layers/attn"):
        convert.lm_params(tree, short, "cpu")


def test_lm_cache_keeps_dtypes():
    p = lp.pair("yi-6b", kv_cache_dtype="int8")
    cache = lp.np_tree(p.ja.init_cache(2, 8))
    got = convert.lm_cache(cache, "cpu")
    assert got["k"].dtype == torch.int8 and got["k_scale"].dtype == \
        torch.float32
    bf = {"h": np.zeros((1, 2), jnp.bfloat16), "conv": np.ones((1, 2),
                                                               jnp.bfloat16)}
    got = convert.lm_cache(bf, "cpu")
    assert got["conv"].dtype == torch.bfloat16
    assert float(got["conv"].float().sum()) == 2.0
    with pytest.raises(ValueError, match="not an LM cache"):
        convert.lm_cache({"x": np.zeros(1)}, "cpu")

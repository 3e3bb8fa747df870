"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``,
``tests/test_torch_serve.py``): one reduced architecture in both packages
on the same weights, and its reference run, computed once per module.

The reference's params come from its own ``init(PRNGKey(0))`` and reach
the port through ``convert.lm_params``; inputs are drawn with numpy.

Contract (float32, the reduced configs' dtype): logits and float caches
within rtol 1e-4, atol 1e-4 (the logits are O(1): sum order of the
matmuls and ulps of exp/rsqrt; measured up to ~1e-5 on zamba2, whose
chunked SSM sums in another order); int8 caches exact off rounding
midpoints (:func:`assert_int8_cache`).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models.registry import make_arch as j_make_arch
from repro_torch import convert
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import make_arch as t_make_arch

DEV = torch.device("cpu")
RTOL = ATOL = 1e-4
S_PROMPT, N_EXTRA = 6, 3          # the reference's teacher-forced test


def np_(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        # a copy: the port writes its caches in place
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np_(tree)


def torch_tree(tree):
    """A reference (sub)tree as CPU tensors of the same dtypes."""
    return {k: (torch_tree(v) if isinstance(v, dict)
                else torch.as_tensor(np.array(v)))
            for k, v in tree.items()}


@dataclasses.dataclass
class Pair:
    """One config in both packages, and the reference's params in both."""
    jcfg: object
    tcfg: ModelConfig
    ja: object
    ta: object
    jparams: dict
    tparams: dict


def port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def pair(arch_id: str, seed: int = 0, **over) -> Pair:
    jcfg = dataclasses.replace(j_get_config(arch_id, reduced=True), **over)
    tcfg = port_config(jcfg)
    ja, ta = j_make_arch(jcfg), t_make_arch(tcfg)
    jparams = ja.init(jax.random.PRNGKey(seed))
    tparams = convert.lm_params(np_tree(jparams), tcfg, DEV)
    return Pair(jcfg, tcfg, ja, ta, jparams, tparams)


def batch(cfg, b: int, s: int, seed: int = 1) -> dict:
    """numpy inputs: tokens, or for the VLM patch embeddings and (t, h, w)
    M-RoPE ids whose three components differ."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        t = np.arange(s)
        pos = np.stack([t, t // 2, t % 3])[:, None].repeat(b, axis=1)
        return {"embeds": rng.standard_normal((b, s, cfg.d_model))
                .astype(np.float32), "positions": pos.astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
            .astype(np.int32)}


def cut(bt: dict, a: int, b: int) -> dict:
    """Positions a..b of a numpy batch."""
    return {k: (v[:, :, a:b] if k == "positions" else v[:, a:b])
            for k, v in bt.items()}


def to_jax(bt):
    return {k: jnp.asarray(v) for k, v in bt.items()}


def to_torch(bt):
    return {k: torch.as_tensor(v) for k, v in bt.items()}


def teacher_forced(arch, params, bt, side: str, b_prompt: int = S_PROMPT,
                   n_extra: int = N_EXTRA) -> dict:
    """forward over the whole batch, prefill of its first ``b_prompt``
    positions, then ``n_extra`` decode steps fed the batch's own next
    inputs: logits and caches (numpy) of every stage."""
    conv = to_jax if side == "ref" else to_torch
    forward, prefill, decode = arch.forward, arch.prefill, arch.decode_step
    if side == "ref":       # compiled, as the reference's engine runs decode
        forward, decode = jax.jit(forward), jax.jit(decode)
        prefill = jax.jit(prefill, static_argnums=2)
    total = b_prompt + n_extra
    out = {"forward": np_(forward(params, conv(bt)))}
    last, caches = prefill(params, conv(cut(bt, 0, b_prompt)), total)
    out["prefill"] = np_(last)
    out["prefill_cache"] = np_tree(caches)
    out["decode"], out["decode_cache"] = [], []
    for j in range(n_extra):
        pos = b_prompt + j
        logits, caches = decode(params, conv(cut(bt, pos, pos + 1)), caches,
                                pos)
        out["decode"].append(np_(logits))
        out["decode_cache"].append(np_tree(caches))
    return out


def runs(arch_id: str, b: int = 2, s: int = S_PROMPT + N_EXTRA, **over):
    """(pair, reference run, port run) of :func:`teacher_forced`."""
    p = pair(arch_id, **over)
    bt = batch(p.jcfg, b, s)
    return (p, teacher_forced(p.ja, p.jparams, bt, "ref"),
            teacher_forced(p.ta, p.tparams, bt, "port"))


def assert_close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def assert_int8_cache(got_q, want_q, what=""):
    """int8 cache values exact off rounding midpoints: a value whose
    ``x / scale`` sits at a midpoint in float32 rounding may round the
    other way, so values may be 1 apart, in under 0.1 % of the entries."""
    d = np.abs(got_q.astype(np.int32) - want_q.astype(np.int32))
    assert d.max() <= 1, f"{what}: int8 values {d.max()} apart"
    assert (d > 0).mean() < 1e-3, f"{what}: {(d > 0).sum()} values differ"


def assert_caches(got: dict, want: dict, what=""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert got[k].shape == want[k].shape, (k, got[k].shape)
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype)
        if want[k].dtype == np.int8:
            assert_int8_cache(got[k], want[k], what=f"{what} {k}")
        else:
            assert_close(got[k], want[k], f"{what} {k}")


def tree_signature(tree: dict) -> dict:
    """{key path: (shape, dtype name)} of a numpy tree."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}")
        else:
            out[prefix] = (tuple(t.shape), np_(t).dtype.name)
    walk(tree, "")
    return out


# -- the per-architecture checks each family's test file runs ----------------
def check_init_tree(p: Pair):
    """The port's own init has the reference's keys, shapes and dtypes,
    and the same parameter count."""
    from repro_torch.models import transformer
    gen = torch.Generator(DEV).manual_seed(0)
    mine = tree_signature(np_tree(p.ta.init(gen)))
    assert mine == tree_signature(np_tree(p.jparams))
    assert transformer.param_count(p.tparams) == sum(
        int(x.size) for x in jax.tree_util.tree_leaves(p.jparams))


def check_forward(ref: dict, port: dict):
    assert port["forward"].dtype == np.float32
    assert_close(port["forward"], ref["forward"], "forward logits")


def check_prefill(ref: dict, port: dict):
    assert_close(port["prefill"], ref["prefill"], "prefill logits")
    assert_caches(port["prefill_cache"], ref["prefill_cache"], "prefill")


def check_decode(ref: dict, port: dict):
    for j, (g, w) in enumerate(zip(port["decode"], ref["decode"])):
        assert_close(g, w, f"decode step {j} logits")
    for j, (g, w) in enumerate(zip(port["decode_cache"],
                                   ref["decode_cache"])):
        assert_caches(g, w, f"decode step {j}")


def check_decode_matches_forward(port: dict):
    """The reference test's own check on the port: teacher-forced decode
    logits equal the full forward's at each position (rtol/atol 2e-2, the
    reference test's tolerance; MoE configs pin no drops)."""
    fwd = port["forward"]
    np.testing.assert_allclose(port["prefill"][:, 0], fwd[:, S_PROMPT - 1],
                               rtol=2e-2, atol=2e-2)
    for j, g in enumerate(port["decode"]):
        np.testing.assert_allclose(g[:, 0], fwd[:, S_PROMPT + j],
                                   rtol=2e-2, atol=2e-2)

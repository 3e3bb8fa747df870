"""Shared helpers of the LM training parity tests
(``tests/test_torch_lm_train_step*.py``, ``tests/test_torch_lm_train_{accum,
state}.py``, ``tests/test_torch_lm_flash_grad*.py``): one reduced config
per family in both packages on the reference's params
(``tests/lm_parity.py``), a batch with labels, the holds, and flash's
gradient cases.

Tolerances (float32): loss and metrics rtol 1e-5; gradients within 1e-4
of their leaf's max |g| (the matmuls' sum order; the SSM's chunked scan
sums in another order, PR 19); params after an AdamW or Adafactor step
within 1e-6 off sign flips where the reference gradient is within the
gradient tolerance of 0 (``lm_train_fixture.hold_params``, under 1e-3 of
the elements: both steps are sign-like at a near-zero gradient, an
unfactored Adafactor leaf's step being g / sqrt(v)); after SGD with
momentum within 1e-6 (its step scales the gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
import lm_train_fixture as ltf
from repro.models import attention as j_attn
from repro.train import optim as j_optim
from repro.train.step import make_loss_fn as j_loss_fn
from repro.train.step import make_train_step as j_train_step
from repro_torch.models import flash as t_flash
from repro_torch.train import optim as t_optim
from repro_torch.train.step import make_loss_fn as t_loss_fn
from repro_torch.train.step import make_train_step as t_train_step
from repro_torch.train.step import value_and_grad
from repro_torch.tree import flatten

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the module's torch ops in one intra-op thread, restoring the
    count after.  An eager train step is thousands of small ops; under
    the suite's six worker processes on a few cores, PyTorch's default
    of a thread per core each waiting at every op's barrier made one
    reduced launcher run ~100x slower (0.4 s alone, 47 s beside five
    other files).  A test module imports this fixture by name."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "granite-moe-1b-a400m",
            "ssm": "falcon-mamba-7b", "hybrid": "zamba2-1.2b",
            "vlm": "qwen2-vl-72b", "encdec": "seamless-m4t-large-v2"}
B, S = 4, 32
LR = (3e-3, 5, 60)


def train_batch(cfg, seed=1) -> dict:
    """numpy inputs and labels of ``cfg``'s family."""
    rng = np.random.default_rng(seed)
    bt = lp.batch(cfg, B, S, seed)
    if cfg.family == "encdec":
        bt["src_embeds"] = rng.standard_normal(
            (B, 12, cfg.d_model)).astype(np.float32)
    bt["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return bt


def close(got, want, what, rtol=1e-5):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol,
                               err_msg=what)


def leaves(tree):
    return [lp.np_(x) for x in flatten(lp.np_tree(tree))[1]]


def assert_grads(got, want, what=""):
    for k, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        assert a.shape == b.shape, (what, k)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        assert err <= 1e-4, f"{what} leaf {k}: grad off by {err:.2e}"


def adamw_step(p, bt, accum=1):
    j_opt = j_optim.adamw(j_optim.warmup_cosine(*LR))
    t_opt = t_optim.adamw(t_optim.warmup_cosine(*LR))
    js = {"params": p.jparams, "opt": j_opt.init(p.jparams),
          "step": jnp.zeros((), jnp.int32)}
    ts = {"params": p.tparams, "opt": t_opt.init(p.tparams),
          "step": torch.zeros((), dtype=torch.int32)}
    js, mj = jax.jit(j_train_step(p.ja, j_opt, accum_steps=accum))(
        js, lp.to_jax(bt))
    ts, mt = t_train_step(p.ta, t_opt, accum_steps=accum)(ts,
                                                         lp.to_torch(bt))
    return js, mj, ts, mt


def flat(tree):
    return np.concatenate([x.reshape(-1) for x in leaves(tree)])


def hold_params(ts, js, grads, lr):
    """The updated params under the sign-flip contract: flips only where
    the reference gradient is within 1e-4 of its leaf's max |g| of 0."""
    gl = leaves(grads)
    tol = np.concatenate([np.full(g.size, 1e-4 * float(np.abs(g).max()))
                          for g in gl])
    return ltf.hold_params(flat(ts["params"]), flat(js["params"]),
                           np.concatenate([g.reshape(-1) for g in gl]), tol,
                           lr, max_share=1e-3)


def check_step(name, p, bt, accum=1):
    js, mj, ts, mt = adamw_step(p, bt, accum)
    for k in ("loss", "accuracy", "grad_norm", "lr"):
        close(mt[k], mj[k], f"{name} {k}")
    assert int(ts["step"]) == int(js["step"]) == 1
    # the whole batch's gradient: the mean of equal microbatches' means
    (_, _), gj = jax.jit(jax.value_and_grad(j_loss_fn(p.ja), has_aux=True))(
        p.jparams, lp.to_jax(bt))
    return hold_params(ts, js, gj, float(mj["lr"]))


def check_loss_and_gradients(name, p, bt):
    (lj, mj), gj = jax.jit(jax.value_and_grad(j_loss_fn(p.ja), has_aux=True))(
        p.jparams, lp.to_jax(bt))
    gt, mt = value_and_grad(t_loss_fn(p.ta), p.tparams, lp.to_torch(bt))
    for k in ("loss", "accuracy", "perplexity"):
        close(mt[k], mj[k], f"{name} {k}")
    assert_grads(gt, gj, name)
    assert not any(t.requires_grad or t.grad is not None
                   for t in flatten(p.tparams)[1])


# -- flash gradients ---------------------------------------------------------
FLASH_CASES = {
    # name: (b, sq, skv, h, kv, hd, cq, ckv, causal, q_offset)
    "causal_blocks": (2, 64, 64, 4, 4, 16, 16, 32, True, 0),
    "noncausal_blocks": (2, 64, 64, 4, 4, 16, 16, 32, False, 0),
    "causal_gqa_ragged": (1, 45, 45, 4, 2, 8, 16, 8, True, 0),
    "noncausal_gqa_ragged": (2, 33, 21, 4, 1, 8, 8, 8, False, 0),
    "q_offset_window": (1, 8, 16, 2, 2, 8, 4, 4, True, 8),
    "q_offset_ragged": (1, 11, 29, 4, 2, 16, 4, 8, True, 18),
    "one_block": (1, 12, 12, 2, 2, 8, 512, 1024, True, 0),
}


def flash_inputs(b, sq, skv, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, h, hd), f(b, skv, kv, hd), f(b, skv, kv, hd), \
        f(b, sq, h, hd)


def jax_grads(fn, q, k, v, do, **kw):
    g = jax.grad(lambda *a: (fn(*a, **kw) * do).sum(),
                 argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    return [np.asarray(x, np.float32) for x in g]


def torch_grads(fn, q, k, v, do, dtype=torch.float32, **kw):
    xs = [torch.as_tensor(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    out = fn(*xs, **kw)
    assert out.dtype == dtype
    g = torch.autograd.grad((out.float() * torch.as_tensor(do)).sum(), xs)
    for x, gx in zip(xs, g):
        assert gx.dtype == dtype and gx.shape == x.shape
    return [x.float().numpy() for x in g]


def assert_flash_grads(got, want, tol, what):
    for name, a, b in zip("qkv", got, want):
        scale = max(float(np.abs(b).max()), 1e-6)
        err = float(np.abs(a - b).max()) / scale
        assert err <= tol, f"{what}: d{name} off by {err:.2e} of max|g|"


def check_flash_case(case):
    """Flash's gradients of one :data:`FLASH_CASES` case: the port's
    Function and autograd against the reference's ``custom_vjp`` and
    naive gradient (float32 within 2e-5 of max |g|; the port's two within
    1e-5 of each other)."""
    b, sq, skv, h, kv, hd, cq, ckv, causal, off = FLASH_CASES[case]
    q, k, v, do = flash_inputs(b, sq, skv, h, kv, hd)
    kw = dict(causal=causal, chunk_q=cq, chunk_kv=ckv, q_offset=off)
    port = torch_grads(t_flash.flash_attention, q, k, v, do, **kw)
    port_naive = torch_grads(t_flash.flash_attention_naive_grad, q, k, v, do,
                             **kw)
    ref = jax_grads(j_attn.chunked_attention, q, k, v, do, **kw)
    ref_naive = jax_grads(j_attn.chunked_attention_naive_grad, q, k, v, do,
                          **kw)
    assert_flash_grads(port, ref, 2e-5, "port vs reference custom_vjp")
    assert_flash_grads(port, ref_naive, 2e-5, "port vs reference naive grad")
    assert_flash_grads(port, port_naive, 1e-5,
                       "port Function vs port autograd")

"""Flash attention's memory-exact backward (``models.flash._Flash``)
against the reference's gradients.

The same numpy inputs and output cotangent go through ``jax.grad`` of the
reference's ``chunked_attention`` (its ``custom_vjp``) and of
``chunked_attention_naive_grad`` (autodiff through the block loop), and
through ``torch.autograd`` of the port's ``flash_attention`` (the
Function) and ``flash_attention_naive_grad``: causal and not, lengths
that are not chunk multiples (padded q rows and padded kv), ``q_offset``,
GQA (dk/dv summed over the repeated heads), several blocks each way, and
a bfloat16 case.  The cases: ``tests/lm_train_parity.FLASH_CASES``
(this file takes the causal blocks, GQA, one block and the non-causal
blocks; ``test_torch_lm_flash_grad_offset.py`` the rest).

Tolerances: float32 dq/dk/dv within 2e-5 of the largest gradient
element (the same blocks summed in the same order; ulps of exp), the
port's two gradients within 1e-5 of each other (the same arithmetic, one
recomputed); bfloat16 inputs within 2e-2 relative to the largest element
(the inputs' rounding: the gradients are returned in bfloat16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_train_parity as ltp
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro.models import attention as j_attn
from repro_torch.models import flash as t_flash


@pytest.mark.parametrize("case", ["causal_blocks", "causal_gqa_ragged",
                                  "one_block", "noncausal_blocks"])
def test_flash_backward_matches_the_reference(case):
    ltp.check_flash_case(case)


def test_flash_backward_bfloat16():
    b, sq, skv, h, kv, hd, cq, ckv, causal, off = \
        ltp.FLASH_CASES["causal_gqa_ragged"]
    q, k, v, do = ltp.flash_inputs(b, sq, skv, h, kv, hd, seed=3)
    kw = dict(causal=causal, chunk_q=cq, chunk_kv=ckv, q_offset=off)
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    q, k, v = bf(q), bf(k), bf(v)        # both sides see the same inputs
    port = ltp.torch_grads(t_flash.flash_attention, q, k, v, do,
                       dtype=torch.bfloat16, **kw)
    ref = ltp.jax_grads(j_attn.chunked_attention, q.astype(jnp.bfloat16),
                    k.astype(jnp.bfloat16), v.astype(jnp.bfloat16), do, **kw)
    ltp.assert_flash_grads(port, ref, 2e-2, "bfloat16")


def test_backward_saves_no_score_block():
    """The Function saves (q, k, v, out, lse) only: no (cq, ckv) block
    survives the forward, whatever the length."""
    q, k, v, _ = ltp.flash_inputs(1, 64, 64, 2, 2, 8)
    xs = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        t_flash.flash_attention(*xs, causal=True, chunk_q=16, chunk_kv=16)
    assert all(s[-2:] != (16, 16) for s in saved), saved
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        saved.clear()
        t_flash.flash_attention_naive_grad(*xs, causal=True, chunk_q=16,
                                           chunk_kv=16)
    assert any(s[-2:] == (16, 16) for s in saved)


def test_skipped_blocks_change_no_forward_value():
    """Blocks wholly after a causal q block are skipped: the output and
    lse equal a pass over every block (bit for bit)."""
    q, k, v, _ = ltp.flash_inputs(1, 64, 64, 2, 2, 8, seed=5)
    qt, kt, vt = (torch.as_tensor(x).transpose(1, 2) for x in (q, k, v))
    out, lse = t_flash._fwd_impl(qt, kt, vt, True, 16, 16, 0, 64)
    live = t_flash._live
    try:
        t_flash._live = lambda *a: True
        out_all, lse_all = t_flash._fwd_impl(qt, kt, vt, True, 16, 16, 0, 64)
    finally:
        t_flash._live = live
    assert torch.equal(out, out_all) and torch.equal(lse, lse_all)

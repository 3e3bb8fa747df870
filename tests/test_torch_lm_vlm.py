"""The VLM backbone of the port (qwen2-vl-72b: M-RoPE over (t, h, w)
position ids, a stub vision adapter fed patch embeddings) against the
reference, at the reduced config on the reference's params
(``tests/lm_parity.py``: rtol/atol 1e-4): forward, prefill and three
teacher-forced decode steps, with position ids whose three components
differ; ``apply_mrope`` alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.models import layers as j_layers
from repro_torch.models import layers as t_layers


@pytest.fixture(scope="module")
def run():
    return lp.runs("qwen2-vl-72b")


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


@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 0, 0), (2, 2, 12)])
def test_apply_mrope(sections):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 5)).astype(np.int32)
    want = j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                sections)
    got = t_layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e4,
                               sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_apply_mrope_rejects_wrong_sections():
    with pytest.raises(ValueError, match="sum to"):
        t_layers.apply_mrope(torch.zeros(1, 1, 1, 32),
                             torch.zeros(3, 1, 1, dtype=torch.int32), 1e4,
                             (4, 4, 4))

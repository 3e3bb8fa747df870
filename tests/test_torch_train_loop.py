"""The port's training loop (``train.loop.train``) and launcher
(``launch.train``) against a reference loop, on reduced qwen1.5-0.5b on
the CPU.

The reference's own loop test (``tests/test_train_loop.py``) fails on
the installed JAX: ``jit_train_step`` shards the params and the
embedding gather then raises (ROADMAP queue 3).  So the reference loop
here is built from its unsharded pieces, as the card's fixture is: its
``make_train_step`` under ``jax.jit`` from its ``init`` params, AdamW
with ``warmup_cosine(3e-3, 5, 60)`` and no weight decay,
``SyntheticLM(batch 4, seq 32, seed 0)`` -- the reference test's set-up.
The port starts from the reference's initial state, saved as step 0 of
its checkpoint directory (``convert.train_state``), and ``train`` resumes
from it.

Checked: the logged losses (every 5 steps) against the reference loop's;
the reference test's own >= 10 % decrease over 30 steps and its resume
contract (30 -> 40 against an uninterrupted 40, rtol 2e-4 / atol 2e-5,
and bit for bit here on the CPU).  The SIGTERM hook and the launcher:
``tests/test_torch_train_launch.py``.

Tolerance: the logged losses rtol 1e-4 over 40 steps.  The params are
not held to the reference's: AdamW's sign-like early steps at near-zero
gradients part ~0.1 % of the elements by up to 1e-3 over 30 steps
(measured), which the losses do not feel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro.configs import get_config as j_get_config
from repro.models.registry import make_arch as j_make_arch
from repro.train import optim as j_optim
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.step import make_train_step as j_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.registry import make_arch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import train
from repro_torch.tree import flatten

ARCH, LR, LOG = "qwen1.5-0.5b", (3e-3, 5, 60), 5


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def reference():
    """The reference loop's initial state (numpy) and its losses at every
    logged step of 40."""
    cfg = j_get_config(ARCH, reduced=True)
    arch = j_make_arch(cfg)
    opt = j_optim.adamw(j_optim.warmup_cosine(*LR), weight_decay=0.0)
    params = arch.init(jax.random.PRNGKey(0))
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    init = np_tree(state)
    data = JSyntheticLM(cfg.vocab_size, batch=4, seq_len=32, seed=0)
    step = jax.jit(j_train_step(arch, opt))
    losses = []
    for i in range(40):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data.batch_at(i).items()})
        if (i + 1) % LOG == 0:
            losses.append(float(m["loss"]))
    return init, losses


def setup(tmp, init):
    """The port's arch, optimizer and data, and a checkpoint directory
    whose step 0 is the reference's initial state."""
    cfg = get_config(ARCH, reduced=True)
    ckpt.save(str(tmp), 0, convert.train_state(init, cfg, "cpu"),
              extra={"train_step": 0})
    return (make_arch(cfg),
            optim.adamw(optim.warmup_cosine(*LR), weight_decay=0.0),
            SyntheticLM(cfg.vocab_size, batch=4, seq_len=32, seed=0))


def leaves(tree):
    return [x.numpy() for x in flatten(tree)[1]]


def test_loss_history_resume_and_decrease(tmp_path, reference):
    init, ref_losses = reference
    d, d2 = tmp_path / "ckpt", tmp_path / "ckpt2"
    arch, opt, data = setup(d, init)
    state, hist = train(arch, opt, None, data, steps=30, ckpt_dir=str(d),
                        ckpt_every=10, log_every=LOG, device="cpu")
    np.testing.assert_allclose(hist, ref_losses[:6], rtol=1e-4)
    assert hist[-1] < hist[0] * 0.9, f"loss did not decrease: {hist}"
    assert ckpt.latest_step(str(d)) == 30

    resumed, hist_r = train(arch, opt, None, data, steps=40,
                            ckpt_dir=str(d), ckpt_every=100, log_every=LOG,
                            device="cpu")
    setup(d2, init)
    full, hist_f = train(arch, opt, None, data, steps=40, ckpt_dir=str(d2),
                         ckpt_every=100, log_every=LOG, device="cpu")
    np.testing.assert_allclose(hist_f, ref_losses, rtol=1e-4)
    assert hist_r == hist_f[-2:]
    for a, b in zip(leaves(resumed["params"]), leaves(full["params"])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(a, b)       # the CPU is deterministic
    assert int(resumed["step"]) == int(full["step"]) == 40

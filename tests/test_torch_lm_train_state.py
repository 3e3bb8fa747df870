"""``convert.train_state`` carrying the reference's ``{params, opt,
step}`` of each optimizer (AdamW, Adafactor, SGD with momentum) after two
reference steps into the port, which then steps as the reference does
(``repro.train.step.make_train_step`` under ``jax.jit``, reduced
qwen1.5-0.5b on the reference's params).  Helpers and tolerances:
``tests/lm_train_parity.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
import lm_train_parity as ltp
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro.train import optim as j_optim
from repro.train.step import make_loss_fn as j_loss_fn
from repro.train.step import make_train_step as j_train_step
from repro_torch import convert
from repro_torch.train import optim as t_optim
from repro_torch.train.step import make_train_step as t_train_step
from repro_torch.tree import flatten


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_train_state_carries_the_reference_s(name):
    """Two reference steps, the state through ``convert.train_state``,
    then one more step on each side."""
    p = lp.pair("qwen1.5-0.5b")
    j_opt = j_optim.OPTIMIZERS[name](j_optim.warmup_cosine(*ltp.LR))
    t_opt = t_optim.OPTIMIZERS[name](t_optim.warmup_cosine(*ltp.LR))
    j_step = jax.jit(j_train_step(p.ja, j_opt))
    js = {"params": p.jparams, "opt": j_opt.init(p.jparams),
          "step": jnp.zeros((), jnp.int32)}
    for seed in (5, 6):
        js, _ = j_step(js, lp.to_jax(ltp.train_batch(p.jcfg, seed)))
    ts = convert.train_state(lp.np_tree(js), p.tcfg, "cpu")
    assert flatten(ts)[0] == flatten(lp.np_tree(js))[0]
    assert int(ts["opt"]["count"]) == 2 and ts["step"].dtype == torch.int32
    bt = ltp.train_batch(p.jcfg, 7)
    params = js["params"]
    js, mj = j_step(js, lp.to_jax(bt))
    ts, mt = t_train_step(p.ta, t_opt)(ts, lp.to_torch(bt))
    for k in ("loss", "grad_norm", "lr"):
        ltp.close(mt[k], mj[k], f"{name} {k}")
    if name == "sgdm":
        np.testing.assert_allclose(ltp.flat(ts["params"]),
                                   ltp.flat(js["params"]), rtol=0, atol=1e-6)
        return
    (_, _), gj = jax.jit(jax.value_and_grad(j_loss_fn(p.ja), has_aux=True))(
        params, lp.to_jax(bt))
    ltp.hold_params(ts, js, gj, float(mj["lr"]))


def test_train_state_refuses_another_tree():
    with pytest.raises(ValueError, match="not a train state"):
        convert.train_state({"params": {}}, None, "cpu")
    with pytest.raises(ValueError, match="optimizer state"):
        convert.train_state({"params": {}, "opt": {"x": 0}, "step": 0},
                            None, "cpu")


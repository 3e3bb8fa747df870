"""The port's train step with microbatch accumulation against the
reference's ``repro.train.step`` (unsharded, under ``jax.jit``) on
reduced configs: ``accum_steps=2`` on the dense and VLM families (the
VLM's (3, B, S) M-RoPE positions split along B).  Helpers and
tolerances: ``tests/lm_train_parity.py``.
"""
import pytest

import lm_parity as lp
import lm_train_parity as ltp
from lm_train_parity import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_accumulated_train_step(family):
    p = lp.pair(ltp.FAMILIES[family])
    ltp.check_step(f"{family} accum 2", p, ltp.train_batch(p.jcfg, seed=4),
                   accum=2)

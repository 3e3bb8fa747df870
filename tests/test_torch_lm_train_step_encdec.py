"""One train step of the encoder-decoder family (seamless-m4t) of the port against the reference's
``repro.train.step`` (unsharded, under ``jax.jit``), on the reduced
configs and the reference's own params: the loss and metrics of
``make_loss_fn`` and the gradient of every param leaf, elementwise; one
AdamW step of ``make_train_step`` (loss, accuracy, ``grad_norm``, ``lr``
and the updated params).  Helpers and tolerances:
``tests/lm_train_parity.py``.
"""
import pytest

import lm_parity as lp
import lm_train_parity as ltp
from lm_train_parity import one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", params=['encdec'])
def fam(request):
    p = lp.pair(ltp.FAMILIES[request.param])
    return request.param, p, ltp.train_batch(p.jcfg)


def test_loss_and_gradients(fam):
    ltp.check_loss_and_gradients(*fam)


def test_adamw_train_step(fam):
    ltp.check_step(*fam)

"""Flash attention's memory-exact backward against the reference's
gradients (``tests/test_torch_lm_flash_grad.py``'s check): the
non-causal ragged GQA case and the ``q_offset`` windows of
``tests/lm_train_parity.FLASH_CASES``.  Tolerances as there: float32
dq/dk/dv within 2e-5 of the largest gradient element.
"""
import pytest

import lm_train_parity as ltp
from lm_train_parity import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", ["noncausal_gqa_ragged", "q_offset_window",
                                  "q_offset_ragged"])
def test_flash_backward_matches_the_reference(case):
    ltp.check_flash_case(case)

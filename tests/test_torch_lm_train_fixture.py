"""The card's train fixture pipeline at the reduced config: the reference's
run as ``tests/make_lm_train_fixture.py`` builds it (its
``make_train_step`` under ``jax.jit``, the gradient's float64 norm at
each step), against ``tests/lm_train_fixture.py``'s port run and hold --
the card runs the same at full width against the committed file.
Tolerances: ``tests/lm_train_fixture.py``'s contract.
"""
import jax  # noqa: F401  (the parity suites import both packages)
import pytest

from lm_train_parity import one_thread  # noqa: F401  (autouse)
import lm_fixture
import lm_train_fixture as ltf
import make_lm_train_fixture
from repro_torch import convert
from repro_torch.tree import flatten


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_fixture_pipeline_on_the_reduced_config(dtype):
    """The fixture's reference run and the port's run and hold, at the
    reduced config (the card runs them at full width)."""
    cfg = lm_fixture.config(dtype, reduced=True)
    tree = lm_fixture.param_tree(cfg)
    want = make_lm_train_fixture.build(dtype, tree, reduced=True)
    params = convert.lm_params(tree, cfg, "cpu")
    shapes = [tuple(p.shape) for p in flatten(params)[1]]
    out = ltf.hold(ltf.run(cfg, params, "cpu"), want, shapes, dtype)
    assert len(out["loss"]) == ltf.STEPS
    if dtype == "float32":
        assert out["grad_norm_max_rel_err"] <= ltf.GNORM_RTOL

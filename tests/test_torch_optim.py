"""The port's AdamW (``repro_torch.train.optim``) against the JAX package.

The same gradient sequence, made from a numpy seed, goes through the
reference's ``adamw`` and the port's, step by step, on an actor-critic
shaped tree (nested dicts and a list).  Contract: params and both moments
to rtol 1e-6 (atol 1e-7 for entries near zero) at every step; the step
count exact; ``global_norm`` and ``clip_by_global_norm`` to rtol 1e-6.
The sequence holds steps with a global norm above the clip, so clipping
is active on some steps and not on others.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as j_optim
from repro_torch import convert
from repro_torch.train import optim as t_optim
from repro_torch.tree import flatten

DEV = torch.device("cpu")
RTOL, ATOL = 1e-6, 1e-7


def tree_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    return {"layers": [{"w": f(6, 5), "b": f(5)}, {"w": f(5, 5), "b": f(5)}],
            "actor": {"w": f(5, 3), "b": f(3)},
            "critic": {"w": f(5, 1), "b": f(1)}, "log_std": f(3)}


def to_j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_t(tree):
    return convert._tree(tree, DEV)


def assert_tree_close(t_tree, j_tree, rtol=RTOL, atol=ATOL):
    keys, got = flatten(t_tree)
    want = jax.tree_util.tree_leaves(j_tree)
    assert len(got) == len(want)
    for k, g, w in zip(keys, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_global_norm_and_clip_match_reference():
    g = tree_np(1, scale=3.0)
    np.testing.assert_allclose(float(t_optim.global_norm(to_t(g))),
                               float(j_optim.global_norm(to_j(g))),
                               rtol=1e-6)
    for max_norm in (0.5, 1e3):
        got, n_t = t_optim.clip_by_global_norm(to_t(g), max_norm)
        want, n_j = j_optim.clip_by_global_norm(to_j(g), max_norm)
        np.testing.assert_allclose(float(n_t), float(n_j), rtol=1e-6)
        assert_tree_close(got, want)


@pytest.mark.parametrize("weight_decay,grad_clip,lr", [
    (0.1, 1.0, 1e-2),        # the reference's defaults
    (0.0, 0.5, 3e-3),        # PPO's
    (0.0, 10.0, 0.1),        # diffopt's
])
def test_adamw_matches_reference_step_by_step(weight_decay, grad_clip, lr):
    params = tree_np(0)
    opt_j = j_optim.adamw(j_optim.constant_lr(lr), weight_decay=weight_decay,
                          grad_clip=grad_clip)
    opt_t = t_optim.adamw(t_optim.constant_lr(lr), weight_decay=weight_decay,
                          grad_clip=grad_clip)
    p_j, p_t = to_j(params), to_t(params)
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    clipped = []
    for step, scale in enumerate((0.05, 2.0, 0.1, 5.0, 0.01, 0.3, 3.0)):
        g = tree_np(100 + step, scale)
        p_j, s_j, st_j = opt_j.update(to_j(g), s_j, p_j)
        p_t, s_t, st_t = opt_t.update(to_t(g), s_t, p_t)
        clipped.append(float(st_j["grad_norm"]) > grad_clip)
        np.testing.assert_allclose(float(st_t["grad_norm"]),
                                   float(st_j["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(st_t["lr"]), float(st_j["lr"]),
                                   rtol=0)
        assert_tree_close(p_t, p_j)
        assert_tree_close(s_t["mu"], s_j["mu"])
        assert_tree_close(s_t["nu"], s_j["nu"])
        assert s_t["count"].dtype == torch.int32
        assert int(s_t["count"]) == int(s_j["count"]) == step + 1
    assert any(clipped) and not all(clipped)


def test_adamw_resumes_from_the_reference_state():
    """``convert.adamw_state`` carries the reference's moments and count:
    the port's next step from them is the reference's next step."""
    params = tree_np(0)
    opt_j = j_optim.adamw(j_optim.constant_lr(1e-2))
    opt_t = t_optim.adamw(t_optim.constant_lr(1e-2))
    p_j, s_j = to_j(params), opt_j.init(to_j(params))
    for step in range(3):
        p_j, s_j, _ = opt_j.update(to_j(tree_np(7 + step)), s_j, p_j)
    np_state = jax.tree_util.tree_map(np.asarray, s_j)
    s_t = convert.adamw_state(np_state, DEV)
    p_t = convert.policy_params(jax.tree_util.tree_map(np.asarray, p_j), DEV)
    g = tree_np(50)
    p_j, s_j, _ = opt_j.update(to_j(g), s_j, p_j)
    p_t, s_t, _ = opt_t.update(to_t(g), s_t, p_t)
    assert_tree_close(p_t, p_j)
    assert int(s_t["count"]) == 4
    with pytest.raises(ValueError, match="adamw"):
        convert.adamw_state({"mu": {}}, DEV)


def test_adamw_of_a_single_tensor_and_no_write_in_place():
    """diffopt's use: a bare tensor is a one-leaf tree; the update builds
    new tensors and leaves its inputs as they were."""
    opt = t_optim.adamw(t_optim.constant_lr(0.1), weight_decay=0.0,
                        grad_clip=10.0)
    u = torch.zeros((2, 3))
    s = opt.init(u)
    g = torch.ones((2, 3))
    u2, s2, _ = opt.update(g, s, u)
    assert float(u.abs().sum()) == 0.0 and float(s["mu"].abs().sum()) == 0.0
    np.testing.assert_allclose(u2.numpy(), -0.1 * np.ones((2, 3)), rtol=1e-5)
    assert int(s2["count"]) == 1


def test_adamw_is_written_by_hand():
    """The module uses no ``torch.optim`` optimizer: its step is the
    reference's, not ``torch.optim.AdamW``'s."""
    src = Path(t_optim.__file__).read_text()
    names = {n.attr for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Attribute)}
    assert "optim" not in names and "AdamW" not in names

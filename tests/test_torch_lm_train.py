"""The LM training pieces of the port against the reference:
``train.loss`` (``cross_entropy``, ``chunked_cross_entropy``, with masks,
values and feature gradients), one update of each optimizer of
``train.optim`` on the same gradients, params and state (``warmup_cosine``
at steps 0-N; adafactor's factored and unfactored leaves, its first
step's beta = 0 and a later one), and ``train.data``'s ``SyntheticLM``
and ``MemmapLM`` bit for bit, with ``Prefetcher`` order; the copied
flops model of ``analysis.flops`` exactly.

Tolerances (float32): losses and metrics rtol 1e-6; feature gradients
rtol 2e-5 / atol 1e-6 (``tests/test_optim_loss.py``'s own for chunked
against full); optimizer updates rtol 1e-6 / atol 1e-7 on params and
state (the same elementwise float32 arithmetic; one ulp of sqrt and
pow), the global norm rtol 1e-6; the schedule rtol 1e-6; data exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro import configs as j_configs
from repro.train import data as j_data
from repro.train import optim as j_optim
from repro.train.loss import chunked_cross_entropy as j_chunked
from repro.train.loss import cross_entropy as j_ce
from repro_torch import configs as t_configs
from repro_torch.train import data as t_data
from repro_torch.train import optim as t_optim
from repro_torch.train.loss import chunked_cross_entropy as t_chunked
from repro_torch.train.loss import cross_entropy as t_ce
from repro_torch.tree import flatten

RNG = np.random.default_rng(7)
J, T = jnp.asarray, torch.as_tensor


def close(got, want, rtol=1e-6, atol=0.0, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


# -- losses ------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy(masked, z_loss):
    logits = RNG.standard_normal((2, 6, 17)).astype(np.float32) * 3
    labels = RNG.integers(0, 17, (2, 6)).astype(np.int32)
    mask = (RNG.random((2, 6)) > 0.4).astype(np.float32) if masked else None
    lt, mt = t_ce(T(logits), T(labels), z_loss=z_loss,
                  mask=None if mask is None else T(mask))
    lj, mj = j_ce(J(logits), J(labels), z_loss=z_loss,
                  mask=None if mask is None else J(mask))
    for k in ("loss", "accuracy", "perplexity"):
        close(mt[k], mj[k], what=k)


def test_cross_entropy_mask_of_zeros_counts_one():
    lt, _ = t_ce(torch.zeros(1, 3, 5), torch.zeros(1, 3, dtype=torch.int32),
                 mask=torch.zeros(1, 3))
    assert float(lt) == 0.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 512])
def test_chunked_cross_entropy_values_and_grads(masked, chunk):
    b, s, d, v = 2, 16, 8, 32
    feats = RNG.standard_normal((b, s, d)).astype(np.float32)
    w = (RNG.standard_normal((d, v)) * 0.3).astype(np.float32)
    labels = RNG.integers(0, v, (b, s)).astype(np.int32)
    mask = (RNG.random((b, s)) > 0.3).astype(np.float32) if masked else None

    def jl(f):
        return j_chunked(lambda x: x @ J(w), f, J(labels), chunk=chunk,
                         mask=None if mask is None else J(mask))
    (lj, mj), gj = jax.value_and_grad(jl, has_aux=True)(J(feats))
    ft = T(feats).requires_grad_(True)
    lt, mt = t_chunked(lambda x: x @ T(w), ft, T(labels), chunk=chunk,
                       mask=None if mask is None else T(mask))
    (gt,) = torch.autograd.grad(lt, ft)
    for k in ("loss", "accuracy", "perplexity"):
        close(mt[k], mj[k], what=k)
    close(gt, gj, rtol=2e-5, atol=1e-6, what="features grad")
    # and the port's chunked loss is its whole one
    lf, _ = t_ce(T(feats) @ T(w), T(labels),
                 mask=None if mask is None else T(mask))
    close(lt, lf.detach().numpy())


def test_chunked_cross_entropy_needs_whole_chunks():
    with pytest.raises(AssertionError):
        t_chunked(lambda x: x, torch.zeros(1, 6, 4),
                  torch.zeros(1, 6, dtype=torch.int32), chunk=4)


# -- schedules and optimizers ----------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(10, 100), (5, 60), (0, 20)])
def test_warmup_cosine(warmup, total):
    t_lr = t_optim.warmup_cosine(1e-3, warmup, total)
    j_lr = j_optim.warmup_cosine(1e-3, warmup, total)
    for step in list(range(0, total + 3)) + [1000]:
        got = t_lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        close(got, j_lr(jnp.int32(step)), what=f"step {step}")


def tree_np(rng):
    """A param tree with a factored (>= 64 x 64) leaf, a stacked factored
    leaf, small matrices and a vector."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": f(96, 80), "stack": {"k": f(3, 64, 72)},
            "small": f(8, 70), "b": f(13)}


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else T(v)
            for k, v in tree.items()}


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def assert_trees(got, want, what):
    kg, lg = flatten(to_np(got))
    kw, lw = flatten(to_np(jax.tree_util.tree_map(np.asarray, want)))
    assert kg == kw, (kg, kw)
    for k, a, b in zip(kg, lg, lw):
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        close(a, b, rtol=1e-6, atol=1e-7, what=f"{what} {k}")


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_updates(name):
    """Two updates from fresh state (adafactor: beta 0, then 1 - 2**-0.8),
    then one from a random state at count 6, each on the same grads."""
    rng = np.random.default_rng(3)
    params = tree_np(rng)
    lr = (1e-2, 5, 40)
    t_opt = t_optim.OPTIMIZERS[name](t_optim.warmup_cosine(*lr))
    j_opt = j_optim.OPTIMIZERS[name](j_optim.warmup_cosine(*lr))
    tp, jp = to_torch(params), jax.tree_util.tree_map(J, params)
    ts, js = t_opt.init(tp), j_opt.init(jp)
    assert_trees(ts, js, "init")
    for step in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32),
            params)
        tp, ts, tm = t_opt.update(to_torch(grads), ts, tp)
        jp, js, jm = j_opt.update(jax.tree_util.tree_map(J, grads), js, jp)
        assert_trees(tp, jp, f"params step {step}")
        assert_trees(ts, js, f"state step {step}")
        close(tm["grad_norm"], jm["grad_norm"])
        close(tm["lr"], jm["lr"])
    # a random state (positive second moments) at count 6
    state = jax.tree_util.tree_map(
        lambda x: (np.abs(rng.standard_normal(x.shape)) * 0.1)
        .astype(x.dtype) if x.dtype == np.float32
        else np.asarray(6, np.int32), to_np(js))
    tp2, ts2, _ = t_opt.update(to_torch(grads), to_torch(state),
                               to_torch(to_np(tp)))
    jp2, js2, _ = j_opt.update(jax.tree_util.tree_map(J, grads),
                               jax.tree_util.tree_map(J, state),
                               jax.tree_util.tree_map(J, to_np(tp)))
    assert_trees(tp2, jp2, "params from a random state")
    assert_trees(ts2, js2, "state from a random state")


def test_adafactor_state_is_factored_and_small():
    opt = t_optim.adafactor(t_optim.constant_lr(1e-3))
    st = opt.init({"w": torch.zeros(256, 512), "tiny": torch.zeros(4, 4)})
    assert set(st["m"]["w"]) == {"vr", "vc"}
    assert st["m"]["w"]["vr"].shape == (256,)
    assert st["m"]["w"]["vc"].shape == (512,)
    assert set(st["m"]["tiny"]) == {"v"}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizers_converge_on_quadratic(name):
    """``tests/test_optim_loss.py``'s check on the port."""
    opt = t_optim.OPTIMIZERS[name](t_optim.constant_lr(0.1))
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(8, 8, generator=gen),
              "b": torch.ones(8) * 3.0}
    state = opt.init(params)
    loss = lambda p: sum(torch.sum(x ** 2) for x in flatten(p)[1])
    l0 = float(loss(params))
    for _ in range(60):
        grads = {k: 2 * v for k, v in params.items()}
        params, state, metrics = opt.update(grads, state, params)
    assert float(loss(params)) < 0.05 * l0
    assert np.isfinite(float(metrics["grad_norm"]))


# -- data ------------------------------------------------------------------------
def test_synthetic_lm_is_the_reference_s():
    t, j = t_data.SyntheticLM(512, 4, 32, seed=3), \
        j_data.SyntheticLM(512, 4, 32, seed=3)
    for step in (0, 1, 7, 1000):
        a, b = t.batch_at(step), j.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(t.batch_at(0)["tokens"],
                              t_data.SyntheticLM(512, 4, 32, 4)
                              .batch_at(0)["tokens"])


def test_memmap_lm_is_the_reference_s(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    for host in (0, 1):
        t = t_data.MemmapLM(str(path), 2, 16, host_id=host, n_hosts=2)
        j = j_data.MemmapLM(str(path), 2, 16, host_id=host, n_hosts=2)
        for step in range(40):
            a, b = t.batch_at(step), j.batch_at(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a["tokens"][:, 1:],
                                          a["labels"][:, :-1])


def test_prefetcher_runs_the_stream_in_order_and_stops():
    src = t_data.SyntheticLM(64, 2, 8, seed=1)
    pf = t_data.Prefetcher(src, start_step=5)
    try:
        for want in range(5, 12):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(step)["tokens"])
    finally:
        pf.close()
    assert not pf.thread.is_alive()


# -- the flops model -------------------------------------------------------------
@pytest.mark.parametrize("arch_id", j_configs.LM_ARCH_IDS)
def test_flops_model_is_the_reference_s(arch_id):
    """``analysis.flops`` (a copy) counts what the reference's counts, for
    every LM config and shape (exact: the same float arithmetic)."""
    from repro.analysis import flops as j_flops
    from repro_torch.analysis import flops as t_flops
    jcfg = j_configs.get_config(arch_id)
    tcfg = t_configs.get_config(arch_id)
    for shape in j_flops.SHAPES:
        assert t_flops.step_flops(tcfg, shape) == \
            j_flops.step_flops(jcfg, shape)
        assert t_flops.step_bytes(tcfg, shape, 1e9) == \
            j_flops.step_bytes(jcfg, shape, 1e9)

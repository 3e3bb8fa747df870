"""qwen1.5-0.5b trained at full width, as data: the reference's first
train steps.

The card has no JAX, so the reference's train step runs here once
(``tests/make_lm_train_fixture.py``: ``repro.train.step.make_train_step``
unsharded under ``jax.jit``) and its numbers live in
``tests/data/lm_train_qwen1p5_0p5b.npz``.  The weights are
``lm_fixture.param_tree``'s numpy-seeded ones (about 0.62 B parameters),
rebuilt wherever the check runs.

The run: AdamW with ``warmup_cosine(1e-3, 5, 300)`` (the optimizer's
defaults otherwise), ``SyntheticLM(vocab, batch 2, seq 128, seed 0)``,
:data:`STEPS` steps, once in float32 compute and once in the config's
bfloat16.  Kept per step: the loss, accuracy, ``grad_norm`` and ``lr``, and the
float64 norm of the step's gradient (``grad_norm64``);
at :data:`N_PROBE` fixed flat indices of every param leaf
(:func:`probe_index`): the step-0 gradient of the loss (before clipping)
with the leaf's max |g| and L2 norm, and the params after the last step.

Contract (:func:`hold`), set before the card's first run, except the
grad norm's (set after it, see below):
  * float32: losses rtol 1e-5; ``lr`` rtol 1e-6; the ``grad_norm``
    metric rtol 1e-5 of the float64 norm of the reference's gradient at
    each step (``grad_norm64``: the reference's own metric sums the
    squares in float32 and sits 1.5e-4 under it at full width, whose
    embedding gradient has 155.6 M elements -- the card's first run
    read that gap against a first contract of rtol 1e-4 on the metric;
    the port's metric sits 4e-8 from the float64 norm); every gradient
    probe within 1e-4 * max|g| of its leaf; params
    after the steps within 1e-6, except that AdamW's first steps are
    nearly ``sign(g) * lr``, so an element whose reference gradient lies
    within rounding noise of 0 may step the other way: such flips may
    move it by up to 2 * 1.01 * sum(lr) (|m_hat| / sqrt(v_hat) <= 1.003
    over three steps at b1 0.9, b2 0.95); a flip counts only where the
    reference's step-0 gradient is within the gradient tolerance of 0,
    and the flips' share must stay under 1e-4 of the probed elements
    (:func:`hold_params`);
  * bfloat16: losses within 2e-2 (absolute); the gradients, grad norms
    and params are printed against the reference's, not held (bfloat16
    rounding of the activations moves the gradients by ~1e-2 relative).

This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import lm_fixture
from repro_torch import convert
from repro_torch.models.registry import make_arch
from repro_torch.train import optim
from repro_torch.train.data import SyntheticLM
from repro_torch.train.step import make_loss_fn, make_train_step, \
    value_and_grad
from repro_torch.tree import flatten

PATH = Path(__file__).resolve().parent / "data" / "lm_train_qwen1p5_0p5b.npz"
BATCH, SEQ, DATA_SEED, STEPS = 2, 128, 0, 3
LR = (1e-3, 5, 300)                 # warmup_cosine(peak, warmup, total)
N_PROBE = 64
DTYPES = ("float32", "bfloat16")
LOSS_RTOL = 1e-5                    # float32
GNORM_RTOL, LR_RTOL = 1e-5, 1e-6
GRAD_TOL = 1e-4                     # of the leaf's max |g|
PARAM_ATOL = 1e-6
FLIP_BOUND = 2 * 1.01               # times sum(lr)
FLIP_SHARE = 1e-4
BF16_LOSS_ATOL = 2e-2
METRICS = ("loss", "accuracy", "grad_norm", "lr")


def norm64(leaves) -> float:
    """The global L2 norm of gradient leaves (tensors), summed in
    float64."""
    return float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                for x in leaves)))


def data(cfg, data_module=None):
    """The run's stream (``data_module``: the package whose
    ``SyntheticLM`` draws it; the port's by default -- both draw the same
    numpy batches)."""
    cls = SyntheticLM if data_module is None else data_module.SyntheticLM
    return cls(cfg.vocab_size, BATCH, SEQ, seed=DATA_SEED)


def optimizer(optim_module=optim):
    """AdamW over ``warmup_cosine(*LR)`` of ``optim_module`` (the port's
    ``train.optim`` or the reference's: the same signatures)."""
    return optim_module.adamw(optim_module.warmup_cosine(*LR))


def probe_index(shapes: list) -> list:
    """The fixed flat indices (sorted) kept of each leaf of ``shapes``
    (all of a leaf smaller than :data:`N_PROBE`)."""
    rng = np.random.default_rng(2)
    out = []
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(np.arange(n) if n <= N_PROBE else
                   np.sort(rng.choice(n, N_PROBE, replace=False)))
    return out


def leaf_stats(leaves: list, index: list) -> tuple:
    """(the probed elements of every leaf concatenated, each leaf's max
    |x|, each leaf's float64 L2 norm) of tensors on any device: reduced
    where they lie, only the probes copied."""
    probes, mx, nrm = [], [], []
    for x, i in zip(leaves, index):
        flat = x.detach().reshape(-1)
        probes.append(flat[torch.as_tensor(i, device=flat.device)]
                      .float().cpu().numpy())
        mx.append(float(flat.abs().max()))
        nrm.append(float(flat.double().norm()))
    return np.concatenate(probes), np.array(mx), np.array(nrm)


def summarize(grads0: list, params: list, steps: list) -> dict:
    """The kept numbers: ``grads0``/``params`` are the flattened step-0
    gradient and final params (tensors), ``steps`` one metrics dict per
    step (the reference's with ``grad_norm64``)."""
    index = probe_index([tuple(x.shape) for x in params])
    out = {k: np.array([float(m[k]) for m in steps], np.float64)
           for k in steps[0]}
    out["grad_probe"], out["grad_max"], out["grad_leaf_norm"] = \
        leaf_stats(grads0, index)
    out["param_probe"] = leaf_stats(params, index)[0]
    return out


def run(cfg, params: dict, device) -> dict:
    """The port's run over ``params`` (port tensors, modified by nothing):
    the step-0 gradient, then :data:`STEPS` train steps
    (:func:`summarize`d)."""
    arch = make_arch(cfg)
    stream = data(cfg)
    batch = lambda i: {k: torch.as_tensor(v, device=device)
                       for k, v in stream.batch_at(i).items()}
    grads0, _ = value_and_grad(make_loss_fn(arch), params, batch(0))
    opt = optimizer()
    step = make_train_step(arch, opt)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    metrics = []
    for i in range(STEPS):
        state, m = step(state, batch(i))
        metrics.append({k: float(m[k]) for k in METRICS})
    return summarize(flatten(grads0)[1], flatten(state["params"])[1],
                     metrics)


def hold_params(got, want, grad_ref, grad_noise, lr_sum: float,
                max_share: float = FLIP_SHARE) -> dict:
    """Params after AdamW steps within :data:`PARAM_ATOL`, except counted
    sign flips: elements whose reference gradient ``grad_ref`` lies within
    ``grad_noise`` (the gradient tolerance) of 0, each within
    ``FLIP_BOUND * lr_sum`` and together under ``max_share`` of the
    elements."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    flips = d > PARAM_ATOL
    share = float(flips.mean()) if d.size else 0.0
    worst = float(d.max()) if d.size else 0.0
    g = np.abs(np.asarray(grad_ref, np.float64))
    unjustified = flips & (g > grad_noise)
    if unjustified.any():
        i = int(np.argmax(unjustified))
        raise AssertionError(f"{int(unjustified.sum())} params off by more "
                             f"than {PARAM_ATOL} where the gradient is not "
                             f"near 0: element {i} off by {d[i]:.3e}, "
                             f"|g| {g[i]:.3e}")
    if worst > FLIP_BOUND * lr_sum + PARAM_ATOL:
        raise AssertionError(f"params off by {worst:.3e} > "
                             f"{FLIP_BOUND} * sum(lr) = "
                             f"{FLIP_BOUND * lr_sum:.3e}")
    if share >= max_share:
        raise AssertionError(f"{int(flips.sum())} of {d.size} params "
                             f"({share:.2e}) flipped: not under "
                             f"{max_share}")
    return {"flips": int(flips.sum()), "flip_share": share,
            "param_max_err": worst,
            "param_max_err_off_flips": float(d[~flips].max())
            if (~flips).any() else 0.0,
            "flip_max_abs_grad": float(g[flips].max()) if flips.any()
            else 0.0}


def noise(grad_max, shapes) -> np.ndarray:
    """Per probed element: the gradient tolerance of its leaf."""
    return np.concatenate([np.full(len(i), GRAD_TOL * m)
                           for i, m in zip(probe_index(shapes), grad_max)])


def grad_errors(got, want, grad_max, shapes) -> np.ndarray:
    """Per probed element: |got - want| over the leaf's reference max |g|."""
    return np.abs(np.asarray(got, np.float64) - want) \
        / np.maximum(noise(grad_max, shapes) / GRAD_TOL, 1e-30)


def hold(got: dict, want: dict, shapes, dtype: str) -> dict:
    """Hold one run to the reference's under the contract above; returns
    the measured errors and counts (all measured before any check, so a
    breach reports every number)."""
    loss_err = np.abs(got["loss"] - want["loss"])
    gerr = grad_errors(got["grad_probe"], want["grad_probe"],
                       want["grad_max"], shapes)
    leaf_err = [float(e.max()) for e in np.split(
        gerr, np.cumsum([len(i) for i in probe_index(shapes)])[:-1])]
    out = {"loss": got["loss"].tolist(), "want_loss": want["loss"].tolist(),
           "loss_max_abs_err": float(loss_err.max()),
           "loss_max_rel_err": float((loss_err / np.abs(want["loss"])).max()),
           "grad_norm_max_rel_err": float(
               (np.abs(got["grad_norm"] - want["grad_norm64"])
                / want["grad_norm64"]).max()),
           "grad_norm": got["grad_norm"].tolist(),
           "want_grad_norm64": want["grad_norm64"].tolist(),
           "want_grad_norm_metric": want["grad_norm"].tolist(),
           "ref_metric_vs_norm64_rel": float(
               (np.abs(want["grad_norm"] - want["grad_norm64"])
                / want["grad_norm64"]).max()),
           "lr_max_rel_err": float((np.abs(got["lr"] - want["lr"])
                                    / np.maximum(want["lr"], 1e-30)).max()),
           "grad_max_err": float(gerr.max()),
           "grad_leaf_err": leaf_err,
           "grad_leaf_norm_rel_err": (np.abs(got["grad_leaf_norm"]
                                             - want["grad_leaf_norm"])
                                      / np.maximum(want["grad_leaf_norm"],
                                                   1e-30)).tolist(),
           "accuracy": got["accuracy"].tolist(),
           "want_accuracy": want["accuracy"].tolist()}
    d = np.abs(got["param_probe"] - want["param_probe"])
    out["param_share_over_atol"] = float((d > PARAM_ATOL).mean())
    if dtype == "bfloat16":
        if out["loss_max_abs_err"] > BF16_LOSS_ATOL:
            raise AssertionError(f"bfloat16: {out}")
        return out
    flips = None
    try:
        flips = hold_params(got["param_probe"], want["param_probe"],
                            want["grad_probe"],
                            noise(want["grad_max"], shapes),
                            float(want["lr"].sum()))
    except AssertionError as e:
        out["params"] = str(e)
    breaches = [name for name, bad in (
        ("loss", out["loss_max_rel_err"] > LOSS_RTOL),
        ("grad_norm", out["grad_norm_max_rel_err"] > GNORM_RTOL),
        ("lr", out["lr_max_rel_err"] > LR_RTOL),
        ("gradient probes", out["grad_max_err"] > GRAD_TOL),
        ("params", flips is None)) if bad]
    if breaches:
        raise AssertionError(f"float32 breaches {breaches}: {out}")
    out.update(flips)
    return out


def read(dtype: str) -> tuple:
    """(the file's kept numbers of ``dtype``, its weights' checksum)."""
    with np.load(PATH) as f:
        return ({k.removeprefix(f"{dtype}_"): f[k] for k in f.files
                 if k.startswith(f"{dtype}_")}, f["checksum"])


def check(device, dtype: str, params_np: dict | None = None) -> dict:
    """Train qwen1.5-0.5b at full width on ``device`` in ``dtype`` over
    the seeded weights and hold it to the file (``params_np``: the tree of
    ``lm_fixture.param_tree``, to build it once for both dtypes)."""
    cfg = lm_fixture.config(dtype)
    tree = lm_fixture.param_tree(cfg) if params_np is None else params_np
    want, want_sum = read(dtype)
    got_sum = lm_fixture.checksum(tree)
    if not np.allclose(got_sum, want_sum, rtol=1e-6, atol=1e-3):
        raise AssertionError(f"the seeded weights differ from those the "
                             f"reference trained: {got_sum} vs {want_sum}")
    params = convert.lm_params(tree, cfg, device)
    shapes = [tuple(p.shape) for p in flatten(params)[1]]
    return hold(run(cfg, params, device), want, shapes, dtype)

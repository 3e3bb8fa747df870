"""qwen1.5-0.5b trained on a mesh at full width, as data: the reference's
first *sharded* train steps.

The reference's sharded loop computes the layers on bfloat16-rounded
weights (``gather_layer_params``), even on a (1, 1) mesh, so it is not its
unsharded step (``tests/lm_train_fixture.py``).  The card has no JAX, so
the reference's ``jit_train_step`` runs here once on an Auto (1, 1) mesh
(``tests/make_lm_mesh_fixture.py``) and its numbers live in
``tests/data/lm_mesh_train_qwen1p5_0p5b.npz``.  The run is
``lm_train_fixture``'s: ``lm_fixture.param_tree``'s numpy-seeded weights,
AdamW over ``warmup_cosine(1e-3, 5, 300)``, ``SyntheticLM(vocab, batch 2,
seq 128, seed 0)``, :data:`STEPS` steps in float32 and in bfloat16
compute.  Kept per step: loss, accuracy, ``grad_norm``, ``lr``; and the
params after the last step at ``lm_train_fixture.probe_index``.

The port runs it through ``train.loop.train(mesh=)`` (:func:`run`), the
weights handed in through the arch's ``init`` (:func:`seeded_arch`).
Contract (:func:`hold`), the existing fixture's: float32 losses rtol 1e-5;
bfloat16 losses within 2e-2 (absolute).  The rest is printed beside the
reference's.

This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

import lm_fixture
import lm_train_fixture as ltf
from repro_torch import convert
from repro_torch.models.registry import make_arch
from repro_torch.train.loop import train

PATH = (Path(__file__).resolve().parent / "data"
        / "lm_mesh_train_qwen1p5_0p5b.npz")
STEPS = ltf.STEPS
DTYPES = ltf.DTYPES
METRICS = ltf.METRICS


def seeded_arch(cfg, tree: dict):
    """``make_arch(cfg)`` whose ``init`` draws nothing: it returns the
    numpy ``tree``'s weights on the generator's device (the meta init
    stays the model's own, for the shapes)."""
    arch = make_arch(cfg)

    def init(gen, device=None):
        if device is not None and torch.device(device).type == "meta":
            return arch.init(gen, device=device)
        return convert.lm_params(tree, cfg, device or gen.device)
    return dataclasses.replace(arch, init=init)


def run(cfg, tree: dict, mesh, steps: int = STEPS, device=None):
    """``(losses, final state)`` of the run through
    ``train.loop.train(mesh)`` (``mesh=None``: unsharded on ``device``)."""
    state, hist = train(seeded_arch(cfg, tree), ltf.optimizer(), mesh,
                        ltf.data(cfg), steps=steps, log_every=1,
                        device=device)
    return np.array(hist, np.float64), state


def read(dtype: str) -> tuple:
    """(the file's kept numbers of ``dtype``, its weights' checksum)."""
    with np.load(PATH) as f:
        return ({k.removeprefix(f"{dtype}_"): f[k] for k in f.files
                 if k.startswith(f"{dtype}_")}, f["checksum"])


def hold(losses, dtype: str, want: dict | None = None) -> dict:
    """Hold a run's losses to the file's (or ``want``'s; see the module
    docstring)."""
    want = read(dtype)[0] if want is None else want
    err = np.abs(np.asarray(losses) - want["loss"])
    out = {"loss": list(map(float, losses)),
           "want_loss": want["loss"].tolist(),
           "loss_max_abs_err": float(err.max()),
           "loss_max_rel_err": float((err / np.abs(want["loss"])).max())}
    bad = (out["loss_max_abs_err"] > ltf.BF16_LOSS_ATOL
           if dtype == "bfloat16"
           else out["loss_max_rel_err"] > ltf.LOSS_RTOL)
    if bad:
        raise AssertionError(f"{dtype} sharded run off the reference's: "
                             f"{out}")
    return out


def check_weights(tree: dict):
    """The seeded weights are those the reference trained."""
    _, want = read("float32")
    got = lm_fixture.checksum(tree)
    if not np.allclose(got, want, rtol=1e-6, atol=1e-3):
        raise AssertionError(f"the seeded weights differ from those the "
                             f"reference trained: {got} vs {want}")

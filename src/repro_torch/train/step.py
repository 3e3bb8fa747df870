"""The train step: state {params, opt, step}, batch -> state', metrics.

The port of ``repro.train.step``'s ``make_loss_fn``, ``make_train_step``
and ``init_state``, on one device.  Gradients come from
``torch.autograd.grad`` over the flattened param leaves (functional, as
``jax.value_and_grad``: no ``.grad`` is left on any tensor), the loss is
the backbone's features through the sequence-chunked CE, and optional
microbatch accumulation sums float32 gradients over ``accum_steps``
slices of the batch.  The step's metrics are the first microbatch's, taken
from the accumulation pass (the reference recomputes them; the values are
the same).

``state_specs`` and the sharded ``jit_train_step`` wait for the LM mesh
slice (``parallel/``): there is no mesh here.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.tree import flatten, unflatten


def make_loss_fn(arch, *, loss_chunk: int = 512):
    """Backbone features + sequence-chunked CE: the full (b, s, vocab)
    logits tensor never materialises (``loss.chunked_cross_entropy``)."""
    def loss_fn(params, batch):
        feats = arch.forward_features(params, batch)
        return chunked_cross_entropy(
            lambda x: arch.head(params, x), feats, batch["labels"],
            chunk=loss_chunk, mask=batch.get("mask"))
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``(grads, metrics)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``: the gradient tree has the params' structure and dtypes
    (zeros for a leaf the loss does not reach); the metrics are detached."""
    _, leaves = flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_fn(unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                    materialize_grads=True)
    return (unflatten(params, list(grads)),
            {k: v.detach() for k, v in metrics.items()})


def _microbatches(batch, accum_steps):
    """``accum_steps`` slices of the batch along its batch axis (dim 1 of
    the (3, B, S) M-RoPE ``positions``, dim 0 of everything else)."""
    out = [{} for _ in range(accum_steps)]
    for name, x in batch.items():
        dim = 1 if name == "positions" else 0
        if x.shape[dim] % accum_steps:
            raise ValueError(f"batch axis of {name} ({x.shape[dim]}) is not "
                             f"a multiple of accum_steps={accum_steps}")
        for mb, part in zip(out, torch.chunk(x, accum_steps, dim=dim)):
            mb[name] = part
    return out


def make_train_step(arch, optimizer, *, accum_steps: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``; pure: the input
    state is not modified."""
    loss_fn = make_loss_fn(arch)

    def step(state, batch):
        params = state["params"]
        if accum_steps == 1:
            grads, metrics = value_and_grad(loss_fn, params, batch)
        else:
            acc, metrics = None, None
            for mb in _microbatches(batch, accum_steps):
                g, m = value_and_grad(loss_fn, params, mb)
                g = [x.to(torch.float32) for x in flatten(g)[1]]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                metrics = metrics or m
            grads = unflatten(params, [a / accum_steps for a in acc])
        with torch.no_grad():
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state["opt"], params)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, dict(metrics, **opt_metrics))

    return step


def init_state(arch, optimizer, seed: int = 0, device=None) -> dict:
    """``{params, opt, step}`` on ``device`` (None: the card): the params
    drawn by ``arch.init`` from ``torch.Generator(device).manual_seed
    (seed)``, the optimizer's fresh state, an int32 step 0."""
    dev = resolve_device(device)
    params = arch.init(torch.Generator(dev).manual_seed(seed))
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}

"""The optimizer of the RL stack: AdamW over nested trees of tensors.

The part of ``repro.train.optim`` that ``repro.rl`` uses, written out by
hand rather than taken from ``torch.optim.AdamW``, whose step differs:
here the gradients are clipped by their global norm before the moments,
b2 is 0.95, the decoupled decay is added to the step inside the learning
rate, and the bias correction reads an int32 step count.  An optimizer is
an ``(init, update)`` pair over the nested dicts, lists and NamedTuples of
``repro_torch.tree`` (leaf order as the reference's ``jax.tree_util``), so
its state checkpoints like any other tree.

The LM scaffolding's schedules and optimizers (``warmup_cosine``,
``adafactor``, ``sgdm``) wait for that slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state, stats)


def constant_lr(lr_value: float):
    """``step -> lr``: the same float32 rate at every step."""
    return lambda step: torch.tensor(lr_value, dtype=torch.float32,
                                     device=step.device)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32, leaf by leaf
    in tree order."""
    _, leaves = flatten(tree)
    total = 0
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return unflatten(grads, [g * scale for g in flatten(grads)[1]]), norm


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          grad_clip=1.0):
    """AdamW with global-norm clipping.  ``init(params)`` returns
    ``{"mu", "nu", "count"}`` (float32 moments shaped like ``params``, an
    int32 step count); ``update(grads, state, params)`` returns ``(params,
    state, {"grad_norm", "lr"})``.  Tensors are never written in place."""
    def init(params):
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in flatten(params)[1]]
        dev = zeros[0].device if zeros else None
        return {"mu": unflatten(params, zeros),
                "nu": unflatten(params, [z.clone() for z in zeros]),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        c = state["count"] + 1
        lr = lr_fn(c)
        cf = c.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=cf.device), cf)
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(flatten(grads)[1], flatten(state["mu"])[1],
                              flatten(state["nu"])[1], flatten(params)[1]):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            step = step + weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * step).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return (unflatten(params, new_p),
                {"mu": unflatten(params, new_m),
                 "nu": unflatten(params, new_v), "count": c},
                {"grad_norm": gnorm, "lr": lr})

    return Optimizer(init, update)

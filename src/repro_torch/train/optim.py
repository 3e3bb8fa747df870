"""Optimizers and LR schedules over nested trees of tensors.

The port of ``repro.train.optim``, written out by hand rather than taken
from ``torch.optim``, whose steps differ: gradients are clipped by their
global norm before the moments, the decoupled decay is added to the step
inside the learning rate, and the schedules and bias corrections read an
int32 step count in float32.  An optimizer is an ``(init, update)`` pair
over the nested dicts, lists and NamedTuples of ``repro_torch.tree`` (leaf
order as the reference's ``jax.tree_util``), so its state checkpoints like
any other tree.  Tensors are never written in place.

* ``adamw``     -- the default; float32 moments.
* ``adafactor`` -- factored second moment: O(n+m) state per (n, m) matrix
                   instead of O(n*m).  Its state per parameter is a dict
                   (``{"vr", "vc"}`` or ``{"v"}``), walked down to the
                   gradients' leaves only.
* ``sgdm``      -- baseline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.tree import flatten, flatten_up_to, unflatten


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state, stats)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """``step -> lr``: linear warm-up to ``peak_lr`` over ``warmup_steps``,
    then a cosine down to ``min_ratio * peak_lr`` at ``total_steps``, in
    float32 on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


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


def adafactor(lr_fn, decay=0.8, eps=1e-30, grad_clip=1.0,
              weight_decay=0.0, min_dim_size_to_factor=64):
    """Adafactor: ``init(params)`` returns ``{"m", "count"}``, where ``m``
    holds per param ``{"vr", "vc"}`` (row and column means of the squared
    gradient) when both of its last two dims are at least
    ``min_dim_size_to_factor``, else ``{"v"}``; ``beta = 1 - count**-decay``
    (0 at the first step); steps are clipped to RMS <= 1."""
    def factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def state_for(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        _, leaves = flatten(params)
        dev = leaves[0].device if leaves else None
        return {"m": unflatten(params, [state_for(p) for p in leaves]),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        c = state["count"] + 1
        lr = lr_fn(c)
        beta = 1.0 - c.to(torch.float32) ** -decay

        def upd(g, s, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                denom = torch.sqrt(r[..., None] * vc[..., None, :])
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                new_s = {"v": v}
            step = g / torch.clamp(denom, min=1e-30)
            # relative step-size clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(step * step))
            step = step / torch.clamp(rms, min=1.0)
            step = step + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype), new_s

        _, g_flat = flatten(grads)
        pairs = [upd(g, s, p) for g, s, p in zip(
            g_flat, flatten_up_to(grads, state["m"]), flatten(params)[1])]
        return (unflatten(params, [t[0] for t in pairs]),
                {"m": unflatten(grads, [t[1] for t in pairs]), "count": c},
                {"grad_norm": gnorm, "lr": lr})

    return Optimizer(init, update)


def sgdm(lr_fn, momentum=0.9, grad_clip=1.0):
    """SGD with momentum: ``init(params)`` returns ``{"mu", "count"}``."""
    def init(params):
        _, leaves = flatten(params)
        dev = leaves[0].device if leaves else None
        return {"mu": unflatten(params, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        c = state["count"] + 1
        lr = lr_fn(c)
        new_p, new_m = [], []
        for g, m, p in zip(flatten(grads)[1], flatten(state["mu"])[1],
                           flatten(params)[1]):
            m = momentum * m + g.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * m).to(p.dtype))
            new_m.append(m)
        return (unflatten(params, new_p),
                {"mu": unflatten(params, new_m), "count": c},
                {"grad_norm": gnorm, "lr": lr})

    return Optimizer(init, update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}

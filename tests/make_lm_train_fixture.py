"""Write ``tests/data/lm_train_qwen1p5_0p5b.npz`` from the JAX package.

The reference's ``repro.train.step.make_train_step`` (unsharded, under a
plain ``jax.jit``: its sharded ``jit_train_step`` raises under the
installed JAX, ROADMAP queue 3) trains qwen1.5-0.5b at full width over
``lm_fixture.param_tree``'s seeded weights for ``lm_train_fixture.STEPS``
steps, once in float32 and once in bfloat16 compute; the gradients are
``jax.value_and_grad`` of its ``make_loss_fn`` at each step's params:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/make_lm_train_fixture.py

(~2.5 GB of weights, ~15 GB of memory at its peak; a few minutes on the
CPU.)
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lm_fixture
import lm_train_fixture as ltf
from make_lm_fixture import reference_config
from repro.models.registry import make_arch
from repro.train import data as j_data
from repro.train import optim as j_optim
from repro.train.step import make_loss_fn, make_train_step


def tensors(tree) -> list:
    """The leaves of a JAX tree as CPU tensors (float32 copies)."""
    return [torch.from_numpy(np.array(x, np.float32))
            for x in jax.tree_util.tree_leaves(tree)]


def build(dtype: str, tree: dict, reduced: bool = False) -> dict:
    """The kept numbers of the reference's run in ``dtype`` over ``tree``
    (``lm_train_fixture.summarize``; ``reduced``: the tiny config)."""
    cfg = reference_config(lm_fixture.config(dtype, reduced))
    arch = make_arch(cfg)
    stream = ltf.data(cfg, j_data)
    batch = lambda i: {k: jnp.asarray(v)
                       for k, v in stream.batch_at(i).items()}
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    loss_fn = make_loss_fn(arch)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, _), g = grad_fn(params, batch(0))
    grads0 = tensors(g)
    del g
    opt = ltf.optimizer(j_optim)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    del params
    step = jax.jit(make_train_step(arch, opt), donate_argnums=0)
    metrics = []
    for i in range(ltf.STEPS):
        t0 = time.perf_counter()
        # the float64 norm of the step's gradient, from its own leaves
        (_, _), g = grad_fn(state["params"], batch(i))
        norm64 = ltf.norm64(tensors(g))
        del g
        state, m = step(state, batch(i))
        metrics.append({k: float(m[k]) for k in ltf.METRICS})
        metrics[-1]["grad_norm64"] = norm64
        print(f"{dtype} step {i}: {metrics[-1]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return ltf.summarize(grads0, tensors(state["params"]), metrics)


def main():
    t0 = time.perf_counter()
    tree = lm_fixture.param_tree(lm_fixture.config("float32"))
    data = {"checksum": lm_fixture.checksum(tree)}
    print(f"params built in {time.perf_counter() - t0:.1f} s", flush=True)
    for dtype in ltf.DTYPES:
        t1 = time.perf_counter()
        out = build(dtype, tree)
        data.update({f"{dtype}_{k}": v for k, v in out.items()})
        print(f"{dtype}: losses {out['loss'].tolist()}; "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    np.savez_compressed(ltf.PATH, **data)
    print(f"wrote {ltf.PATH} ({ltf.PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()

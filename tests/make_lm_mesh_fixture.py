"""Write ``tests/data/lm_mesh_train_qwen1p5_0p5b.npz`` from the JAX package.

The reference's sharded ``repro.train.step.jit_train_step`` on an Auto
(1, 1) mesh (its default meshes are Explicit under the installed JAX and
fail, ROADMAP queue 3) trains qwen1.5-0.5b at full width over
``lm_fixture.param_tree``'s seeded weights for ``lm_train_fixture.STEPS``
steps, once in float32 and once in bfloat16 compute
(``tests/lm_mesh_fixture.py`` says what is kept):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/make_lm_mesh_fixture.py

(~2.5 GB of weights; ~15 GB of memory at its peak; a few minutes on the
CPU.)
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

import lm_fixture
import lm_mesh_fixture as lmf
import lm_train_fixture as ltf
from make_lm_fixture import reference_config
from repro.models.registry import make_arch
from repro.parallel import act_sharding
from repro.train import data as j_data
from repro.train import optim as j_optim
from repro.train.step import jit_train_step


def build(dtype: str, tree: dict, reduced: bool = False) -> dict:
    """The kept numbers of the reference's sharded run in ``dtype`` over
    ``tree`` (``reduced``: the tiny config)."""
    cfg = reference_config(lm_fixture.config(dtype, reduced))
    arch = make_arch(cfg)
    stream = ltf.data(cfg, j_data)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    opt = ltf.optimizer(j_optim)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in stream.batch_at(0).items()}
    fn, _, state_sh, batch_sh = jit_train_step(arch, opt, mesh, shapes)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jax.device_put({"params": params, "opt": opt.init(params),
                            "step": jnp.zeros((), jnp.int32)}, state_sh)
    del params
    metrics = []
    for i in range(lmf.STEPS):
        t0 = time.perf_counter()
        batch = jax.device_put({k: jnp.asarray(v) for k, v in
                                stream.batch_at(i).items()}, batch_sh)
        state, m = fn(state, batch)
        metrics.append({k: float(m[k]) for k in lmf.METRICS})
        print(f"{dtype} step {i}: {metrics[-1]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    act_sharding.clear()
    final = [torch.from_numpy(np.array(x, np.float32))
             for x in jax.tree_util.tree_leaves(state["params"])]
    out = {k: np.array([m[k] for m in metrics], np.float64)
           for k in lmf.METRICS}
    index = ltf.probe_index([tuple(x.shape) for x in final])
    out["param_probe"] = ltf.leaf_stats(final, index)[0]
    return out


def main():
    t0 = time.perf_counter()
    tree = lm_fixture.param_tree(lm_fixture.config("float32"))
    data = {"checksum": lm_fixture.checksum(tree)}
    print(f"params built in {time.perf_counter() - t0:.1f} s", flush=True)
    for dtype in lmf.DTYPES:
        t1 = time.perf_counter()
        out = build(dtype, tree)
        data.update({f"{dtype}_{k}": v for k, v in out.items()})
        print(f"{dtype}: losses {out['loss'].tolist()}; "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    np.savez_compressed(lmf.PATH, **data)
    print(f"wrote {lmf.PATH} ({lmf.PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()

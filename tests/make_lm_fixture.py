"""Write ``tests/data/lm_serve_qwen1p5_0p5b.npz`` from the JAX package.

The reference's model functions (``repro.models.registry.make_arch``)
serve qwen1.5-0.5b at full width over ``lm_fixture.param_tree``'s seeded
weights, unsharded, in ``repro.serve.engine.ServeEngine.run``'s own loop
(:func:`reference_serve`), once in bfloat16 and once in float32:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/make_lm_fixture.py

(~2.5 GB of weights; a few minutes on the CPU.)  The reference's
``ServeEngine`` object itself cannot run unsharded: its constructor shards
the params, and prefill's embedding gather then raises under the
installed JAX (ROADMAP queue 3).
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

import lm_fixture
from repro.models.config import ModelConfig
from repro.models.registry import make_arch


def reference_config(cfg) -> ModelConfig:
    """The reference's ``ModelConfig`` with the port config's fields."""
    import dataclasses
    return ModelConfig(**dataclasses.asdict(cfg))


def reference_serve(arch, params, prompts, max_new, slots, max_len):
    """``ServeEngine.run``'s loop at temperature 0 for one batch of
    requests (at most ``slots``), on the model functions: left-padded
    prompts (token 0, no mask), one prefill (eager, as the engine calls
    it), then jitted decode steps.  Returns (tokens per request, the
    (slots, V) float32 logits of every step)."""
    if len(prompts) > slots:
        raise ValueError("one batch of requests only")
    decode = jax.jit(lambda p, b, c, pos: arch.decode_step(p, b, c, pos))
    max_prompt = max(len(p) for p in prompts)
    toks = np.zeros((slots, max_prompt), np.int32)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    last, caches = arch.prefill(params, {"tokens": jnp.asarray(toks)},
                                max_len)
    steps = [np.asarray(last[:, -1], np.float32)]
    tok = jnp.argmax(last[:, -1], axis=-1)
    out = [[] for _ in prompts]
    pos = max_prompt
    for j in range(max_new):
        for i in range(len(prompts)):
            out[i].append(int(tok[i]))
        if j == max_new - 1:
            break
        logits, caches = decode(params, {"tokens": tok[:, None].astype(
            jnp.int32)}, caches, pos)
        pos += 1
        steps.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1)
    return out, steps


def build(dtype: str, tree: dict, reduced: bool = False) -> dict:
    """The kept numbers of the reference's run in ``dtype`` over ``tree``
    (:func:`lm_fixture.summarize`, plus ``tokens``) and its raw step
    logits."""
    cfg = lm_fixture.config(dtype, reduced)
    arch = make_arch(reference_config(cfg))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens, steps = reference_serve(arch, params, lm_fixture.prompts(cfg),
                                    lm_fixture.MAX_NEW, lm_fixture.SLOTS,
                                    lm_fixture.MAX_LEN)
    out = lm_fixture.summarize(steps, lm_fixture.probe_ids(cfg))
    out["tokens"] = np.asarray(tokens, np.int64)
    return out, steps


def main():
    t0 = time.perf_counter()
    cfg = lm_fixture.config("float32")
    tree = lm_fixture.param_tree(cfg)
    data = {"checksum": lm_fixture.checksum(tree)}
    print(f"params built in {time.perf_counter() - t0:.1f} s")
    raw = {}
    for dtype in lm_fixture.DTYPES:
        t1 = time.perf_counter()
        out, raw[dtype] = build(dtype, tree)
        data.update({f"{dtype}_{k}": v for k, v in out.items()})
        print(f"{dtype}: tokens {out['tokens'].tolist()}; top-2 margins "
              f"min {out['margin'].min():.4f}; "
              f"{time.perf_counter() - t1:.1f} s")
    # the reference's own bfloat16 rounding, on identical inputs: the
    # prefill step's logits in bfloat16 against float32
    d = np.abs(raw["bfloat16"][0] - raw["float32"][0])
    print(f"prefill logits bfloat16 vs float32: max |d| {d.max():.4f}, "
          f"max |logit| {np.abs(raw['float32'][0]).max():.3f}")
    np.savez_compressed(lm_fixture.PATH, **data)
    print(f"wrote {lm_fixture.PATH} ({lm_fixture.PATH.stat().st_size} "
          f"bytes)")


if __name__ == "__main__":
    main()

"""What tensor-parallel training of the SSM / hybrid families costs and how
far its runs part, in both packages (the JAX package and the port, on the
CPU, gloo ranks through ``tests/torch_mesh.py``).

1. ``counts``: the all-reduces of one sharded train step on (1, 2) at the
   full configs' depth and the reduced configs' widths (zamba2-1.2b: 38
   layers, a shared block every 6; qwen1.5-0.5b: 24 layers), batch
   2 x 128: their number and each one's (shape, dtype).  At full width a
   (2, 128, d_model) float32 residual sum is 2 MiB (zamba2) or 1 MiB
   (qwen); the count does not depend on the width.
2. ``grads``: the step-1 gradient of zamba2 widened to d_model 512 in
   float32, in both packages from the reference's initial state, each on
   (1, 1) and (1, 2), leaf by leaf (the largest gap over the leaf's
   largest |g|, and the gap of its norm): how far each package's meshes
   part, and the port from the reference, at 2, 6, 12 and 38 layers.
3. ``drift``: the losses of zamba2 widened to d_model 512 (the reduced
   config's bfloat16 compute, 12 layers, a shared block every 6, 3 AdamW
   steps) from the reference's initial state, the
   reference's own sharded loop and the port's, each on (1, 1) and (1, 2).
4. ``yi``: reduced yi-6b's 10 AdamW steps on (2, 2) against the
   reference's (``tests/test_torch_lm_mesh_train_gqa_dp.py``'s run): the
   largest relative gap over the first 4 steps and over all 10.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/survey_mesh_ssm.py \
        [counts] [grads] [drift] [yi]

``grads`` ~8 min, the others ~1 min each; all four without arguments.
"""
import collections
import sys
import tempfile
from pathlib import Path

import numpy as np

import lm_mesh_parity as lmp
import torch_mesh

WIDE = {"d_model": 512, "d_ff": 2048, "vocab_size": 4096}


def ranks(job, world):
    return torch_mesh.run_ranks(job, world, tempfile.mkdtemp())


def counts():
    for arch, over in (("zamba2-1.2b", {"n_layers": 38,
                                        "hybrid_attn_every": 6}),
                       ("qwen1.5-0.5b", {"n_layers": 24})):
        run = dict(lmp.ADAMW, arch=arch, cfg=over, mesh=(1, 2), steps=1,
                   batch=(2, 128))
        step = ranks({"name": "lm_step", "runs": [run]}, 2)[0][0]["steps"][0]
        kinds = collections.Counter(map(tuple, step["all_reduces"]))
        print(f"counts {arch} {over} (1, 2): {len(step['all_reduces'])} "
              f"all-reduces a step; by (shape, dtype): "
              f"{dict(kinds.most_common())}")


def _gap(a, b) -> float:
    """The largest |a - b| over the largest |b|."""
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _norm_gap(a, b) -> float:
    return abs(float(np.linalg.norm(a)) / float(np.linalg.norm(b)) - 1)


def grads(layer_counts=(2, 6, 12, 38)):
    """The step-1 gradients of zamba2 widened to d_model 512, float32
    compute (as phase 19 of ``chip_smoke.py`` trains it), batch 2 x 128,
    from the reference's initial state: the reference's and the port's,
    each on (1, 1) and (1, 2); per leaf the largest gap over the leaf's
    largest |g| and the gap of its norm, (1, 2) against (1, 1) in each
    package and the port's (1, 1) against the reference's."""
    meshes = [(1, 1), (1, 2)]
    for layers in layer_counts:
        cfg = dict(WIDE, n_layers=layers, hybrid_attn_every=6,
                   dtype="float32")
        run = dict(lmp.ADAMW, arch="zamba2-1.2b", cfg=cfg, batch=(2, 128))
        d = Path(tempfile.mkdtemp())
        ref = lmp.reference_grads(run, meshes, d)
        port = lmp.port_grads(run, meshes, d)
        print(f"grads zamba2 d_model 512, {layers} layers, float32, step-1 "
              f"gradient: largest |d| over the leaf's largest |g| / rel "
              f"gap of the leaf's norm; reference (1, 2) vs (1, 1) | port "
              f"(1, 2) vs (1, 1) | port (1, 1) vs reference (1, 1); "
              f"(leaf norm)")
        worst = np.zeros(6)
        for key, want in ref[(1, 1)].items():
            pairs = ((ref[(1, 2)][key], want),
                     (port[(1, 2)][key], port[(1, 1)][key]),
                     (port[(1, 1)][key], want))
            row = np.array([f(a, b) for a, b in pairs
                            for f in (_gap, _norm_gap)])
            worst = np.maximum(worst, row)
            print(f"  {key}: " + " | ".join(
                f"{row[2 * i]:.2e} / {row[2 * i + 1]:.2e}"
                for i in range(3))
                + f" ({float(np.linalg.norm(want)):.4g})")
        total = {k: float(np.sqrt(sum(float(np.square(x.astype(
            np.float64)).sum()) for x in g.values())))
            for k, g in (("ref (1, 1)", ref[(1, 1)]),
                         ("ref (1, 2)", ref[(1, 2)]),
                         ("port (1, 1)", port[(1, 1)]),
                         ("port (1, 2)", port[(1, 2)]))}
        print(f"  largest over the leaves: " + " | ".join(
            f"{worst[2 * i]:.2e} / {worst[2 * i + 1]:.2e}"
            for i in range(3)))
        print(f"  global norms {total}; reference (1, 2)/(1, 1) rel "
              f"{abs(total['ref (1, 2)'] / total['ref (1, 1)'] - 1):.2e}, "
              f"port (1, 2)/(1, 1) rel "
              f"{abs(total['port (1, 2)'] / total['port (1, 1)'] - 1):.2e}"
              f", port/reference (1, 1) rel "
              f"{abs(total['port (1, 1)'] / total['ref (1, 1)'] - 1):.2e}",
              flush=True)


def drift():
    cfg = dict(WIDE, n_layers=12, hybrid_attn_every=6)
    runs = [dict(lmp.ADAMW, arch="zamba2-1.2b", cfg=cfg, mesh=m, steps=3,
                 batch=(2, 128)) for m in ((1, 1), (1, 2))]
    for run, ref in zip(runs, lmp.reference_losses(runs)):
        d = Path(tempfile.mkdtemp())
        port = torch_mesh.run_ranks(
            {"name": "lm_train",
             "runs": [lmp.start_from_reference(run, d / "ckpt")]},
            run["mesh"][1], d)[0][0]["hist"]
        print(f"drift zamba2 d_model 512, 12 layers, {run['mesh']}: "
              f"reference {ref}, port {port}")


def yi():
    run = dict(lmp.ADAMW, arch="yi-6b", mesh=(2, 2))
    want = np.array(lmp.reference_losses([run])[0])
    d = Path(tempfile.mkdtemp())
    got = np.array(torch_mesh.run_ranks(
        {"name": "lm_train", "runs": [lmp.start_from_reference(run,
                                                              d / "ckpt")]},
        4, d)[0][0]["hist"])
    rel = np.abs(got / want - 1)
    print(f"yi yi-6b (2, 2) against the reference: first 4 steps "
          f"{rel[:4].max():.3e}, all 10 {rel.max():.3e}")


PARTS = {"counts": counts, "grads": grads, "drift": drift, "yi": yi}

if __name__ == "__main__":
    for name in sys.argv[1:] or PARTS:
        PARTS[name]()

"""Serving launcher: batched generation with the slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --requests 8 --max-new 16 [--device cpu]

Without ``--device`` it serves on the card and raises on a host without
one.  It serves through ``ServeEngine(arch, make_host_mesh(1, 1))``, as
the reference's launcher does, inside the initialised default process
group or a 1-rank one it makes (``launch.train.default_group``: gloo on
the CPU, NCCL on the card).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch.train import default_group
    from repro_torch.models.registry import make_arch
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(args.arch, reduced=args.reduced)
    arch = make_arch(cfg)
    dev = resolve_device(args.device)
    with default_group(dev):
        eng = ServeEngine(arch, make_host_mesh(1, 1, device=dev),
                          batch_slots=args.batch_slots, max_len=args.max_len,
                          temperature=args.temperature)
        rng = np.random.default_rng(0)
        for _ in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, rng.integers(4, 24))
            eng.submit(prompt, max_new_tokens=args.max_new)
        out = eng.run()
    print(f"# served {len(out['results'])} requests, "
          f"{out['n_tokens']} tokens at {out['tokens_per_s']:.1f} tok/s")
    for rid, toks in sorted(out["results"].items())[:4]:
        print(f"request {rid}: {toks}")
    return out


if __name__ == "__main__":
    main()

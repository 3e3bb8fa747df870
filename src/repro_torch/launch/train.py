"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 300 --ckpt-dir ckpts/q05 [--device cpu]

Without ``--device`` it trains on the card and raises on a host without
one.  ``--reduced`` picks the tiny same-family config.  Resume is the
default: the latest atomic checkpoint under ``--ckpt-dir`` is picked up
(``--no-resume`` starts afresh); SIGTERM triggers a final save.
``--mesh`` takes ``host`` only: ``host:DxM`` waits for the LM mesh slice.
The token streams feed the decoder-only families that read tokens; the
VLM and encoder-decoder families, whose inputs include frontend
embeddings, are refused (the reference's launcher fails on them at the
first step).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    """Run the CLI on ``argv``; returns the loss history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgdm"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--data", default=None,
                    help="path to an int32 .bin token file (memmap); "
                         "synthetic stream if omitted")
    ap.add_argument("--mesh", default="host",
                    help="host (one device); host:<data>x<model> comes with "
                         "the LM mesh slice")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: LM meshes come with the LM mesh slice "
            f"(parallel/); use --mesh host")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_arch
    from repro_torch.train import optim
    from repro_torch.train.data import MemmapLM, SyntheticLM
    from repro_torch.train.loop import train

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family in ("vlm", "encdec"):
        # the token streams carry no stub frontend embeddings
        ap.error(f"--arch {args.arch}: the {cfg.family} family takes "
                 f"frontend embeddings the token streams do not carry; "
                 f"train it through train.loop.train with a data source "
                 f"that gives them")
    arch = make_arch(cfg)
    lr = optim.warmup_cosine(args.lr, max(args.steps // 20, 5), args.steps)
    optimizer = optim.OPTIMIZERS[args.optimizer](lr)
    if args.data:
        data = MemmapLM(args.data, args.batch, args.seq_len)
    else:
        data = SyntheticLM(cfg.vocab_size, args.batch, args.seq_len,
                           seed=args.seed)
    n = transformer.param_count(arch.init(torch.Generator(), device="meta"))
    print(f"# arch={cfg.name} params={n/1e6:.1f}M mesh={args.mesh} "
          f"optimizer={args.optimizer}")
    _, history = train(arch, optimizer, None, data, steps=args.steps,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       accum_steps=args.accum, seed=args.seed,
                       resume=not args.no_resume, device=args.device)
    return history


if __name__ == "__main__":
    main()

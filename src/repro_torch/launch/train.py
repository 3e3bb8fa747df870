"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 300 --ckpt-dir ckpts/q05 [--device cpu]

Without ``--device`` it trains on the card and raises on a host without
one.  ``--reduced`` picks the tiny same-family config.  Resume is the
default: the latest atomic checkpoint under ``--ckpt-dir`` is picked up
(``--no-resume`` starts afresh); SIGTERM triggers a final save.

It trains through the sharded step on a mesh, as the reference's launcher
does: ``--mesh host`` is ``parallel.mesh.make_host_mesh(1, 1)``, ``--mesh
host:DxM`` a (D, M) mesh over the ranks of the default process group
(``(world, 1)`` when D * M exceeds them).  When no default group exists
the launcher makes a 1-rank one (gloo on the CPU, NCCL on the card) and
destroys it on exit; to run D * M ranks, start them with the group
initialised (``torch.distributed.init_process_group``) and call
:func:`main` on each.  So even ``--mesh host`` computes the layers on
bfloat16-rounded weights (``parallel.act_sharding.gather_layer_params``),
as the reference's launcher does.

The token streams feed the decoder-only families that read tokens; the
VLM and encoder-decoder families, whose inputs include frontend
embeddings, are refused (the reference's launcher fails on them at the
first step).
"""
from __future__ import annotations

import argparse
import contextlib


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
                    help="host | host:<data>x<model>")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.mesh == "host":
        shape = (1, 1)
    elif args.mesh.startswith("host:"):
        d, m = args.mesh.split(":")[1].split("x")
        shape = (int(d), int(m))
    else:
        ap.error(f"--mesh {args.mesh}: host | host:<data>x<model>")

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_arch
    from repro_torch.parallel.mesh import make_host_mesh
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
    dev = resolve_device(args.device)
    with default_group(dev):
        mesh = make_host_mesh(*shape, device=dev)
        print(f"# arch={cfg.name} params={n/1e6:.1f}M mesh={mesh.shape} "
              f"optimizer={args.optimizer}")
        _, history = train(arch, optimizer, mesh, data, steps=args.steps,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           accum_steps=args.accum, seed=args.seed,
                           resume=not args.no_resume)
    return history


@contextlib.contextmanager
def default_group(device):
    """The initialised default process group, or a 1-rank one made here
    (``launch.dryrun.one_rank_group``: gloo on the CPU, NCCL on the card)
    and destroyed on exit."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import one_rank_group
    if dist.is_initialized():
        yield
        return
    with one_rank_group(device):
        yield


if __name__ == "__main__":
    main()

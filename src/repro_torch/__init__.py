"""CRRM in PyTorch for NVIDIA Hopper.

The same layout and names as the JAX package ``repro``: ``core`` (params,
the smart-update graph, the ``CRRM`` API), ``sim`` (the radio chain and its
physics leaves), ``mac`` (traffic, scheduler, the TTI engine) and
``kernels`` (the hand-written CUDA kernel behind the fused backend).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); nothing falls back from one to the other.  The
``core.distributed`` mesh shards the engine over ``torch.distributed``
ranks.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


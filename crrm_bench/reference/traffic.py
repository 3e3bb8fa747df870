"""Vectorised traffic sources: offered load per UE per TTI.

Each model is a pair ``(init_backlog, step)``:

* ``init_backlog() -> (n_ues,) float32`` -- the t=0 buffer contents in bits
  (``inf`` for full buffer);
* ``step(gen) -> (n_ues,) float32`` -- fresh arrival bits for one TTI,
  drawn with ``torch.poisson(..., generator=gen)`` on ``gen``'s device.

Models: ``full_buffer`` (infinite backlog, no arrivals), ``poisson``
(many small packets) and ``ftp3`` (few large files).
"""
from __future__ import annotations

import torch

TRAFFIC_MODELS = ("full_buffer", "poisson", "ftp3")


def make_traffic(name: str, n_ues: int, tti_s: float, *, device="cpu",
                 arrival_rate_hz: float = 200.0,
                 packet_size_bits: float = 12_000.0,
                 file_rate_hz: float = 0.5,
                 file_size_bits: float = 4_000_000.0):
    """Return ``(init_backlog, step)`` for the named model.  ``step`` is
    ``None`` for ``full_buffer``, which has no arrivals to draw."""
    if name == "full_buffer":
        def init_backlog():
            return torch.full((n_ues,), float("inf"), dtype=torch.float32,
                              device=device)

        return init_backlog, None

    if name == "poisson":
        lam, size = arrival_rate_hz * tti_s, packet_size_bits
    elif name == "ftp3":
        lam, size = file_rate_hz * tti_s, file_size_bits
    else:
        raise ValueError(
            f"unknown traffic model {name!r}; choose from {TRAFFIC_MODELS}")
    rate = torch.full((n_ues,), lam, dtype=torch.float32, device=device)

    def init_backlog():
        return torch.zeros((n_ues,), dtype=torch.float32, device=device)

    def step(gen: torch.Generator):
        return torch.poisson(rate, generator=gen) * size

    return init_backlog, step

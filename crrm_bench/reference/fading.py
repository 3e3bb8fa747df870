"""Fast fading models: Rayleigh power fading |h|^2 ~ Exp(1).

* wideband -- one draw per (UE, cell) link (:func:`rayleigh_power`);
* frequency-selective -- one draw per coherence block of consecutive
  resource blocks (:func:`block_rayleigh_power`), pooled to the
  link-adaptation resolution by :func:`pool_rb_subbands`.

Every draw takes an explicit ``torch.Generator`` and lands on its device.
"""
from __future__ import annotations

import torch


def rayleigh_power(gen: torch.Generator, shape, dtype=torch.float32):
    """IID exponential(1) power fading coefficients."""
    return torch.empty(shape, dtype=dtype, device=gen.device).exponential_(
        generator=gen)


def block_rayleigh_power(gen, n_ues, n_cells, n_rb, coherence_rb,
                         dtype=torch.float32):
    """Frequency-selective block fading: (n_ues, n_cells, n_rb) Exp(1) power.

    RBs inside one coherence block of ``coherence_rb`` consecutive RBs share
    a draw; blocks are independent.
    """
    n_blocks = -(-n_rb // coherence_rb)          # ceil division
    draw = rayleigh_power(gen, (n_ues, n_cells, n_blocks), dtype)
    return torch.repeat_interleave(draw, coherence_rb, dim=2)[:, :, :n_rb]


def pool_rb_subbands(fad_rb, n_rb_subbands):
    """Pool a per-RB tensor (..., n_rb) to (..., n_rb_subbands) by the mean
    power over each reported subband's RBs."""
    n_rb = fad_rb.shape[-1]
    if n_rb % n_rb_subbands:
        raise ValueError(
            f"n_rb_subbands={n_rb_subbands} must divide n_rb={n_rb}")
    shape = fad_rb.shape[:-1] + (n_rb_subbands, n_rb // n_rb_subbands)
    return fad_rb.reshape(shape).mean(dim=-1)


def subband_rayleigh_power(gen, n_ues, n_cells, n_rb, coherence_rb,
                           n_rb_subbands, dtype=torch.float32):
    """Block fading drawn per RB, reported at link-adaptation resolution:
    (n_ues, n_cells, n_rb_subbands)."""
    fad = block_rayleigh_power(gen, n_ues, n_cells, n_rb, coherence_rb, dtype)
    return pool_rb_subbands(fad, n_rb_subbands)

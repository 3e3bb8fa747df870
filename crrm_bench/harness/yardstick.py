"""Frozen yardsticks: the H100's published peaks and the work of one
``fused_sinr`` call, copied here so that a kernel's bound reads the same
work whatever later implements it.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates; float32 outside the tensor cores.  The card's power limit is
printed beside every run, since a card set below 700 W runs slower.

``fused_sinr_work``: the float32 operations per link of the function as
its plain version writes it (distance 11, UMa / UMi pathloss and power
36, per frequency chunk 6, argmax 1, sector pattern 12), times the links;
and the bytes read once and written once.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12      # flop/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # bytes/s, HBM3

OPS_DIST = 11
OPS_SECTOR = 12
#: pathloss + power, by the model's name in ``CRRM_parameters``
OPS_MODEL = {"RMa": 60, "RMa_discretised": 30, "UMa": 36, "UMi": 36,
             "InH": 16, "power_law": 3}
OPS_PER_K = 6
OPS_ARGMAX = 1


def fused_sinr_work(rows: int, cells: int, k: int, model: str,
                    n_sectors: int, fad_floats: int = 0,
                    idx_bytes: int = 0):
    """``(operations, bytes)`` of one call on ``rows`` UE rows against
    ``cells`` cells and ``k`` frequency chunks."""
    in_bytes = (4 * (3 * rows + 3 * cells + cells * k + cells)
                + 4 * fad_floats + idx_bytes)
    out_bytes = 4 * (2 * rows * k + 2 * rows)
    ops = rows * cells * (OPS_DIST + OPS_MODEL[model] + k * OPS_PER_K
                          + OPS_ARGMAX + (OPS_SECTOR if n_sectors > 1 else 0))
    return ops, in_bytes + out_bytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S)

"""Roofline model: the three-term analysis over run artifacts.

Hardware constants, one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W power limit):

    float32 outside the tensor cores   67 TFLOP/s
    HBM3 bandwidth                     3.35 TB/s
    NVLink 4                           450 GB/s per direction

CRRM's work is float32 elementwise arithmetic, so the compute peak is the
fp32 rate, not a tensor-core rate (the reference's 197e12 is a TPU's bf16
rate).

    compute term    = flops / (chips * peak)
    memory term     = bytes / (chips * HBM_bw)
    collective term = wire_bytes_per_device / link_bw

The machine the port is measured on has one card, so the collective term
is a record of the bytes the mesh would move (counted by
``core.distributed``), not a measured link.  The dominant term is the
step's lower bound; the roofline fraction is useful model flops over what
the chips could do in that time.  Run as a module to print the table of
the artifacts under a directory:

    PYTHONPATH=src python -m repro_torch.analysis.roofline [--dir artifacts/dryrun]
"""
from __future__ import annotations

import dataclasses
import json
import os

PEAK_FLOPS = 67e12       # float32 outside the tensor cores, flop/s / card
HBM_BW = 3.35e12         # HBM3, bytes/s / card
ICI_BW = 450e9           # NVLink 4, bytes/s per direction / card


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops: how much counted compute is
        useful."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful model flops over what the chips could do in the bound
        time."""
        cap = self.bound_s * self.chips * PEAK_FLOPS
        return self.model_flops / cap if cap > 0 else 0.0


def model_flops_train(n_params_active: float, tokens: float) -> float:
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens


def from_artifact(art: dict) -> Roofline:
    """Prefers the analytic flops/bytes (written formulas: the port has no
    compiler cost analysis) and falls back to ``hlo_flops``/``hlo_bytes``
    where an artifact carries those instead."""
    chips = art["n_devices"]
    flops = art.get("analytic_flops") or art["hlo_flops"]
    bytes_ = art.get("analytic_bytes") or art["hlo_bytes"]
    return Roofline(
        compute_s=flops / (chips * PEAK_FLOPS),
        memory_s=bytes_ / (chips * HBM_BW),
        collective_s=art["collective_wire_bytes"] / ICI_BW,
        model_flops=art["model_flops"],
        hlo_flops=flops,
        chips=chips,
    )


def format_row(name: str, art: dict) -> str:
    r = from_artifact(art)
    return (f"| {name} | {r.compute_s*1e3:.1f} | {r.memory_s*1e3:.1f} | "
            f"{r.collective_s*1e3:.1f} | {r.dominant} | "
            f"{r.useful_flops_ratio:.2f} | {r.roofline_fraction:.3f} |")


def main(art_dir: str = "artifacts/dryrun"):
    print("| cell | compute ms | memory ms | collective ms | dominant | "
          "useful/HLO | roofline frac |")
    print("|---|---|---|---|---|---|---|")
    for root, _, files in sorted(os.walk(art_dir)):
        for f in sorted(files):
            if not f.endswith(".json"):
                continue
            with open(os.path.join(root, f)) as fh:
                art = json.load(fh)
            if art.get("skipped"):
                name = os.path.relpath(os.path.join(root, f), art_dir)
                print(f"| {name} | - | - | - | skipped: "
                      f"{art['reason'][:40]} | - | - |")
                continue
            name = os.path.relpath(os.path.join(root, f),
                                   art_dir).replace(".json", "")
            print(format_row(name, art))


if __name__ == "__main__":
    import sys
    main(sys.argv[sys.argv.index("--dir") + 1]
         if "--dir" in sys.argv else "artifacts/dryrun")

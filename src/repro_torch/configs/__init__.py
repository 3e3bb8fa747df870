"""Architecture configs: the workloads ``launch/dryrun.py`` runs.

``ARCH_IDS`` holds ``crrm-ppp`` only, the paper's own PPP network
(:mod:`repro_torch.configs.crrm_ppp`).  The reference's LM configs come
with the LM scaffolding, which is not ported yet, so ``LM_ARCH_IDS`` is
empty.
"""
from __future__ import annotations

from repro_torch.configs import crrm_ppp

ARCH_IDS = [crrm_ppp.ARCH_ID]
LM_ARCH_IDS: list = []

"""Assigned-architecture configs (exact shapes from public literature).

``get_config(arch_id)`` resolves by the public arch id (with dashes);
``--arch`` flags across ``launch/`` use these ids.  ``ARCH_IDS`` holds the
ten LM architectures and ``crrm-ppp``, the paper's own PPP network
(:mod:`repro_torch.configs.crrm_ppp`, run by ``launch/dryrun.py``);
``LM_ARCH_IDS`` the ten LMs, served by ``serve/engine.py``.
"""
from __future__ import annotations

import importlib

_MODULES = [
    "zamba2_1p2b", "deepseek_moe_16b", "granite_moe_1b", "codeqwen1p5_7b",
    "deepseek_67b", "yi_6b", "qwen1p5_0p5b", "qwen2_vl_72b",
    "falcon_mamba_7b", "seamless_m4t_large", "crrm_ppp",
]

ARCH_IDS = []
_BY_ID = {}
for _m in _MODULES:
    _mod = importlib.import_module(f"repro_torch.configs.{_m}")
    ARCH_IDS.append(_mod.ARCH_ID)
    _BY_ID[_mod.ARCH_ID] = _mod

LM_ARCH_IDS = [a for a in ARCH_IDS if a != "crrm-ppp"]


def get_config(arch_id: str, reduced: bool = False):
    """The ``ModelConfig`` of an LM arch id (``reduced``: its tiny
    same-family config); None for ``crrm-ppp``, which is not an LM."""
    cfg = _BY_ID[arch_id].config()
    return cfg.reduced() if reduced and cfg is not None else cfg

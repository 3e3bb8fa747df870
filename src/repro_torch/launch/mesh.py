"""Production mesh definition: the named meshes of the dry-run.

The port of ``repro.launch.mesh``.  Every named mesh is a
``parallel.mesh.ShapeMesh`` (axis names and sizes, no ranks): pod and
multipod do not fit one host, and the dry-run only reckons over them.
"""
from __future__ import annotations

from repro_torch.parallel.mesh import ShapeMesh, make_production_mesh

__all__ = ["make_production_mesh", "make_named_mesh"]


def make_named_mesh(name: str) -> ShapeMesh:
    """Mesh presets: 'pod' (16x16), 'multipod' (2x16x16), plus the tiny
    variants 'tiny' (2x4) and 'tinypod' (2x2x2) of the same code paths."""
    if name == "pod":
        return make_production_mesh(multi_pod=False)
    if name == "multipod":
        return make_production_mesh(multi_pod=True)
    if name == "tiny":
        return ShapeMesh((2, 4), ("data", "model"))
    if name == "tinypod":
        return ShapeMesh((2, 2, 2), ("pod", "data", "model"))
    raise ValueError(f"unknown mesh {name!r}")

"""Shared helpers of the mesh-rule parity tests
(``tests/test_torch_parallel_*.py``): the named meshes as the reference's
shape-only ``AbstractMesh`` (Auto axes) and the port's ``ShapeMesh``, both
packages' strategies set together, and spec trees flattened to
``{key path: spec}`` for an exact comparison.

The rules read only ``mesh.shape`` and ``mesh.axis_names``, so every
comparison runs in the pytest process on all four named shapes, with no
device.
"""
import jax
import pytest
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import PartitionSpec as JP

from repro.parallel import act_sharding as j_act
from repro.parallel import mesh as j_mesh
from repro_torch.launch.mesh import make_named_mesh
from repro_torch.parallel import act_sharding as t_act
from repro_torch.parallel import mesh as t_mesh
from repro_torch.parallel.sharding import spec_leaves  # noqa: F401
from repro_torch.tree import flatten

#: the reference's named meshes (``repro/launch/mesh.py``): shape, axes
NAMED = {"pod": ((16, 16), ("data", "model")),
         "multipod": ((2, 16, 16), ("pod", "data", "model")),
         "tiny": ((2, 4), ("data", "model")),
         "tinypod": ((2, 2, 2), ("pod", "data", "model"))}
STRATEGIES = ("2d", "dp")


def ref_mesh(name):
    shape, axes = NAMED[name]
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def meshes(name):
    """(reference AbstractMesh, port ShapeMesh) of a named mesh."""
    return ref_mesh(name), make_named_mesh(name)


@pytest.fixture
def strategy():
    """``set(mode)`` sets both packages' process-global strategy; both
    strategies and both activation registries are reset after the test
    (xdist reuses workers)."""
    def set_(mode):
        j_mesh.set_strategy(mode)
        t_mesh.set_strategy(mode)
    yield set_
    set_("2d")
    j_act.clear()
    t_act.clear()


def _axes(a):
    """One entry of a spec: a tuple of one axis is that axis (as JAX's
    PartitionSpec writes it: ``P(("data",)) == P("data")``)."""
    if isinstance(a, (tuple, list)):
        return a[0] if len(a) == 1 else tuple(a)
    return a


def norm(spec):
    """A spec (either package's) as a plain tuple of entries."""
    if spec is None:
        return None
    return tuple(_axes(a) for a in spec)


def ref_specs(tree):
    """{key path: spec} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): norm(s) for path, s in flat}


def port_specs(shapes, tree):
    """{key path: spec} of a port spec tree over the leaves of
    ``shapes``."""
    keys, _ = flatten(shapes)
    return dict(zip(keys, [norm(s) for s in spec_leaves(tree)]))


def ref_shapes(tree):
    """{key path: (shape, dtype name)} of a reference shape tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def port_shapes(tree):
    keys, leaves = flatten(tree)
    return {k: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for k, x in zip(keys, leaves)}

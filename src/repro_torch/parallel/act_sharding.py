"""Activation sharding hooks and the per-layer ZeRO-3 weight gather.

The port of ``repro.parallel.act_sharding``.  The registry is
process-global and set by the step builders (``train.step.jit_train_step``)
before the model runs; model code calls the hooks at the reference's
places, and every hook is the identity when no sharding is registered.

In the reference each ``constrain*`` hook hands GSPMD a layout for an
activation (residuals sequence-sharded on ``model``, heads and experts on
``model``, tokens on the batch axes).  A layout constraint never changes
values, and in this port the ``model`` axis shards storage, not compute:
every rank holds its batch block's activations whole.  So each hook
returns its tensor unchanged, and the layout it would choose is a pure
function of the registry and the shape (:func:`residual_spec`,
:func:`heads_spec`, :func:`expert_spec`, :func:`ec_spec`,
:func:`tokens_spec`, :func:`layer_param_specs`; None where the reference
leaves the tensor unconstrained).

:func:`gather_layer_params` does the work of the reference's FSDP gather:
inside a sharded train step (:func:`zero3`) each leaf of one layer goes
from the rank's block to the full leaf (``parallel.zero.gather``, whose
backward sums the gradient over the batch axes and keeps the block).  As
in the reference, float32 leaves outside :data:`_F32_KEEP` are cast to
bfloat16 on the way, under any mesh, a (1, 1) one included: the sharded
step computes on bfloat16-rounded layer weights where the unsharded one
does not.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch.core.distributed import NamedSharding
from repro_torch.core.distributed import PartitionSpec as P
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import zero
from repro_torch.parallel.mesh import (axis_size, batch_axes, get_strategy,
                                       tp_size)
from repro_torch.tree import flatten, unflatten

_REGISTRY: dict = {}


def set_mesh_shardings(mesh) -> None:
    """Register default activation shardings for ``mesh`` (respects the
    active parallelism strategy -- see parallel.mesh.set_strategy)."""
    ba = batch_axes(mesh)
    _REGISTRY.clear()
    _REGISTRY["mesh"] = mesh
    _REGISTRY["strategy"] = get_strategy()
    if get_strategy() == "dp":
        _REGISTRY["residual"] = NamedSharding(mesh, P(ba, None, None))
        _REGISTRY["residual_b1"] = NamedSharding(mesh, P(None, None, None))
    else:
        _REGISTRY["residual"] = NamedSharding(mesh, P(ba, "model", None))
        _REGISTRY["residual_b1"] = NamedSharding(mesh,
                                                 P(None, "model", None))
    # SSM residuals: the time scan needs the whole (ordered) sequence per
    # shard -- batch only
    _REGISTRY["residual_ssm"] = NamedSharding(mesh, P(ba, None, None))
    _REGISTRY["dp_size"] = axis_size(mesh, ba)
    _REGISTRY["mp_size"] = tp_size(mesh)


def clear() -> None:
    _REGISTRY.clear()


# -- the layouts the hooks choose ---------------------------------------------
def heads_spec(shape) -> Optional[P]:
    """(b, s, h, hd): batch on the batch axes, heads on 'model'."""
    if not _REGISTRY or len(shape) != 4:
        return None
    mesh = _REGISTRY.get("mesh")
    b, s, h, hd = shape
    dp = _REGISTRY.get("dp_size", 1)
    mp = _REGISTRY.get("mp_size", 1)
    b_ax = batch_axes(mesh) if b % dp == 0 else None
    h_ax = "model" if (mp > 1 and h % mp == 0) else None
    if h_ax is None and b_ax is None:
        return None
    return P(b_ax, None, h_ax, None)


def expert_spec(shape) -> Optional[P]:
    """(b, E, C, d): batch on the batch axes, experts on 'model'."""
    if not _REGISTRY or len(shape) != 4:
        return None
    mesh = _REGISTRY.get("mesh")
    b, e = shape[0], shape[1]
    b_ax = batch_axes(mesh) if b % _REGISTRY["dp_size"] == 0 else None
    e_ax = "model" if (_REGISTRY["mp_size"] > 1
                       and e % _REGISTRY["mp_size"] == 0) else None
    if b_ax is None and e_ax is None:
        return None
    return P(b_ax, e_ax, None, None)


def ec_spec(shape) -> Optional[P]:
    """(b, E*C, d): the expert-slot axis on 'model' (where the reference's
    dispatch all-to-all happens)."""
    if not _REGISTRY or len(shape) != 3:
        return None
    mesh = _REGISTRY.get("mesh")
    b, ec = shape[0], shape[1]
    b_ax = batch_axes(mesh) if b % _REGISTRY["dp_size"] == 0 else None
    e_ax = "model" if (_REGISTRY["mp_size"] > 1
                       and ec % _REGISTRY["mp_size"] == 0) else None
    if b_ax is None and e_ax is None:
        return None
    return P(b_ax, e_ax, None)


def tokens_spec(shape) -> Optional[P]:
    """(b, T, d): data-parallel tokens (the MoE's return all-to-all)."""
    if not _REGISTRY or len(shape) != 3:
        return None
    mesh = _REGISTRY.get("mesh")
    if shape[0] % _REGISTRY["dp_size"] != 0:
        return None
    return P(batch_axes(mesh), None, None)


def residual_spec(shape, role: str = "residual") -> Optional[P]:
    """The registered layout of a (b, s, d) residual of ``role``, if the
    shape allows it."""
    if not _REGISTRY or len(shape) != 3:
        return None
    b, s, _ = shape
    mp = _REGISTRY.get("mp_size", 1)
    dp = _REGISTRY.get("dp_size", 1)
    if role == "residual_ssm":
        if b % dp != 0:
            return None
        return _REGISTRY["residual_ssm"].spec
    if s % mp != 0 or s == 1:
        return None  # decode steps / indivisible seq
    sh = _REGISTRY.get("residual" if b % dp == 0 else "residual_b1")
    return None if sh is None else sh.spec


# -- the hooks ------------------------------------------------------------------
def constrain_heads(x):
    return x


def constrain_expert(x):
    return x


def constrain_ec(x):
    return x


def constrain_tokens(x):
    return x


def constrain(x, role: str = "residual"):
    return x


# -- the per-layer weight gather -------------------------------------------------
_F32_KEEP = {"dt_proj", "dt_bias", "A_log", "D", "router"}


class Zero3(NamedTuple):
    """A sharded train step's layout, for :func:`gather_layer_params`:
    the mesh, each per-layer leaf's spec by its key path within a layer
    (the stacked leaf's spec without its layer dimension) and the axes
    whose ranks hold distinct batch blocks."""

    mesh: object
    layer_specs: dict
    grad_axes: tuple


_ZERO: dict = {}


@contextlib.contextmanager
def zero3(mesh, layer_specs: dict, grad_axes: tuple):
    """Inside the block the layer params the model passes to
    :func:`gather_layer_params` are this rank's blocks."""
    prev = _ZERO.get("state")
    _ZERO["state"] = Zero3(mesh, dict(layer_specs), tuple(grad_axes))
    try:
        yield
    finally:
        if prev is None:
            _ZERO.pop("state", None)
        else:
            _ZERO["state"] = prev


def _layer_spec(key, w):
    z = _ZERO.get("state")
    if z is not None:
        return z.layer_specs[key]
    return shd._param_rule(key, tuple(w.shape), _REGISTRY["mesh"])


def layer_param_specs(lp) -> Optional[dict]:
    """The reference's layout of each gathered layer weight: its spec with
    every axis but 'model' dropped (a tree like ``lp``); None without a
    registry."""
    if not _REGISTRY:
        return None
    keys, leaves = flatten(lp)
    return unflatten(lp, [P(*[a if a == "model" else None
                              for a in _layer_spec(k, w)])
                          for k, w in zip(keys, leaves)])


def _cast(key, w):
    name = key.split("/")[-1]
    if w.dtype == torch.float32 and name not in _F32_KEEP:
        return torch.bfloat16
    return None


def gather_layer_params(lp):
    """One layer's weights for its compute: float32 leaves outside
    :data:`_F32_KEEP` in bfloat16 values; inside :func:`zero3` gathered
    from the rank's blocks (and returned in their own dtype)."""
    z = _ZERO.get("state")
    if not _REGISTRY and z is None:
        return lp
    keys, leaves = flatten(lp)
    out = []
    for key, w in zip(keys, leaves):
        cast = _cast(key, w)
        if z is not None:
            out.append(zero.gather(w, z.mesh, z.layer_specs[key],
                                   z.grad_axes, cast))
        else:
            out.append(w if cast is None else w.to(cast))
    return unflatten(lp, out)

"""Activation sharding hooks, the per-layer ZeRO-3 weight gather and the
sharded compute's context.

The port of ``repro.parallel.act_sharding``.  The registry is
process-global and set by the step builders (``train.step.jit_train_step``)
before the model runs; model code calls the hooks at the reference's
places, and every hook is the identity when no sharding is registered.

In the reference each ``constrain*`` hook hands GSPMD a layout for an
activation, and GSPMD partitions the compute by the weights' layout.  Here
the layout is realised by the compute itself, inside :func:`zero3` (a
sharded train step, or ``serve.engine.ServeEngine`` on a mesh) when the
``model`` axis holds more than one rank (``parallel.tp``):

* heads on ``model`` (:func:`heads_spec`): ``models.attention`` projects
  the rank's heads from its ``wq``/``wk``/``wv`` blocks;
* experts and their slots on ``model`` (:func:`expert_spec`,
  :func:`ec_spec`): ``models.moe`` fills the rank's experts' slots of the
  dispatch buffer; tokens stay replicated along ``model``
  (:func:`tokens_spec`), so the combine is one psum and no all-to-all;
* Mamba channels and heads on ``model``: ``models.mamba`` computes on
  the rank's block of ``in_proj``'s x and z columns (``parallel.zero
  .block`` lays them out), of the conv, the scan and the ``h`` / ``conv``
  states; ``x_proj`` and ``out_proj`` are row-parallel;
* residuals ``P(batch, "model", None)`` (:func:`residual_spec`): inside a
  sharded train step :func:`constrain` cuts the residual carried between
  layers to the rank's sequence block, and :func:`unconstrain` assembles it
  at the next layer's entry; an SSM residual (``residual_ssm``: the SSM
  and hybrid stacks) stays whole, since the scan runs over the whole
  sequence.

So ``constrain_heads``, ``constrain_expert``, ``constrain_ec`` and
``constrain_tokens`` return their tensor unchanged, and the layout each
would choose stays a pure function of the registry and the shape
(:func:`residual_spec`, :func:`heads_spec`, :func:`expert_spec`,
:func:`ec_spec`, :func:`tokens_spec`, :func:`layer_param_specs`; None
where the reference leaves the tensor unconstrained).

:func:`gather_layer_params` does the work of the reference's FSDP gather:
inside :func:`zero3` each leaf of one layer goes from the rank's block to
the reference's ``model_only`` layout -- gathered over the batch axes,
its ``model`` dimension kept as the rank's block (``parallel.zero.gather``,
whose backward sums the gradient over the batch axes and keeps the
block).  The model reads which dimension of a weight is the rank's block
with :func:`tp_dim` / :func:`tp_axis`, which raise for a weight of unknown
layout.  A leaf whose spec has no ``model`` entry (one that does not
divide, or a replicated one) is gathered whole.  In a train step float32
leaves outside
:data:`_F32_KEEP` are cast to bfloat16 on the way, under any mesh, a
(1, 1) one included, as in the reference; the serving engine casts none.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.distributed import NamedSharding
from repro_torch.core.distributed import PartitionSpec as P
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tp, zero
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


def sequence_parallel(shape, role: str = "residual") -> bool:
    """Whether a residual of ``shape`` is carried as the rank's sequence
    block: inside a sharded train step whose ``model`` axis holds more
    than one rank, under the reference's conditions (not for
    ``residual_ssm``, a decode step or a sequence that does not divide)."""
    z = _ZERO.get("state")
    if z is None or not z.train or not tp.active(z.model) \
            or len(shape) != 3 or role == "residual_ssm":
        return False
    s = shape[1]
    return s % z.model.size == 0 and s != 1


def constrain(x, role: str = "residual"):
    """The residual ``x`` in its registered layout: under
    :func:`sequence_parallel` the rank's block of the sequence (whose
    backward assembles the blocks' gradients), else ``x`` itself."""
    if not sequence_parallel(x.shape, role):
        return x
    return tp.split(x, _ZERO["state"].model, 1)


def unconstrain(x, sp: bool):
    """The whole residual of the rank's block ``x`` (when ``sp``, the
    :func:`sequence_parallel` of the whole), else ``x``."""
    return tp.assemble(x, _ZERO["state"].model, 1) if sp else x


# -- the sharded compute's context ----------------------------------------------
_F32_KEEP = {"dt_proj", "dt_bias", "A_log", "D", "router"}


class Zero3(NamedTuple):
    """A sharded step's layout, for :func:`gather_layer_params`: the mesh,
    each per-layer leaf's spec by its key path within a layer (the stacked
    leaf's spec without its layer dimension), the axes whose ranks hold
    distinct batch blocks, whether it trains (cast, sequence-parallel
    residuals) and the ``model`` axis of the tensor-parallel compute
    (None under strategy ``"dp"``)."""

    mesh: object
    layer_specs: dict
    grad_axes: tuple
    train: bool
    model: object


_ZERO: dict = {}


@contextlib.contextmanager
def zero3(mesh, layer_specs: dict, grad_axes: tuple, train: bool = True):
    """Inside the block the layer params the model passes to
    :func:`gather_layer_params` are this rank's blocks, and the model
    computes tensor-parallel on ``model`` (``parallel.tp``)."""
    prev = _ZERO.get("state")
    model = mesh.axes("model") if tp_size(mesh) > 1 else None
    _ZERO["state"] = Zero3(mesh, dict(layer_specs), tuple(grad_axes),
                           train, model)
    try:
        yield
    finally:
        if prev is None:
            _ZERO.pop("state", None)
        else:
            _ZERO["state"] = prev


def sharded() -> bool:
    """Whether the model runs inside :func:`zero3`."""
    return "state" in _ZERO


def model_axis():
    """The ``model`` axis of the tensor-parallel compute, or None."""
    z = _ZERO.get("state")
    return None if z is None else z.model


_UNMARKED = object()


def tp_dim(w) -> Optional[int]:
    """The dimension of the weight ``w`` that is the rank's block on the
    tensor-parallel ``model`` axis (None: ``w`` is whole, or no such axis
    is active).  Inside a tensor-parallel :func:`zero3` every weight comes
    from :func:`gather_leaf`, which marks it; an unmarked weight there, or
    a marked block where no such axis is active, raises: its layout is
    unknown, and computing on it would return one rank's partial sum."""
    mark = getattr(w, "_model_dim", _UNMARKED)
    if model_axis() is None:
        if mark not in (_UNMARKED, None):
            raise ValueError("a weight's model block is computed on with "
                             "no tensor-parallel axis active")
        return None
    if mark is _UNMARKED:
        raise ValueError("a weight of a tensor-parallel step that did not "
                         "come through gather_leaf: its layout is unknown")
    return mark


def mark_slices(w, slices) -> None:
    """Give the layer ``slices`` of a stacked leaf ``w`` (its leading
    dimension unbound) the ``model`` dimension :func:`gather_leaf` marked
    on ``w``, if it marked one."""
    mark = getattr(w, "_model_dim", _UNMARKED)
    if mark is _UNMARKED:
        return
    for x in slices:
        x._model_dim = None if mark is None else mark - 1


def tp_axis(w, dim: int):
    """The ``model`` axis when the weight ``w`` is the rank's block of it
    on dimension ``dim`` (:func:`tp_dim`), else None."""
    return model_axis() if tp_dim(w) == dim else None


def check_whole(params, whole: dict) -> None:
    """Raise unless every leaf of ``params`` has its whole shape (``whole``:
    shape by key path): model code outside :func:`zero3` computes on whole
    weights only."""
    for key, w in zip(*flatten(params)):
        ref = whole.get(key)
        if ref is not None and tuple(w.shape) != ref:
            raise ValueError(f"params leaf {key} has shape "
                             f"{tuple(w.shape)}, not its whole "
                             f"{ref}: a mesh's blocks are "
                             f"computed on inside zero3 only (the sharded "
                             f"train step, ServeEngine(arch, mesh))")


def keep_spec(spec, keep_model: bool):
    """The spec a leaf is gathered to: its ``model`` entry kept (the
    reference's ``model_only``) or nothing kept."""
    return P(*[a if (keep_model and a == "model") else None for a in spec])


def gather_leaf(key, w, mesh, spec, grad_axes, cast=None, model=None):
    """One leaf from the rank's block under ``spec`` to its compute
    layout: whole, or with its ``model`` dimension kept when ``model`` is
    the tensor-parallel axis.  Under tensor parallelism the leaf is marked
    with that dimension, or None, for :func:`tp_dim`."""
    spec = zero.padded(spec, w.dim())
    target = keep_spec(spec, model is not None)
    gather_spec = P(*[None if t == "model" else a
                      for a, t in zip(spec, target)])
    out = zero.gather(w, mesh, gather_spec, grad_axes, cast)
    if model is not None:
        out._model_dim = (tuple(target).index("model")
                          if "model" in target else None)
    return out


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
    return unflatten(lp, [keep_spec(_layer_spec(k, w), True)
                          for k, w in zip(keys, leaves)])


def _cast(key, w):
    name = key.split("/")[-1]
    if w.dtype == torch.float32 and name not in _F32_KEEP:
        return torch.bfloat16
    return None


def gather_layer_params(lp):
    """One layer's weights for its compute: float32 leaves outside
    :data:`_F32_KEEP` in bfloat16 values (with a registry, or in a sharded
    train step); inside :func:`zero3` gathered from the rank's blocks to
    the ``model_only`` layout (and returned in their own dtype)."""
    z = _ZERO.get("state")
    if not _REGISTRY and z is None:
        return lp
    if z is not None and not z.train and \
            math.prod(z.mesh.shape.values()) == 1:
        return lp           # one rank, no cast: each leaf is its gather
    keys, leaves = flatten(lp)
    out = []
    for key, w in zip(keys, leaves):
        cast = _cast(key, w)
        if z is not None:
            out.append(gather_leaf(key, w, z.mesh, z.layer_specs[key],
                                   z.grad_axes, cast if z.train else None,
                                   z.model))
        else:
            out.append(w if cast is None else w.to(cast))
    return unflatten(lp, out)


# -- serving caches ----------------------------------------------------------------
def sharded_mesh():
    """The mesh of the enclosing :func:`zero3`, or None."""
    z = _ZERO.get("state")
    return None if z is None else z.mesh


def global_batch(b_local: int) -> int:
    """The global batch of a rank's batch block inside :func:`zero3` (the
    serving engine blocks the batch over the batch axes)."""
    mesh = sharded_mesh()
    return b_local if mesh is None else b_local * axis_size(
        mesh, batch_axes(mesh))


def cache_blocks(shapes, spec_tree, mesh, device) -> dict:
    """Zero-filled blocks of a cache tree of (meta) ``shapes`` under
    ``spec_tree``, each remembering its spec (:func:`cache_seq_axis`)."""
    keys, leaves = flatten(shapes)
    out = []
    for x, spec in zip(leaves, shd.spec_leaves(spec_tree)):
        shape = [n // (1 if a is None else axis_size(mesh, a))
                 for n, a in zip(x.shape, zero.padded(spec, x.dim()))]
        t = torch.zeros(shape, dtype=x.dtype, device=device)
        t._spec = zero.padded(spec, x.dim())
        out.append(t)
    return unflatten(shapes, out)


def cache_seq_axis(cache):
    """The ``model`` axis when the stacked KV ``cache`` (L, B, S, kv, hd)
    is the rank's block of the sequence, else None.  Inside
    :func:`zero3` the cache must come from ``init_cache(mesh=)``."""
    z = _ZERO.get("state")
    spec = getattr(cache, "_spec", None)
    if z is None:
        if spec is not None and any(a is not None for a in spec):
            raise ValueError("a cache block of a mesh is served inside "
                             "zero3 only")
        return None
    if spec is None:
        raise ValueError("a cache served on a mesh comes from "
                         "init_cache(mesh=): its layout is unknown")
    seq = spec[2]
    if seq is None:
        return None
    if seq != "model":
        raise ValueError(f"a KV cache sharded over {seq} on its sequence "
                         f"is not served")
    return z.mesh.axes("model")

"""Logical-axis sharding rules: param/cache/batch PartitionSpecs by path.

The port of ``repro.parallel.sharding``, over the port's
``core.distributed.PartitionSpec``/``NamedSharding``.
:func:`infer_param_specs` walks a params (or optimizer-state) tree and
assigns a spec to every leaf from its key path -- the param name carries
the semantics -- and divisibility against the mesh: a dimension is only
sharded when its size divides the axis size, with documented fallbacks
(GQA K/V heads smaller than the model axis fall back to sharding head_dim,
then replication).  A key path is ``tree.flatten``'s ``a/b/c`` string; the
rules read its components, as the reference reads its ``DictKey``s.

The rules are mesh-shape agnostic and read only ``mesh.shape`` and
``mesh.axis_names``, so they take a rank mesh (``core.distributed.Mesh``)
or a shape-only one (``parallel.mesh.ShapeMesh``).  Leaves need only a
``shape``: meta tensors reckon a full config without allocating.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.distributed import NamedSharding, PartitionSpec
from repro_torch.parallel.mesh import axis_size, batch_axes, get_strategy
from repro_torch.tree import flatten, unflatten

P = PartitionSpec


def _maybe(size: int, axis, mesh) -> Any:
    """Shard dim of ``size`` on ``axis`` only if divisible; else replicate."""
    if axis is None:
        return None
    if size % axis_size(mesh, axis) == 0:
        return axis
    return None


def _first_fit(shape, candidates, mesh):
    """'model' on the first listed dim that divides, then FSDP: the batch
    axes on the first *remaining* dim that divides (ZeRO-3 -- params, grads
    and moments all shard over data, gathered per layer)."""
    spec = [None] * len(shape)
    if get_strategy() != "dp":
        for dim in candidates:
            if shape[dim] % axis_size(mesh, "model") == 0:
                spec[dim] = "model"
                break
    ba = batch_axes(mesh)
    dp = axis_size(mesh, ba)
    if dp > 1:
        order = [d for d in range(len(shape)) if spec[d] is None]
        # prefer dims listed as candidates, then any other dim
        order = ([d for d in candidates if spec[d] is None]
                 + [d for d in order if d not in candidates])
        for dim in order:
            if shape[dim] >= 1024 and shape[dim] % dp == 0:
                spec[dim] = ba
                break
    return spec


def _names(path) -> list:
    """The components of a key path (``"a/b/c"`` or a sequence)."""
    return path.split("/") if isinstance(path, str) else [str(p)
                                                          for p in path]


# rules keyed by the last path component (the param name); each returns a
# list of dim -> axis assignments given the *unstacked* shape.
def _param_rule(path, shape: tuple, mesh) -> PartitionSpec:
    names = _names(path)
    shape = tuple(shape)
    leaf = names[-1]
    # optimizer-state leaves: unfactored second moments ("v") shard exactly
    # like their parameter (parent path component); factored ones get a
    # generic first-fit.
    if leaf == "v" and len(names) >= 2:
        leaf = names[-2]
    stacked = "layers" in names or "encoder" in names or "decoder" in names
    core = shape[1:] if stacked else shape
    if names[-1] in ("vr", "vc"):
        spec = _first_fit(core, list(range(len(core))), mesh)
        return P(*(([None] + spec) if stacked else spec))

    def out(spec_core):
        spec = ([None] + list(spec_core)) if stacked else list(spec_core)
        return P(*spec)

    if leaf == "embedding":                       # (V, D)
        return out(_first_fit(core, [0, 1], mesh))
    if leaf == "kernel":                          # lm_head (D, V)
        return out(_first_fit(core, [1], mesh))
    if leaf == "wq":                              # (D, H, hd)
        return out(_first_fit(core, [1, 2], mesh))
    if leaf in ("wk", "wv"):                      # (D, KV, hd)
        return out(_first_fit(core, [1, 2], mesh))
    if leaf == "wo" and len(core) == 3:           # attn out (H, hd, D)
        return out(_first_fit(core, [0, 1], mesh))
    if leaf == "bq":                              # (H, hd)
        return out(_first_fit(core, [0, 1], mesh))
    if leaf in ("bk", "bv"):                      # (KV, hd)
        return out(_first_fit(core, [0, 1], mesh))
    if leaf in ("wi_gate", "wi_up"):
        if len(core) == 3:                        # moe experts (E, D, F)
            return out(_first_fit(core, [0], mesh))
        return out(_first_fit(core, [1], mesh))   # (D, F)
    if leaf == "wo" and len(core) == 2:           # mlp (F, D)
        return out(_first_fit(core, [0], mesh))
    if leaf == "router":                          # (D, E)
        return out(_first_fit(core, [1], mesh))
    if leaf == "in_proj":
        if len(core) == 2 and core[0] > core[1]:  # shared-attn (2D, D)
            return out([None, None])
        return out(_first_fit(core, [1], mesh))   # mamba (D, 2*din), xz_ranks
    if leaf == "out_proj":                        # mamba (din, D)
        return out(_first_fit(core, [0], mesh))
    if leaf == "x_proj":                          # (din, r+2n)
        return out(_first_fit(core, [0], mesh))
    if leaf == "dt_proj":                         # (r, din) | (D, H)
        return out(_first_fit(core, [1], mesh))
    if leaf in ("conv_w",):                       # (din, k)
        return out(_first_fit(core, [0], mesh))
    if leaf in ("conv_b", "dt_bias", "D"):        # (din,) | (H,)
        return out(_first_fit(core, [0], mesh))
    if leaf == "A_log":                           # (din, n) | (H,)
        return out(_first_fit(core, [0], mesh))
    if leaf in ("B_proj", "C_proj"):              # (D, n): n tiny, replicate
        return out([None, None])
    if leaf == "vision_adapter":                  # (D, D)
        return out([None, None])
    # scales, norms, anything unmatched: replicate
    return out([None] * len(core))


def xz_ranks(path, spec, mesh) -> int:
    """How many ``model`` ranks interleave the x and z column blocks of
    the leaf at ``path`` under ``spec``: a Mamba ``in_proj`` (D, 2 din)
    -- or an optimizer moment of its shape (AdamW's, Adafactor's ``v``
    and column statistic ``vc``) -- whose columns this rule puts on the
    tensor-parallel ``model`` axis.  Rank r's block of such a leaf is x
    block r followed by z block r, the columns it computes on
    (``models.mamba``), and the spec stays the one above.  Else 1: the
    contiguous block (under ``"dp"`` the columns' ``("data", "model")``
    is storage only)."""
    names = _names(path)
    if names[-1] in ("v", "vc") and len(names) >= 2:
        names = names[:-1]
    if names[-1] != "in_proj" or "ssm" not in names or not len(spec):
        return 1
    return axis_size(mesh, "model") if spec[-1] == "model" else 1


def infer_param_specs(params_shape, mesh):
    """PartitionSpec tree matching a params (or optimizer-state) tree of
    tensors or anything with a ``shape``."""
    keys, leaves = flatten(params_shape)
    return unflatten(params_shape, [_param_rule(k, l.shape, mesh)
                                    for k, l in zip(keys, leaves)])


def map_specs(fn, spec_tree):
    """``spec_tree`` with every PartitionSpec leaf replaced by
    ``fn(spec)`` (a spec is a tuple, so ``tree.flatten`` would walk into
    it)."""
    if isinstance(spec_tree, PartitionSpec):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):                 # keys sorted, as flatten
        return {k: map_specs(fn, spec_tree[k]) for k in sorted(spec_tree)}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(map_specs(fn, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(fn, v) for v in spec_tree)
    return spec_tree


def spec_leaves(spec_tree) -> list:
    """The PartitionSpecs of ``spec_tree`` in ``tree.flatten``'s order."""
    out = []
    map_specs(out.append, spec_tree)
    return out


def param_shardings(params_shape, mesh):
    return named(mesh, infer_param_specs(params_shape, mesh))


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def batch_specs(cfg, batch_shape_tree, mesh):
    """Input batch PartitionSpecs; batch dim on the batch axes when it
    divides, otherwise sequence-sharded (batch-1 long-context)."""
    ba = batch_axes(mesh)
    dp = axis_size(mesh, ba)

    def spec_for(key, leaf):
        name = _names(key)[-1]
        shape = tuple(leaf.shape)
        if name == "positions":                   # (3, B, S)
            b_ok = shape[1] % dp == 0
            return P(None, ba if b_ok else None, None)
        # (B, ...) leaves
        b_ok = shape[0] % dp == 0
        if b_ok:
            return P(ba, *([None] * (len(shape) - 1)))
        if len(shape) >= 2 and shape[1] % dp == 0 and shape[1] > 1:
            return P(None, ba, *([None] * (len(shape) - 2)))  # shard seq
        return P(*([None] * len(shape)))

    keys, leaves = flatten(batch_shape_tree)
    return unflatten(batch_shape_tree,
                     [spec_for(k, l) for k, l in zip(keys, leaves)])


def cache_specs(cfg, cache_shape_tree, mesh):
    """KV/SSM cache PartitionSpecs.

    Priority: shard batch on the batch axes; shard heads/inner dims on
    'model'; for batch-1 long-context shard the *sequence* dim of KV caches
    on the batch axes (SP) so a 500k cache fits.
    """
    ba = batch_axes(mesh)
    dp = axis_size(mesh, ba)

    def spec_for(key, leaf):
        name = _names(key)[-1]
        shape = tuple(leaf.shape)
        if name in ("k", "v", "xk", "xv", "k_scale", "v_scale"):
            # (L, B, S, KV, hd) -- scale buffers share the layout: batch
            # over the batch axes, SEQUENCE over 'model' (decode attention
            # over a seq-sharded cache communicates only the per-row
            # softmax stats and a psum of the context vector)
            mp = axis_size(mesh, ("model",))
            b_ax = ba if shape[1] % dp == 0 else None
            if b_ax is not None and shape[3] % mp == 0:
                # kv heads divide the model axis: grouped decode attention
                # is then fully local
                return P(None, b_ax, None, "model", None)
            if b_ax is None and shape[2] % (dp * mp) == 0:
                s_ax = (tuple(ba) + ("model",))   # batch-1 long context
            elif shape[2] % mp == 0:
                s_ax = "model"
            else:
                s_ax = None
            return P(None, b_ax, s_ax, None, None)
        if name == "h":                           # (L,B,din,n)|(L,B,H,P,n)
            b_ax = ba if shape[1] % dp == 0 else None
            inner = "model" if shape[2] % axis_size(mesh, "model") == 0 \
                else None
            rest = [None] * (len(shape) - 3)
            return P(None, b_ax, inner, *rest)
        if name == "conv":                        # (L, B, k-1, din)
            b_ax = ba if shape[1] % dp == 0 else None
            d_ax = "model" if shape[3] % axis_size(mesh, "model") == 0 \
                else None
            return P(None, b_ax, None, d_ax)
        return P(*([None] * len(shape)))

    keys, leaves = flatten(cache_shape_tree)
    return unflatten(cache_shape_tree,
                     [spec_for(k, l) for k, l in zip(keys, leaves)])


def named(mesh, spec_tree):
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# per-device bytes (the dry-run's reckoning)
# ---------------------------------------------------------------------------
def shard_divisor(spec, mesh) -> int:
    """The number of blocks a leaf is cut into under ``spec``: the product
    of the sizes of every axis it names."""
    n = 1
    for axes in spec:
        if axes is not None:
            n *= axis_size(mesh, axes)
    return n


def per_device_bytes(tree, spec_tree, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors with a shape and a
    dtype, meta ones included) laid out by ``spec_tree``: each leaf's
    bytes over :func:`shard_divisor`."""
    _, leaves = flatten(tree)
    total = 0
    for x, spec in zip(leaves, spec_leaves(spec_tree)):
        total += x.numel() * x.element_size() // shard_divisor(spec, mesh)
    return total

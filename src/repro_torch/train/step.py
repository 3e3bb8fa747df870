"""The train step: state {params, opt, step}, batch -> state', metrics.

The port of ``repro.train.step``.  Unsharded (``make_train_step``,
``init_state`` without a mesh): gradients come from
``torch.autograd.grad`` over the flattened param leaves (functional, as
``jax.value_and_grad``: no ``.grad`` is left on any tensor), the loss is
the backbone's features through the sequence-chunked CE, and optional
microbatch accumulation sums float32 gradients over ``accum_steps``
slices of the batch.  The step's metrics are the first microbatch's, taken
from the accumulation pass (the reference recomputes them; the values are
the same).

Sharded (``state_specs``, ``init_state(mesh=)``, ``jit_train_step``):
ZeRO-3 over a ``core.distributed.Mesh`` of ``torch.distributed`` ranks.
Every leaf of the state -- params, optimizer moments -- is held as this
rank's block under its ``parallel.sharding`` spec, the reference's layout.
In a step each rank takes its block of the global batch (``batch_specs``);
the layers' weights are gathered one layer at a time by the model's
``gather_layer_params`` hook (cast to bfloat16 values as the reference
casts them), the other params once at the top; the loss and the metrics
are global (the CE numerator, hits and token count summed over the batch
axes, not a mean of means); the backward of each gather sums the gradient
over the batch axes and keeps the rank's block; the optimizer updates
blocks, its whole-leaf reductions summed across ranks
(``train.optim``'s ``shards=``).

Under ``"2d"`` the ``model`` axis computes tensor-parallel
(``parallel.tp``): the layers' weights are gathered over the batch axes
only, each rank keeping its ``model`` block, and the ranks along
``model`` compute their heads, FFN columns, vocab columns, Mamba channels
and experts of the same batch block, the residual between layers held as
the rank's sequence block (``act_sharding.constrain``; an SSM residual
whole).  The loss is vocab-parallel (``train.loss``: the head's vocab
columns stay the rank's) and replicated along ``model``, so
every gradient is the rank's block, summed over the batch axes only.  A
batch that does not divide the batch axes is sequence-sharded by the
rules; its ranks gather the sequence (every rank computes the whole batch)
and sum no gradient.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.distributed import PartitionSpec as P
from repro_torch.parallel import act_sharding, zero
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.mesh import batch_axes
from repro_torch.train.loss import (chunked_ce_sums, chunked_cross_entropy,
                                    metrics_of_sums)
from repro_torch.tree import flatten, unflatten


def make_loss_fn(arch, *, loss_chunk: int = 512):
    """Backbone features + sequence-chunked CE: the full (b, s, vocab)
    logits tensor never materialises (``loss.chunked_cross_entropy``)."""
    def loss_fn(params, batch):
        feats = arch.forward_features(params, batch)
        return chunked_cross_entropy(
            lambda x: arch.head(params, x), feats, batch["labels"],
            chunk=loss_chunk, mask=batch.get("mask"))
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``(grads, metrics)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``: the gradient tree has the params' structure and dtypes
    (zeros for a leaf the loss does not reach); the metrics are detached."""
    _, leaves = flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_fn(unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                    materialize_grads=True)
    return (unflatten(params, list(grads)),
            {k: v.detach() for k, v in metrics.items()})


def _microbatches(batch, accum_steps):
    """``accum_steps`` slices of the batch along its batch axis (dim 1 of
    the (3, B, S) M-RoPE ``positions``, dim 0 of everything else)."""
    out = [{} for _ in range(accum_steps)]
    for name, x in batch.items():
        dim = 1 if name == "positions" else 0
        if x.shape[dim] % accum_steps:
            raise ValueError(f"batch axis of {name} ({x.shape[dim]}) is not "
                             f"a multiple of accum_steps={accum_steps}")
        for mb, part in zip(out, torch.chunk(x, accum_steps, dim=dim)):
            mb[name] = part
    return out


def make_train_step(arch, optimizer, *, accum_steps: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``; pure: the input
    state is not modified."""
    loss_fn = make_loss_fn(arch)

    def step(state, batch):
        params = state["params"]
        if accum_steps == 1:
            grads, metrics = value_and_grad(loss_fn, params, batch)
        else:
            acc, metrics = None, None
            for mb in _microbatches(batch, accum_steps):
                g, m = value_and_grad(loss_fn, params, mb)
                g = [x.to(torch.float32) for x in flatten(g)[1]]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                metrics = metrics or m
            grads = unflatten(params, [a / accum_steps for a in acc])
        with torch.no_grad():
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state["opt"], params)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, dict(metrics, **opt_metrics))

    return step


def init_state(arch, optimizer, mesh=None, seed: int = 0,
               device=None) -> dict:
    """``{params, opt, step}``: the params drawn by ``arch.init`` from
    ``torch.Generator(dev).manual_seed(seed)``, the optimizer's fresh
    state, an int32 step 0.  Without a mesh on ``device`` (None: the
    card); with one on ``mesh.device``, each leaf drawn whole and cut to
    this rank's block under :func:`state_specs`, so that the sharded and
    the unsharded states hold the same numbers."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    params = arch.init(torch.Generator(dev).manual_seed(seed))
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if mesh is None:
        return state
    _, specs = state_specs(arch, optimizer, mesh)
    return block_tree(mesh, state, specs)


# ---------------------------------------------------------------------------
# ZeRO-3 over a mesh
# ---------------------------------------------------------------------------
def state_specs(arch, optimizer, mesh):
    """``(shapes, specs)`` of the full train state: the shapes as meta
    tensors (nothing allocated), the specs by the ``parallel.sharding``
    rules.  Optimizer moments reuse the param rules (their tree mirrors
    the params tree, so path-based rules apply unchanged)."""
    params_shape = arch.init(torch.Generator(), device="meta")
    opt_shape = optimizer.init(params_shape)
    specs = {
        "params": shd.infer_param_specs(params_shape, mesh),
        "opt": shd.infer_param_specs(opt_shape, mesh),
        "step": P(),
    }
    shapes = {"params": params_shape, "opt": opt_shape,
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    return shapes, specs


def block_tree(mesh, tree, spec_tree):
    """This rank's block of every leaf of a global ``tree``
    (``zero.block``: a Mamba ``in_proj``'s block is its compute
    columns)."""
    keys, leaves = flatten(tree)
    return unflatten(tree, [zero.block(mesh, x, s, k) for k, x, s in
                            zip(keys, leaves, shd.spec_leaves(spec_tree))])


def unblock_tree(mesh, tree, spec_tree):
    """The global tree of this rank's blocks (every rank calls it: one
    all-reduce per sharded leaf), the reference's leaves."""
    keys, leaves = flatten(tree)
    return unflatten(tree, [zero.assemble(mesh, x, s, key=k)
                            for k, x, s in
                            zip(keys, leaves, shd.spec_leaves(spec_tree))])


#: the stacked param trees whose layers the model gathers one at a time
#: (``gather_layer_params`` in its layer loops); the hybrid's SSM loop
#: calls no gather in the reference, so its stack is gathered at the top,
#: every layer at once (its ``model`` blocks kept under tensor parallelism)
PER_LAYER = ("layers", "encoder", "decoder")


def per_layer_roots(cfg) -> tuple:
    return () if cfg.family == "hybrid" else PER_LAYER


def layer_specs(cfg, params_shape, param_specs) -> dict:
    """The spec of each per-layer leaf by its key path within a layer: the
    stacked leaf's spec without its layer dimension (one spec per path,
    shared by every stack that has it)."""
    out = {}
    keys, _ = flatten(params_shape)
    for key, spec in zip(keys, shd.spec_leaves(param_specs)):
        root, _, rel = key.partition("/")
        if root not in per_layer_roots(cfg) or not rel:
            continue
        spec = P(*spec[1:])
        if out.setdefault(rel, spec) != spec:
            raise ValueError(f"layer leaf {rel} has specs {out[rel]} and "
                             f"{spec} in different stacks")
    return out


def _batch_dim(key) -> int:
    return 1 if key.split("/")[-1] == "positions" else 0


def local_batch(mesh, batch, b_specs):
    """``(this rank's batch, grad axes)``: each leaf's block on its batch
    dimension when the rules shard it there (the axes are the batch
    axes), else the whole leaf (a sequence-sharded or replicated batch:
    the rank gathers the sequence; no axes)."""
    keys, leaves = flatten(batch)
    out, axes = [], ()
    for key, x, spec in zip(keys, leaves, shd.spec_leaves(b_specs)):
        d = _batch_dim(key)
        spec = zero.padded(spec, x.dim())
        if spec[d] is None:
            out.append(x)
            continue
        axes = zero.spec_axes((spec[d],))
        out.append(mesh.block(x, P(*([None] * d + [spec[d]]))))
    return unflatten(batch, out), axes


def gather_params(blocks, keys, specs, mesh, roots, grad_axes=()):
    """The params tree of this rank's ``blocks`` for the model: the
    stacks under ``roots`` left as blocks (the model gathers them one
    layer at a time), every other leaf gathered to its compute layout
    (``act_sharding.gather_leaf``: its ``model`` block kept under tensor
    parallelism)."""
    _, leaves = flatten(blocks)
    model = act_sharding.model_axis()
    return unflatten(blocks, [
        x if k.split("/")[0] in roots
        else act_sharding.gather_leaf(k, x, mesh, s, grad_axes, None, model)
        for k, x, s in zip(keys, leaves, specs)])


def make_sharded_step(arch, optimizer, mesh, shapes, specs, b_specs, *,
                      accum_steps: int = 1, loss_chunk: int = 512):
    """``step(state, batch) -> (state, metrics)`` on this rank's blocks of
    the state and the *global* batch (see the module docstring)."""
    cfg = arch.cfg
    pkeys, _ = flatten(shapes["params"])
    pspecs = shd.spec_leaves(specs["params"])
    roots = per_layer_roots(cfg)
    lspecs = layer_specs(cfg, shapes["params"], specs["params"])
    shards = zero.Shards.of(mesh, shapes["params"], specs["params"])

    def loss_fn(grad_axes):
        def fn(blocks, batch):
            params = gather_params(blocks, pkeys, pspecs, mesh, roots,
                                   grad_axes)
            feats = arch.forward_features(params, batch)
            # vocab-parallel: with the vocab on 'model' the head gives the
            # rank's columns, and the loss combines them unassembled
            nll, hits, cnt = chunked_ce_sums(
                lambda x: arch.head(params, x, vocab_block=True), feats,
                batch["labels"], chunk=loss_chunk, mask=batch.get("mask"))
            # global sums: one psum of the three; the local objective is
            # this rank's numerator over the global count, so that the
            # gradients summed over the batch axes are the global mean's
            tot = zero.psum_over(torch.stack([nll.detach(), hits, cnt]),
                                 mesh, grad_axes)
            _, metrics = metrics_of_sums(tot[0], tot[1], tot[2])
            return nll / torch.clamp(tot[2], min=1.0), metrics
        return fn

    def grads_of(params, batch):
        local, grad_axes = local_batch(mesh, batch, b_specs)
        with act_sharding.zero3(mesh, lspecs, grad_axes):
            return value_and_grad(loss_fn(grad_axes), params, local)

    def step(state, batch):
        params = state["params"]
        if accum_steps == 1:
            grads, metrics = grads_of(params, batch)
        else:
            acc, metrics = None, None
            for mb in _microbatches(batch, accum_steps):
                g, m = grads_of(params, mb)
                g = [x.to(torch.float32) for x in flatten(g)[1]]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                metrics = metrics or m
            grads = unflatten(params, [a / accum_steps for a in acc])
        with torch.no_grad():
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state["opt"], params, shards=shards)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, dict(metrics, **opt_metrics))

    return step


def jit_train_step(arch, optimizer, mesh, batch_shapes, *,
                   accum_steps: int = 1):
    """The sharded step of ``arch`` on ``mesh`` for batches shaped like
    ``batch_shapes``: ``(fn, shapes, state_sh, batch_sh)`` as the
    reference returns them (there is no compile: ``fn`` runs eagerly).
    Registers the mesh's activation shardings, as the reference does."""
    act_sharding.set_mesh_shardings(mesh)
    shapes, specs = state_specs(arch, optimizer, mesh)
    b_specs = shd.batch_specs(arch.cfg, batch_shapes, mesh)
    fn = make_sharded_step(arch, optimizer, mesh, shapes, specs, b_specs,
                           accum_steps=accum_steps)
    return fn, shapes, shd.named(mesh, specs), shd.named(mesh, b_specs)

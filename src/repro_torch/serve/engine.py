"""Batched serving engine: prefill + decode with slot-based batching.

The decode step is the framework's "smart update": one token row computes
against the cached state instead of re-running the whole sequence.
Requests are packed into fixed batch slots; finished slots are refilled
from the queue (continuous-batching-lite -- slots decode in lockstep).

The port of ``repro.serve.engine``, step for step: prompts are left-padded
with token 0, with no pad mask and positions counted from the padded
start, exactly as the reference does; one lockstep prefill, then
``max(max_new_tokens)`` - 1 decode steps at positions ``max_prompt`` and
up.

``ServeEngine(arch, mesh)`` serves on a ``core.distributed.Mesh`` of
``torch.distributed`` ranks (``parallel.mesh.make_host_mesh``), as the
reference serves on its mesh: every rank runs the engine on the same
requests.  Params are laid out by ``parallel.sharding.infer_param_specs``
(each rank holds its blocks: drawn or converted leaf by leaf, so that no
rank holds the whole tree), the KV caches by ``cache_specs``
(``models.transformer.init_cache(mesh=)``), and the slots by the batch
axes.  The model computes tensor-parallel on ``model``
(``parallel.act_sharding.zero3``, ``parallel.tp``); the logits are
assembled over the batch axes and every rank samples the same tokens.
With ``mesh=None`` the engine runs unsharded on ``device``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import layers
from repro_torch.parallel import act_sharding, zero
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.mesh import axis_size, batch_axes, get_strategy, \
    tp_size
from repro_torch.tree import flatten, unflatten


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (s,) int32
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def init_blocks(arch, gen, mesh, spec_tree):
    """``arch.init(gen)``'s params as this rank's blocks under
    ``spec_tree``, each weight cut to its block as soon as it is drawn
    (``models.layers.leaf_sink``; the few leaves made otherwise are cut
    at the end): the same values as drawing the whole tree and blocking
    it."""
    drawn = []
    with layers.leaf_sink(lambda w: drawn.append(w) or w):
        shapes = arch.init(torch.Generator(), device="meta")
    order = {id(w): i for i, w in enumerate(drawn)}
    keys, leaves = flatten(shapes)
    specs = shd.spec_leaves(spec_tree)
    at = {order[id(x)]: (k, s) for k, x, s in zip(keys, leaves, specs)
          if id(x) in order}
    count = itertools.count()

    def cut(w):
        ks = at.get(next(count))
        return w if ks is None else zero.block(mesh, w, ks[1], ks[0])

    with layers.leaf_sink(cut):
        tree = arch.init(gen)
    if next(count) != len(drawn):
        raise RuntimeError("the init drew another sequence of weights on "
                           "the meta device")
    cut_ids = {id(x) for x in leaves if id(x) in order}
    _, got = flatten(tree)
    return unflatten(tree, [x if id(m) in cut_ids
                            else zero.block(mesh, x, s, k)
                            for k, x, m, s in zip(keys, got, leaves, specs)])


class ServeEngine:
    """Serve ``arch`` (``models.registry.make_arch``) on ``mesh`` (None:
    unsharded on ``device``; None: the card, raising without one).
    Params are drawn by ``arch.init(torch.Generator(device)
    .manual_seed(seed))``; :meth:`load_params` serves other weights (or,
    unsharded, assign ``engine.params``).  ``temperature`` 0 is greedy
    (argmax); above 0 each token is a categorical draw (Gumbel-max) from
    the engine's own ``torch.Generator(seed)``, the same on every rank.

    On a mesh the engine serves the token families (dense, moe, ssm,
    hybrid) under strategy ``"2d"``, with the attention heads and the
    Mamba channels and heads dividing over ``model`` and ``batch_slots`` a
    multiple of the batch axes' size; any other layout raises."""

    def __init__(self, arch, mesh=None, *, batch_slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0,
                 seed: int = 0, device=None):
        self.arch, self.mesh = arch, mesh
        self.B, self.S = batch_slots, max_len
        self.temperature = temperature
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{self.device}")
            self._check_layout()
        self.gen = torch.Generator(self.device).manual_seed(seed)
        init_gen = torch.Generator(self.device).manual_seed(seed)
        if mesh is None:
            self.params = arch.init(init_gen)
        else:
            shapes = arch.init(torch.Generator(), device="meta")
            self._keys = flatten(shapes)[0]
            self._spec_tree = shd.infer_param_specs(shapes, mesh)
            self._specs = shd.spec_leaves(self._spec_tree)
            from repro_torch.train.step import layer_specs, per_layer_roots
            self._roots = per_layer_roots(arch.cfg)
            self._layer_specs = layer_specs(arch.cfg, shapes,
                                            self._spec_tree)
            self.params = init_blocks(arch, init_gen, mesh, self._spec_tree)
            self.cache_specs = shd.cache_specs(
                arch.cfg, arch.init_cache(self.B, self.S, device="meta"),
                mesh)
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * self.B

    def _check_layout(self):
        cfg, mesh = self.arch.cfg, self.mesh
        if get_strategy() != "2d":
            raise ValueError("the engine serves on a mesh under strategy "
                             "'2d' only")
        if cfg.family in ("vlm", "encdec"):
            raise ValueError(f"the {cfg.family} family takes frontend "
                             f"embeddings the engine does not feed")
        mp, dp = tp_size(mesh), axis_size(mesh, batch_axes(mesh))
        if mp > 1 and cfg.family != "ssm" and cfg.n_heads % mp:
            raise ValueError(f"{cfg.n_heads} heads do not divide over "
                             f"model={mp}")
        if mp > 1 and cfg.family in ("ssm", "hybrid"):
            if cfg.d_inner % mp:
                raise ValueError(f"the Mamba layers' {cfg.d_inner} channels "
                                 f"do not divide over model={mp}")
            if cfg.ssm_variant == "mamba2" and cfg.ssm_heads % mp:
                raise ValueError(f"the Mamba-2 layers' {cfg.ssm_heads} "
                                 f"heads do not divide over model={mp}")
        if self.B % dp:
            raise ValueError(f"{self.B} batch slots do not divide over the "
                             f"batch axes' {dp} ranks")

    def load_params(self, tree):
        """Serve ``tree`` (the params' structure; tensors or arrays), each
        leaf moved to the device and cut to this rank's block in turn."""
        keys, leaves = flatten(tree)
        if self.mesh is not None and keys != self._keys:
            raise ValueError(f"not the params of {self.arch.cfg.name}: keys "
                             f"{sorted(set(keys) ^ set(self._keys))} differ")
        self.params = None                  # the drawn ones go first
        out = []
        for i, x in enumerate(leaves):
            t = torch.as_tensor(x).to(self.device)
            out.append(t if self.mesh is None
                       else zero.block(self.mesh, t, self._specs[i],
                                       keys[i]))
            del t
        self.params = unflatten(tree, out)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> Request:
        req = Request(rid=len(self.queue), prompt=np.asarray(prompt,
                                                             np.int32),
                      max_new_tokens=max_new_tokens)
        self.queue.append(req)
        return req

    def _sample(self, logits):
        last = logits[:, -1]
        if self.temperature <= 0.0:
            return torch.argmax(last, dim=-1)
        u = torch.rand(last.shape, generator=self.gen, device=last.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
        return torch.argmax(last / self.temperature + gumbel, dim=-1)

    # -- the model calls, unsharded or on the mesh ------------------------
    def _rows(self, x):
        """This rank's slots of a (B, ...) tensor."""
        if self.mesh is None:
            return x
        return self.mesh.block(x, (batch_axes(self.mesh),))

    def _all_rows(self, logits):
        """The (B, ...) logits of every slot from this rank's."""
        if self.mesh is None:
            return logits
        return zero.assemble(self.mesh, logits, (batch_axes(self.mesh),))

    def _ctx(self):
        """The context of one model call: on a mesh the sharded compute
        (``act_sharding.zero3``, no cast)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return act_sharding.zero3(self.mesh, self._layer_specs, (),
                                  train=False)

    def _model_params(self):
        """The params of the model calls: on a mesh the top-level leaves
        gathered over the batch axes (``train.step.gather_params``)."""
        if self.mesh is None:
            return self.params
        from repro_torch.train.step import gather_params
        with self._ctx():
            return gather_params(self.params, self._keys, self._specs,
                                 self.mesh, self._roots)

    @torch.inference_mode()
    def run(self, progress: bool = False) -> dict:
        """Drain the queue; returns {"results": {rid: generated token
        list}, "tokens_per_s", "n_tokens"}."""
        results, t0, n_tokens = {}, time.perf_counter(), 0
        while self.queue or any(s is not None for s in self.slots):
            # (re)fill slots; pad the batch with a dummy request if needed
            batch_reqs = []
            for i in range(self.B):
                if self.slots[i] is None and self.queue:
                    self.slots[i] = self.queue.popleft()
                batch_reqs.append(self.slots[i])
            active = [r for r in batch_reqs if r is not None]
            if not active:
                break
            max_prompt = max(len(r.prompt) for r in active)
            prompts = np.zeros((self.B, max_prompt), np.int32)
            for i, r in enumerate(batch_reqs):
                if r is not None:
                    prompts[i, -len(r.prompt):] = r.prompt  # left-pad
            # prefill the whole batch (lockstep) then decode
            tokens = torch.as_tensor(prompts, device=self.device)
            params = self._model_params()
            with self._ctx():
                last, caches = self.arch.prefill(
                    params, {"tokens": self._rows(tokens)}, self.S)
            pos = max_prompt
            tok = self._sample(self._all_rows(last))
            steps = max(r.max_new_tokens for r in active)
            for j in range(steps):
                host = tok.tolist()
                for i, r in enumerate(batch_reqs):
                    if r is not None and len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(int(host[i]))
                        n_tokens += 1
                if progress:
                    print(f"[serve] step {j + 1}/{steps} pos {pos}",
                          flush=True)
                if j == steps - 1:
                    break
                with self._ctx():
                    logits, caches = self.arch.decode_step(
                        params,
                        {"tokens": self._rows(tok[:, None].to(torch.int32))},
                        caches, pos)
                pos += 1
                tok = self._sample(self._all_rows(logits))
            for i, r in enumerate(batch_reqs):
                if r is not None:
                    results[r.rid] = r.out_tokens
                    r.done = True
                    self.slots[i] = None
        dt = time.perf_counter() - t0
        return {"results": results,
                "tokens_per_s": n_tokens / max(dt, 1e-9),
                "n_tokens": n_tokens}

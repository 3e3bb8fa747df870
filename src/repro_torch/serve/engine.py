"""Batched serving engine: prefill + decode with slot-based batching.

The decode step is the framework's "smart update": one token row computes
against the cached state instead of re-running the whole sequence.
Requests are packed into fixed batch slots; finished slots are refilled
from the queue (continuous-batching-lite -- slots decode in lockstep).

The port of ``repro.serve.engine``, step for step: prompts are left-padded
with token 0, with no pad mask and positions counted from the padded
start, exactly as the reference does; one lockstep prefill, then
``max(max_new_tokens)`` - 1 decode steps at positions ``max_prompt`` and
up.  There is no ``mesh`` argument: the engine runs on one device until
the LM meshes (``parallel/``) are ported.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (s,) int32
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serve ``arch`` (``models.registry.make_arch``) on ``device`` (None:
    the card; raises without one).  Params are drawn by
    ``arch.init(torch.Generator(device).manual_seed(seed))``; assign
    ``engine.params`` to serve other weights.  ``temperature`` 0 is greedy
    (argmax); above 0 each token is a categorical draw (Gumbel-max) from
    the engine's own ``torch.Generator(seed)``."""

    def __init__(self, arch, *, batch_slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0, device=None):
        self.arch = arch
        self.device = resolve_device(device)
        self.B, self.S = batch_slots, max_len
        self.temperature = temperature
        self.gen = torch.Generator(self.device).manual_seed(seed)
        self.params = arch.init(
            torch.Generator(self.device).manual_seed(seed))
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * self.B

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
            last, caches = self.arch.prefill(self.params, {"tokens": tokens},
                                             self.S)
            pos = max_prompt
            tok = self._sample(last)
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
                logits, caches = self.arch.decode_step(
                    self.params, {"tokens": tok[:, None].to(torch.int32)},
                    caches, pos)
                pos += 1
                tok = self._sample(logits)
            for i, r in enumerate(batch_reqs):
                if r is not None:
                    results[r.rid] = r.out_tokens
                    r.done = True
                    self.slots[i] = None
        dt = time.perf_counter() - t0
        return {"results": results,
                "tokens_per_s": n_tokens / max(dt, 1e-9),
                "n_tokens": n_tokens}

"""Data pipeline: deterministic synthetic LM stream + memmap shard reader,
with background prefetch.

The port's own copy of ``repro.train.data`` (numpy only).  Determinism
contract (fault tolerance): batch content is a pure function of
(seed, step), so resuming from a checkpoint replays the exact stream --
nothing about the pipeline needs checkpointing beyond the step counter.
Batches are numpy int32 arrays; the training loop moves them to its
device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Markov-ish token stream: deterministic per (seed, step)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab, self.batch, self.seq = vocab_size, batch, seq_len
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        # low-entropy structure so the loss visibly decreases
        base = rng.integers(0, self.vocab, (self.batch, 1), dtype=np.int32)
        drift = rng.integers(0, 7, (self.batch, self.seq), dtype=np.int32)
        tokens = (base + np.cumsum(drift, axis=1)) % self.vocab
        return {"tokens": tokens.astype(np.int32),
                "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLM:
    """Token shards on disk: flat int32 .bin files, strided per host."""

    def __init__(self, path: str, batch: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.batch, self.seq = batch, seq_len
        self.host_id, self.n_hosts = host_id, n_hosts
        self.per_step = batch * (seq_len + 1)

    def batch_at(self, step: int) -> dict:
        n = self.tokens.shape[0]
        start = (step * self.n_hosts + self.host_id) * self.per_step % \
            max(1, n - self.per_step)
        flat = np.asarray(self.tokens[start:start + self.per_step])
        flat = flat.reshape(self.batch, self.seq + 1)
        return {"tokens": flat[:, :-1].copy(),
                "labels": flat[:, 1:].copy()}


class Prefetcher:
    """Runs ``source.batch_at`` in a thread, ``depth`` batches ahead;
    ``close`` stops the thread."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _fill(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self.thread.join(timeout=5)

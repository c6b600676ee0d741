"""Synthetic LM token pipeline with host-side prefetch: the port's own copy
of the reference's ``repro/data/lm.py`` (numpy and a thread; batches are
numpy arrays, uploaded by the caller).

Tokens are synthesized (Zipf-distributed ids, a fixed seed per shard).
The pipeline has the shape of a production loader: per-host sharded
streams, a background prefetch thread keeping ``depth`` batches ready,
and deterministic resume by (shard, step) addressing, the data side of
checkpoint-restart.  For a given (seed, shard, step) it yields the
reference's batch exactly.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class TokenPipeline:
    def __init__(self, *, vocab: int, batch: int, seq_len: int,
                 shard: int = 0, n_shards: int = 1, seed: int = 1234,
                 depth: int = 2, start_step: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.shard = shard
        self.n_shards = n_shards
        self.seed = seed
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed, self.shard, step))  # resume-deterministic
        # Zipf-ish marginal over ids (a realistic softmax target distribution)
        u = rng.uniform(size=(self.batch, self.seq_len))
        toks = np.minimum((self.vocab * u ** 3).astype(np.int32),
                          self.vocab - 1)
        return {"tokens": toks}

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            b = self._make_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        step, b = self._q.get()
        self.step = step + 1
        return b

    def close(self) -> None:
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        self._thread.join(timeout=5)

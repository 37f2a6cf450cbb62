"""Deterministic, shardable synthetic token pipeline (a copy of
``repro/data/pipeline.py``, which is numpy only; batches are byte-identical
for any ``(seed, step, host_index, host_count)``).

Properties a 1000-node training fleet needs from its input pipeline:

- **Stateless addressing**: batch ``i`` is a pure function of (seed, i), so
  any host can regenerate any batch — restarts and elastic re-meshes resume
  exactly by restoring only the step counter (no iterator state).
- **Per-host sharding**: each host materializes only its slice of the
  global batch (``host_count``/``host_index``), so input bandwidth scales
  out with the fleet.
- **Prefetch**: a background thread keeps ``prefetch`` batches ready so an
  input hiccup on one host does not straggle the step (the step-time
  monitor in train/loop.py watches for exactly this).

The synthetic stream has learnable structure (noisy modular-arithmetic
sequences), so a training run shows real loss decrease.  The batches stay
numpy arrays; the train step moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """tokens[t+1] = (tokens[t] + drift) % vocab with flip noise."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError(f"global_batch {cfg.global_batch} does not split "
                             f"over {cfg.host_count} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count

    def batch(self, step: int) -> dict:
        """The host-local slice of global batch ``step`` (pure function)."""
        cfg = self.cfg
        rows = []
        base = step * cfg.global_batch + self.local_batch * cfg.host_index
        drift = 1 + (cfg.seed % max(cfg.vocab_size - 1, 1))
        for r in range(self.local_batch):
            rng = np.random.default_rng((cfg.seed, base + r))
            start = rng.integers(0, cfg.vocab_size)
            seq = (start + drift * np.arange(cfg.seq_len + 1)) % cfg.vocab_size
            noise = rng.random(cfg.seq_len + 1) < 0.02
            seq = np.where(noise, rng.integers(0, cfg.vocab_size,
                                               cfg.seq_len + 1), seq)
            rows.append(seq)
        tok = np.stack(rows).astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


class PrefetchIterator:
    """Background-thread prefetch over ``dataset.batch(step)``."""

    def __init__(self, dataset, start_step: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self._q.put((s, self.dataset.batch(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __next__(self):
        s, b = self._q.get()
        self.step = s + 1
        return s, b

    def close(self):
        self._stop.set()

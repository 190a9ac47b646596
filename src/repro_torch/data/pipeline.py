"""Deterministic synthetic token pipeline with checkpointable iterator state.

The torch port's copy of ``repro/data/pipeline.py``.  It is numpy only, and
its batches are bitwise the JAX package's: numpy arrays, which the train
launcher moves to its device.

Production-shaped: per-host sharding (each host materializes only its slice of
the global batch), double-buffered prefetch, and an iterator state (step
counter + seed) small enough to live inside every checkpoint — restart resumes
the exact data order (fault tolerance requirement).

The "dataset" is a seeded synthetic LM stream: Zipf-ish token draws with a
repeating-ngram structure so models can actually reduce loss on it (used by
examples/train_lm.py and the integration tests).
"""
from __future__ import annotations

import dataclasses
import threading
import queue
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    ngram_period: int = 97      # repeating structure => learnable
    zipf_a: float = 1.3


@dataclasses.dataclass
class IteratorState:
    step: int
    seed: int

    def to_dict(self):
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]), seed=int(d["seed"]))


class SyntheticLMData:
    """Seeded, stateless-per-step generator: batch(step) is a pure function,
    so resuming from `state.step` reproduces the stream exactly."""

    def __init__(self, cfg: DataConfig, process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        if cfg.global_batch % process_count:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{process_count} processes")
        self.local_batch = cfg.global_batch // process_count

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.process_index])
        )
        b, s = self.local_batch, cfg.seq_len
        # zipf-weighted draws
        zipf = rng.zipf(cfg.zipf_a, size=(b, s + 1)).astype(np.int64)
        toks = zipf % (cfg.vocab_size - 1) + 1
        # inject learnable periodic structure: copy earlier tokens forward
        idx = np.arange(s + 1)
        src = idx - cfg.ngram_period
        mask = (idx % 7 == 3) & (src >= 0)
        toks[:, mask] = toks[:, np.clip(src[mask], 0, None)]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Double-buffered background prefetch + checkpointable position."""

    def __init__(self, data: SyntheticLMData, state: Optional[IteratorState] = None,
                 prefetch: int = 2):
        self.data = data
        self.state = state or IteratorState(step=0, seed=data.cfg.seed)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._next_load = self.state.step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.data.batch_at(self._next_load)
            self._q.put((self._next_load, batch))
            self._next_load += 1

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.state = IteratorState(step=step + 1, seed=self.state.seed)
        return batch

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

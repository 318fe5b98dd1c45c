"""Deterministic synthetic LM data pipeline with sharding and prefetch
(the port's copy of the reference's ``repro/data/pipeline.py``).

* **Determinism & resumability** — batch ``i`` is a pure function of
  (seed, step): restarting from a checkpoint at step ``k`` replays the
  exact stream from ``k`` with no state files.
* **Per-rank sharding** — each data-parallel rank draws only its slice
  (keyed by ``(step, rank)``), so no rank ever materializes the global
  batch.
* **Background prefetch** — a thread keeps ``prefetch_depth`` batches
  ready so the accelerator never waits on host-side generation.

Batches are numpy (``batch_at`` is the reference's numpy code, so its
tokens are the reference's bit for bit); the training driver moves them
to the device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator

import numpy as np

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Batch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    num_ranks: int = 1
    rank: int = 0
    prefetch_depth: int = 2

    @property
    def per_rank_batch(self) -> int:
        if self.global_batch % self.num_ranks:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.num_ranks} ranks")
        return self.global_batch // self.num_ranks


class SyntheticLM:
    """Zipf-ish synthetic token stream (deterministic per (seed, step, rank)).

    Tokens follow a power-law marginal with short-range repetition so the
    loss curve actually moves during the example training runs.
    """

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc
        # fixed power-law over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> Batch:
        dc = self.dc
        rng = np.random.default_rng(
            np.random.SeedSequence([dc.seed, step, dc.rank]))
        b, s = dc.per_rank_batch, dc.seq_len
        toks = rng.choice(self.cfg.vocab_size, size=(b, s + 1),
                          p=self._probs).astype(np.int32)
        # short-range structure: repeat previous token with prob 0.3
        rep = rng.random((b, s + 1)) < 0.3
        for t in range(1, s + 1):
            toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
        return Batch(tokens=toks[:, :-1], labels=toks[:, 1:])

    def __iter__(self) -> Iterator[Batch]:
        return self.iterate(0)

    def iterate(self, start_step: int) -> Iterator[Batch]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetcher over any batch iterator."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[Batch], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        item = self._q.get()
        if item is self._SENTINEL:
            raise StopIteration
        return item

    def close(self, timeout: float = 10.0):
        """Stop the worker: drain the queue until it has put its
        sentinel and ended (it finishes the batch it is making first)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass


def make_pipeline(cfg: ModelConfig, dc: DataConfig,
                  start_step: int = 0) -> PrefetchIterator:
    ds = SyntheticLM(cfg, dc)
    return PrefetchIterator(ds.iterate(start_step),
                            depth=dc.prefetch_depth)

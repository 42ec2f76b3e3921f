"""Deterministic, resumable, sharded token pipeline.

The port's own copy of the JAX package's `data/pipeline.py`, which is plain
numpy: the same (seed, shard, step) gives the same batch on both sides.
Batches are numpy arrays; the trainer moves them to the model's device.

Production properties:
  * each data-parallel host reads only its shard (shard_id/num_shards),
  * the stream is a pure function of (seed, step) -> batch, so restarts
    resume exactly (the trainer checkpoints just the step counter),
  * double-buffered prefetch on a background thread hides host latency,
  * sources: synthetic LM stream (default; zipf-ish token draw) or packed
    token files (one uint32 memmap per shard directory).
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    shard_id: int = 0
    num_shards: int = 1
    seed: int = 0
    source: str = "synthetic"         # "synthetic" | "files"
    path: Optional[str] = None
    prefetch: int = 2


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_shards == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_shards
        self._mm = None
        if cfg.source == "files":
            path = os.path.join(cfg.path, f"shard_{cfg.shard_id:05d}.bin")
            self._mm = np.memmap(path, dtype=np.uint32, mode="r")

    # -- deterministic batch function -------------------------------------------

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if self._mm is not None:
            n = self.local_batch * (cfg.seq_len + 1)
            start = (step * n) % max(len(self._mm) - n, 1)
            flat = np.asarray(self._mm[start:start + n], dtype=np.int32)
            toks = flat.reshape(self.local_batch, cfg.seq_len + 1)
        else:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, cfg.shard_id, step]))
            # zipf-ish marginal: realistic softmax-xent magnitudes
            z = rng.zipf(1.3, size=(self.local_batch, cfg.seq_len + 1))
            toks = np.minimum(z, cfg.vocab_size - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    # -- prefetching iterator ------------------------------------------------------

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate(start_step=0)

    def iterate(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def produce():
            s = start_step
            while not stop.is_set():
                q.put(self.batch_at(s))
                s += 1

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass

"""Deterministic synthetic LM data: shard-aware, resumable, learnable.

The JAX package's ``data/synthetic.py``, copied (it is numpy only; the port
imports nothing of that package), so both give bit-identical batches.

The stream is a Markov-ish token process seeded by (stream_seed, step,
global_example_index): fully deterministic, so (a) every data-parallel host
generates exactly its slice with no coordination, (b) restoring ``step``
from a checkpoint resumes the stream bit-exactly, and (c) the sequences have
enough local structure (token t+1 depends on token t) that a ~100M model's
loss visibly drops within a few hundred steps -- which the end-to-end
example asserts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticConfig", "SyntheticStream"]


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int                       # tokens per example (model sees S+1)
    global_batch: int
    seed: int = 1234
    structure: int = 97                # markov jump (makes data learnable)
    pool: int = 16                     # distinct documents cycled through;
    #                                    small pool => learnable within a
    #                                    few hundred steps (end-to-end demo)


@dataclass
class SyntheticStream:
    """Iterator over {"tokens": (local_batch, seq_len + 1)} host arrays."""

    cfg: SyntheticConfig
    shard_index: int = 0
    shard_count: int = 1
    step: int = 0

    def __post_init__(self):
        assert self.cfg.global_batch % self.shard_count == 0, (
            self.cfg.global_batch, self.shard_count)
        self.local_batch = self.cfg.global_batch // self.shard_count

    # -- resumability -----------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])

    # -- generation ---------------------------------------------------------------
    def _example(self, step: int, global_idx: int) -> np.ndarray:
        c = self.cfg
        doc_id = (step * c.global_batch + global_idx) % c.pool
        rng = np.random.RandomState(
            (c.seed * 1_000_003 + doc_id * 8_191) % (2 ** 31 - 1))
        n = c.seq_len + 1
        start = rng.randint(0, c.vocab_size)
        jumps = rng.randint(0, 4, size=n)           # small random walk
        toks = (start + np.cumsum(jumps * c.structure)) % c.vocab_size
        return toks.astype(np.int32)

    def next_batch(self) -> dict:
        c = self.cfg
        base = self.shard_index * self.local_batch
        batch = np.stack([
            self._example(self.step, base + i) for i in range(self.local_batch)
        ])
        self.step += 1
        return {"tokens": batch}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self.next_batch()

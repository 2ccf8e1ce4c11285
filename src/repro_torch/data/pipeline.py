"""Data pipeline: deterministic synthetic token stream (and an mmap-backed
binary reader), sharded by (pod, data) coordinate, with restartable iterator
state so checkpoint/restart resumes the stream exactly (the paper's `ddlrun`
rank-based data split, generalized to the mesh).

A copy of the JAX package's `data/pipeline.py` (numpy only, so the batches
are the same bit for bit); its VLM and audio batch stubs are not ported yet.
`local_rows` cuts a rank's rows from the global batch, which the JAX
package leaves to its batch sharding.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class DataState:
    """Serializable iterator position."""
    epoch: int = 0
    step_in_epoch: int = 0
    seed: int = 0

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class SyntheticTokens:
    """Deterministic pseudo-corpus: a seeded noisy-bigram chain (next token
    = fixed permutation of current, with `noise` probability of a uniform
    draw), so (a) the task is learnable — loss curves are meaningful — and
    (b) any (pod, data) shard regenerates its slice independently from a
    counter-based RNG: no host reads the others' data (pure data
    parallelism, partitioned not replicated, like the paper's BP setup)."""

    def __init__(self, vocab_size: int, seed: int = 0, noise: float = 0.3):
        self.vocab = vocab_size
        self.seed = seed
        self.noise = noise
        perm_rng = np.random.Generator(np.random.Philox(key=seed % (2 ** 64)))
        self.perm = perm_rng.permutation(vocab_size).astype(np.int32)

    def batch(self, global_step: int, shard: int, num_shards: int,
              batch_per_shard: int, seq_len: int) -> Dict[str, np.ndarray]:
        # counter-based RNG -> restartable + order-independent
        key = (self.seed * 0x9E3779B97F4A7C15
               + (global_step + 1) * num_shards + shard) % (2 ** 64)
        rng = np.random.Generator(np.random.Philox(key=key))
        n = seq_len + 1
        toks = np.empty((batch_per_shard, n), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch_per_shard)
        noise_mask = rng.random((batch_per_shard, n)) < self.noise
        noise_toks = rng.integers(0, self.vocab, (batch_per_shard, n),
                                  dtype=np.int32)
        for t in range(1, n):
            nxt = self.perm[toks[:, t - 1]]
            toks[:, t] = np.where(noise_mask[:, t], noise_toks[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MMapTokens:
    """Binary token file (int32) read with np.memmap; shard-strided access."""

    def __init__(self, path: str, vocab_size: int):
        self.arr = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab = vocab_size

    def batch(self, global_step: int, shard: int, num_shards: int,
              batch_per_shard: int, seq_len: int) -> Dict[str, np.ndarray]:
        n = self.arr.shape[0]
        stride = seq_len + 1
        seqs_total = n // stride
        out = np.empty((batch_per_shard, stride), np.int32)
        for i in range(batch_per_shard):
            idx = (global_step * num_shards * batch_per_shard
                   + shard * batch_per_shard + i) % seqs_total
            out[i] = self.arr[idx * stride:(idx + 1) * stride]
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}


def local_rows(batch: Dict[str, np.ndarray], index: int,
               count: int) -> Dict[str, np.ndarray]:
    """Data-parallel rank `index` of `count`'s rows of a global batch: the
    index-th of count equal row blocks, as the JAX package's batch sharding
    over ("pod", "data") hands them out."""
    def rows(x):
        if x.shape[0] % count:
            raise ValueError(f"a global batch of {x.shape[0]} rows does not split "
                             f"over {count} data-parallel ranks")
        n = x.shape[0] // count
        return x[index * n:(index + 1) * n]
    return {k: rows(v) for k, v in batch.items()}


class DataLoader:
    """Restartable loader for one (pod, data) shard with double-buffer
    prefetch."""

    def __init__(self, source, *, shard: int, num_shards: int,
                 batch_per_shard: int, seq_len: int, state: Optional[DataState] = None):
        self.source = source
        self.shard = shard
        self.num_shards = num_shards
        self.batch_per_shard = batch_per_shard
        self.seq_len = seq_len
        self.state = state or DataState()
        self._next = None

    @property
    def global_step(self) -> int:
        return self.state.epoch * 1_000_000 + self.state.step_in_epoch

    def _fetch(self):
        return self.source.batch(self.global_step, self.shard, self.num_shards,
                                 self.batch_per_shard, self.seq_len)

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._next if self._next is not None else self._fetch()
        self.state.step_in_epoch += 1
        self._next = self._fetch()    # prefetch (synchronous stand-in for
        return batch                  # the async host thread on real pods)

    def __iter__(self):
        return self

    def snapshot(self) -> dict:
        return self.state.to_dict()

    def restore(self, d: dict):
        self.state = DataState.from_dict(d)
        self._next = None

"""Deterministic, shard-aware synthetic LM data pipeline (the port's copy of
``repro.data.pipeline``, numpy only).

Tokens follow a fixed random first-order Markov chain (seeded), so the
stream has learnable structure: training loss decreases toward the chain's
conditional entropy — which gives the end-to-end example a real convergence
signal without shipping a corpus.

Sharding: `shard_batch(step, shard_idx, n_shards)` generates exactly the
rows this data shard owns, from `fold_in(seed, (step, global_row))` — every
host draws identical global content without communication, and restarts at
any step are bit-reproducible (checkpoint/restart only needs `step`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4  # out-degree of the Markov chain

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # sparse random transition structure: each state -> `branching`
        # successors with dirichlet weights
        self.succ = rng.randint(0, self.vocab, size=(self.vocab, self.branching))
        alpha = rng.dirichlet(np.ones(self.branching), size=self.vocab)
        self.cum = np.cumsum(alpha, axis=1).astype(np.float64)

    def _row(self, step: int, row: int) -> np.ndarray:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 65_537 + row) % (2**31 - 1)
        )
        out = np.empty(self.seq_len + 1, np.int32)
        s = rng.randint(self.vocab)
        u = rng.rand(self.seq_len + 1)
        for t in range(self.seq_len + 1):
            out[t] = s
            j = int(np.searchsorted(self.cum[s], u[t]))
            s = int(self.succ[s, min(j, self.branching - 1)])
        return out

    def shard_batch(self, step: int, shard_idx: int = 0, n_shards: int = 1):
        rows_per = self.global_batch // n_shards
        rows = range(shard_idx * rows_per, (shard_idx + 1) * rows_per)
        seqs = np.stack([self._row(step, r) for r in rows])
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }

    def entropy_floor(self) -> float:
        """The chain's conditional entropy (nats) — the loss floor."""
        alpha = np.diff(
            np.concatenate([np.zeros((self.vocab, 1)), self.cum], axis=1), axis=1
        )
        h = -np.sum(alpha * np.log(np.maximum(alpha, 1e-12)), axis=1)
        return float(np.mean(h))

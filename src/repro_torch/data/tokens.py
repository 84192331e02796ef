"""Deterministic sharded synthetic token pipeline: the port's copy of
``repro/data/tokens.py`` (numpy only; every batch is the reference's, byte for byte).

Batches are keyed by (seed, step, global row index), so that:
  * every data-parallel rank reads only its shard (no coordination),
  * checkpoint/restart resumes the stream exactly (the state is the step),
  * a rescaled job re-partitions the *same* global stream deterministically.

Synthetic distribution: a Zipfian token draw and a Markov repeat, so batches
have a predictable structure and the loss goes down.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3

    def _rng(self, step: int, index: int) -> np.random.Generator:
        # Philox keyed by (seed, step, global index): order-independent
        return np.random.Generator(np.random.Philox(key=self.seed, counter=[0, 0, step, index]))

    def global_batch_at(self, step: int) -> np.ndarray:
        return self.shard_batch(step, shard=0, num_shards=1)

    def shard_batch(self, step: int, shard: int, num_shards: int) -> np.ndarray:
        """(global_batch/num_shards, seq_len+1) int32: inputs and next-token labels."""
        if self.global_batch % num_shards:
            raise ValueError(f"global_batch {self.global_batch} % shards {num_shards} != 0")
        per = self.global_batch // num_shards
        out = np.empty((per, self.seq_len + 1), np.int32)
        v = self.vocab_size
        for i in range(per):
            rng = self._rng(step, shard * per + i)
            z = rng.zipf(self.zipf_a, size=self.seq_len + 1).astype(np.int64)
            seq = (z - 1) % v
            # with p=0.5 repeat the previous token + 1 (predictable)
            rep = rng.random(self.seq_len + 1) < 0.5
            for t in range(1, seq.size):
                if rep[t]:
                    seq[t] = (seq[t - 1] + 1) % v
            out[i] = seq.astype(np.int32)
        return out

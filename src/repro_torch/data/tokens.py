"""Synthetic token pipeline for LM training (twin of
`repro/data/tokens.py`, numpy only: a copy, so the same
`SeedSequence([seed, index])` draws give the same batches bit for bit).

Deterministic, seekable, shardable: batch i is a pure function of
(seed, i), so any host can regenerate any step's data after a failure or an
elastic re-shard.

The stream is a Zipf-ish unigram mixture with short-range repetition so a
trained model shows a decreasing, non-trivial loss curve (pure uniform
tokens would bottom out at log V immediately).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokenDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.3

    def _unigram(self):
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        return probs / probs.sum()

    def batch(self, index: int, *, lo: int = 0, hi: int | None = None):
        """Batch rows [lo, hi) of global batch `index` (host data shard):
        {'tokens', 'targets'} as (rows, seq_len) int32 numpy arrays."""
        hi = self.global_batch if hi is None else hi
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index]))
        probs = self._unigram()
        b = self.global_batch
        s = self.seq_len + 1
        toks = rng.choice(self.vocab, size=(b, s), p=probs).astype(np.int32)
        # short-range repetition: with prob repeat_p copy the token 2 back
        rep = rng.random((b, s)) < self.repeat_p
        for shift in (2,):
            toks[:, shift:] = np.where(rep[:, shift:],
                                       toks[:, :-shift], toks[:, shift:])
        toks = toks[lo:hi]
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def make_token_batches(vocab: int, seq_len: int, global_batch: int,
                       n_batches: int, *, seed: int = 0):
    ds = SyntheticTokenDataset(vocab=vocab, seq_len=seq_len,
                               global_batch=global_batch, seed=seed)
    for i in range(n_batches):
        yield ds.batch(i)

"""Synthetic-but-learnable LM data pipeline.

Sequences are sampled from a fixed random bigram Markov chain over the
vocabulary, so a model that learns anything drives loss below the unigram
entropy — giving the train examples/tests a real convergence signal
without any external dataset. Deterministic, shardable, restart-exact
(the stream is indexed by step, so checkpoint replay sees identical data).

Carried over from the reference as it is (numpy). A step's seed is
``hash(("bigram", step))``, which Python salts per process: the port's
and the reference's batches agree within one process, and a run replays
its own batches after a restart, but two processes draw different ones.
"""
from __future__ import annotations

import numpy as np


class BigramStream:
    def __init__(self, vocab: int, *, branch: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        # sparse-ish bigram: each token transitions to `branch` successors
        succ = rng.integers(0, vocab, size=(vocab, branch))
        self.succ = succ.astype(np.int32)
        self.branch = branch

    def batch(self, step: int, batch: int, seq: int):
        """Deterministic (tokens, labels) for a given step index."""
        rng = np.random.default_rng(hash(("bigram", step)) & 0x7FFFFFFF)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        choices = rng.integers(0, self.branch, size=(batch, seq))
        for t in range(seq):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    @property
    def bigram_entropy(self) -> float:
        return float(np.log(self.branch))

    @property
    def unigram_entropy(self) -> float:
        return float(np.log(self.vocab))

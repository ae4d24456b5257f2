"""Predictive prefetching — first-order Markov over confirmed hits (§4.3).

The model learns P(q_{i+1} | q_i) from the stream of *validated* queries
(intent-level transitions, so paraphrases of one topic share a state).
When the top transition probability exceeds the confidence threshold and
the predicted item is absent, the engine issues an async fetch; the new SE
enters with freq = 0, making unused speculation the first eviction victim
(self-correcting pollution control).
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Hashable, Optional


@dataclasses.dataclass
class Prediction:
    state: Hashable
    prob: float
    support: int


class MarkovPrefetcher:
    def __init__(self, *, confidence: float = 0.5, min_support: int = 3,
                 max_states: int = 100_000, max_sessions: int = 10_000):
        self.confidence = confidence
        self.min_support = min_support
        self.max_states = max_states
        self.max_sessions = max_sessions
        self.trans: dict[Hashable, Counter] = defaultdict(Counter)
        self.totals: Counter = Counter()
        # predecessor per observation stream: concurrent requests
        # interleave their validated queries, and a single global chain
        # would record transitions between unrelated sessions. The engine
        # keys by the request's session id, so the learned table is the
        # same whether streams run sequentially or interleaved. LRU-
        # bounded at max_sessions: workloads mint fresh session ids
        # forever, and only recently-active chains can still extend.
        self._prev: dict[Hashable, Hashable] = {}

    def observe(self, state: Hashable, key: Hashable = None) -> None:
        """Feed one validated (hit-or-fetched) query state.

        ``key`` identifies the observation stream (session/request id);
        transitions are only learned between consecutive states of the
        SAME stream."""
        prev = self._prev.pop(key, None)
        if prev is not None and prev != state:
            if len(self.trans) < self.max_states or prev in self.trans:
                self.trans[prev][state] += 1
                self.totals[prev] += 1
        self._prev[key] = state  # pop+reinsert = move to LRU tail
        if len(self._prev) > self.max_sessions:
            self._prev.pop(next(iter(self._prev)))

    def reset_session(self, key: Hashable = None) -> None:
        self._prev.pop(key, None)

    def predict(self, state: Hashable) -> Optional[Prediction]:
        total = self.totals.get(state, 0)
        if total < self.min_support:
            return None
        nxt, cnt = self.trans[state].most_common(1)[0]
        p = cnt / total
        if p >= self.confidence:
            return Prediction(nxt, p, cnt)
        return None

"""Synthetic semantic world — the ground-truth universe behind the
behavioural experiments.

The paper evaluates on HotpotQA/Musique/2Wiki/Zilliz questions with a real
embedding model. Offline, we construct an equivalent *controlled* world:

* N intents; each has a unit-norm cluster center, an answer, a staticity
  class, a topic group (for correlated trends), and paraphrases.
* embed(query) = normalize(center + σ_para · noise) — paraphrases of one
  intent are tightly clustered (cos ≈ 0.97+).
* A fraction of intents come in *confusable pairs*: centers engineered to
  cosine ≈ confusable_cos (default 0.93 > τ_sim) with different answers —
  the "apple nutrition facts" vs "Apple stock price" failure mode that
  defeats pure-ANN caches and makes the semantic judge necessary (§6.6).

Query strings are structured ("q:<intent>:<paraphrase>") so ground truth
(same_intent, answer, staticity) is exact and experiments are reproducible.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Intent:
    iid: int
    answer: str
    staticity: int
    topic: int
    confusable_with: int | None = None


class SemanticWorld:
    def __init__(
        self,
        n_intents: int = 1000,
        dim: int = 128,
        *,
        n_topics: int = 10,
        confusable_frac: float = 0.2,
        confusable_cos: float = 0.93,
        sigma_para: float = 0.12,
        value_bytes: tuple[int, int] = (512, 4096),
        seed: int = 0,
    ):
        self.dim = dim
        self.sigma_para = sigma_para
        self.rng = np.random.default_rng(seed)
        self.n_intents = n_intents

        centers = self.rng.standard_normal((n_intents, dim)).astype(np.float32)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        # carve confusable pairs: c_b = cos·c_a + sin·orth
        n_pairs = int(n_intents * confusable_frac / 2)
        self.intents: list[Intent] = []
        pair_partner = {}
        for p in range(n_pairs):
            a, b = 2 * p, 2 * p + 1
            ca = centers[a]
            orth = self.rng.standard_normal(dim).astype(np.float32)
            orth -= (orth @ ca) * ca
            orth /= np.linalg.norm(orth)
            cos = confusable_cos
            centers[b] = cos * ca + np.sqrt(1 - cos * cos) * orth
            pair_partner[a] = b
            pair_partner[b] = a
        self.centers = centers

        stat_choices = np.array([1, 2, 3, 5, 7, 9, 10])
        stat_probs = np.array([0.1, 0.1, 0.15, 0.2, 0.15, 0.15, 0.15])
        for i in range(n_intents):
            self.intents.append(
                Intent(
                    iid=i,
                    answer=f"answer-{i}",
                    staticity=int(self.rng.choice(stat_choices, p=stat_probs)),
                    topic=int(self.rng.integers(0, n_topics)),
                    confusable_with=pair_partner.get(i),
                )
            )
        self.value_bytes = value_bytes
        self._sizes = self.rng.integers(
            value_bytes[0], value_bytes[1], size=n_intents
        )
        # heterogeneous tool economics: ~25% of intents come from an
        # expensive/slow tool (premium API), the rest from the cheap one —
        # the heterogeneity LCFU's cost-aware retention exploits (Table 6)
        premium = self.rng.random(n_intents) < 0.25
        self._cost_mult = np.where(premium, 8.0, 1.0)
        self._lat_mult = np.where(premium, 4.0, 1.0)

    # ------------------------------------------------------------ queries

    def query(self, intent: int, paraphrase: int) -> str:
        return f"q:{intent}:{paraphrase}"

    def intent_of(self, query: str) -> int:
        return int(query.split(":")[1])

    def same_intent(self, q1: str, q2: str) -> bool:
        return self.intent_of(q1) == self.intent_of(q2)

    def staticity(self, query: str) -> int:
        return self.intents[self.intent_of(query)].staticity

    def answer(self, query: str) -> str:
        return self.intents[self.intent_of(query)].answer

    def value_size(self, query: str) -> int:
        return int(self._sizes[self.intent_of(query)])

    def topic(self, query: str) -> int:
        return self.intents[self.intent_of(query)].topic

    def embed(self, query: str) -> np.ndarray:
        iid = self.intent_of(query)
        para = int(query.split(":")[2])
        # deterministic per (intent, paraphrase) noise, unit direction so
        # cos(paraphrase, center) ≈ 1/√(1+σ²) regardless of dim
        rng = np.random.default_rng((iid * 1_000_003 + para) & 0x7FFFFFFF)
        n = rng.standard_normal(self.dim).astype(np.float32)
        n /= np.linalg.norm(n)
        v = self.centers[iid] + self.sigma_para * n
        return (v / np.linalg.norm(v)).astype(np.float32)

    def cost_mult(self, query: str) -> float:
        return float(self._cost_mult[self.intent_of(query)])

    def latency_mult(self, query: str) -> float:
        return float(self._lat_mult[self.intent_of(query)])

    # ------------------------------------------------- freshness surface
    # The static world exposes the same time-aware API as MutableWorld so
    # the engine/cache/federation never branch on the world flavor: here
    # every intent is eternally at version 0 and never updates.

    def intent_version(self, iid: int, t: float) -> int:
        """Knowledge version of intent ``iid`` as of virtual time ``t``."""
        return 0

    def version_at(self, query: str, t: float) -> int:
        return self.intent_version(self.intent_of(query), t)

    def answer_at(self, query: str, t: float) -> str:
        """Ground-truth answer as of virtual time ``t``."""
        return self.answer(query)

    def next_update(self, iid: int, t: float) -> float:
        """Virtual time of the first update strictly after ``t`` (inf =
        this intent never changes). The origin change-feed schedules its
        notification events from this."""
        return float("inf")

    # the "live tool": ground truth fetch (used by recalibration too).
    # ``t`` is the virtual instant the origin serves the request; the
    # static world ignores it.
    def fetch(self, query: str, t: float | None = None) -> str:
        return self.answer_at(query, 0.0 if t is None else t)

    def equivalent(self, cached_value, ground_value) -> bool:
        return cached_value == ground_value


class MutableWorld(SemanticWorld):
    """Semantic world whose knowledge CHANGES over virtual time.

    Each intent's answer updates on a deterministic schedule driven
    *inversely* by its staticity class: class-1 (ephemeral) intents update
    every ``churn_min_period`` seconds, class-10 (stable) every
    ``churn_max_period`` — the same exponential shape as
    ``ttl_from_staticity``, so the staticity metadata the judge estimates
    is *empirically meaningful*: a TTL derived from it either does or does
    not outrun the intent's real update cadence.

    Updates are versioned, never random at query time: intent ``i``
    updates at ``phase_i + k · period_i`` (``phase_i`` a seeded per-intent
    offset in ``[0, period_i)`` so updates de-synchronize), and
    ``answer_at(q, t)`` returns ``answer-<i>`` before the first update,
    ``answer-<i>-v<k>`` after the k-th. Cached values therefore go stale
    exactly when the schedule says so, and ``info_accuracy`` measures
    staleness, not judge noise alone. Embeddings and value sizes stay
    fixed — the *knowledge value* churns, not the query semantics.

    ``churn_frac`` < 1 leaves a seeded fraction of intents permanently
    static (period = inf), modelling the mixed world the staticity score
    exists for. ``churn_frac=0`` is behaviourally identical to the static
    :class:`SemanticWorld`.
    """

    def __init__(
        self,
        n_intents: int = 1000,
        dim: int = 128,
        *,
        churn_min_period: float = 60.0,
        churn_max_period: float = 3600.0,
        churn_frac: float = 1.0,
        **kw,
    ):
        super().__init__(n_intents, dim, **kw)
        self.churn_min_period = churn_min_period
        self.churn_max_period = churn_max_period
        stat = np.array([it.staticity for it in self.intents], np.float64)
        frac = (np.clip(stat, 1, 10) - 1) / 9.0
        period = churn_min_period * (
            churn_max_period / churn_min_period
        ) ** frac
        # phase BEFORE the churn mask: one rng draw per intent either way,
        # so the schedule of churning intents is invariant to churn_frac
        phase = self.rng.random(n_intents) * period
        churns = self.rng.random(n_intents) < churn_frac
        # inf * random() would be nan for random()==0 — set both explicitly
        self._period = np.where(churns, period, np.inf)
        self._phase = np.where(churns, phase, np.inf)

    def intent_version(self, iid: int, t: float) -> int:
        ph = float(self._phase[iid])
        if t < ph:
            return 0
        return int((t - ph) // float(self._period[iid])) + 1

    def answer_at(self, query: str, t: float) -> str:
        iid = self.intent_of(query)
        v = self.intent_version(iid, t)
        return f"answer-{iid}" if v == 0 else f"answer-{iid}-v{v}"

    def next_update(self, iid: int, t: float) -> float:
        ph = float(self._phase[iid])
        if not np.isfinite(ph):
            return float("inf")
        per = float(self._period[iid])
        u = ph + self.intent_version(iid, t) * per
        # strict progress despite float rounding: at t == ph + k·per the
        # floor in intent_version can land one step short, which would
        # return u == t and spin the change feed at a frozen instant
        while u <= t:
            u += per
        return u

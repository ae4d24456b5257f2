"""Workload generators matching the paper's three evaluation families
(§6.1): skewed (Zipf-0.99) search, trend-driven bursty search, and
SWE-bench-style code-file access.

Each generator yields a list of :class:`Request` with arrival times (for
open-loop runs) — the engine can also replay them closed-loop at a fixed
concurrency (Fig 10).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.world import SemanticWorld


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    query: str                 # round-0 tool query
    session: int = 0
    n_rounds: int = 1          # agent think→tool→observe rounds
    round_queries: tuple = ()  # per-round queries (len == n_rounds);
                               # defaults to (query,) — real agents refine
                               # the query each round, so generators fill
                               # this with distinct paraphrases/intents

    def query_for_round(self, r: int) -> str:
        if self.round_queries:
            return self.round_queries[min(r, len(self.round_queries) - 1)]
        return self.query


def _zipf_probs(n: int, s: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-s)
    return w / w.sum()


def zipf_workload(
    world: SemanticWorld,
    n_requests: int,
    *,
    zipf_s: float = 0.99,
    n_paraphrases: int = 100,
    rate: float = 4.0,
    n_rounds: int = 2,
    seed: int = 0,
) -> list[Request]:
    """Skewed search workload: intents drawn Zipf(s), each query a random
    paraphrase — exact-match caches miss on wording changes, semantic
    caches group them (paper Fig 7)."""
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(world.n_intents, zipf_s)
    # shuffle intent ranks so confusable pairs land across the popularity
    # spectrum rather than only in the head
    perm = rng.permutation(world.n_intents)
    out = []
    t = 0.0
    for i in range(n_requests):
        t += rng.exponential(1.0 / rate)
        intent = int(perm[rng.choice(world.n_intents, p=probs)])
        rounds = []
        for r in range(n_rounds):
            # each reasoning round issues a fresh phrasing; ~30% of later
            # rounds drill into a correlated follow-up intent
            it = intent
            if r > 0 and rng.random() < 0.3:
                it = (intent + 1) % world.n_intents
            rounds.append(world.query(it, int(rng.integers(0, n_paraphrases))))
        out.append(
            Request(i, t, rounds[0], session=i, n_rounds=n_rounds,
                    round_queries=tuple(rounds))
        )
    return out


def trend_workload(
    world: SemanticWorld,
    n_requests: int,
    *,
    duration: float = 600.0,   # 12h of Trends compressed to 10 min (§6.1)
    n_waves: int = 4,
    wave_width_frac: float = 0.12,
    base_rate_frac: float = 0.15,
    n_paraphrases: int = 100,
    topic_intents: int = 40,
    n_rounds: int = 2,
    seed: int = 1,
) -> list[Request]:
    """Bursty, correlated workload: n_waves topic spikes (Gaussian bumps in
    arrival intensity), each wave concentrated on one topic's intents —
    the LCFU staticity/TTL path is what absorbs these (paper Fig 8)."""
    rng = np.random.default_rng(seed)
    wave_centers = np.linspace(0.15, 0.85, n_waves) * duration
    width = wave_width_frac * duration
    topics = rng.permutation(
        max(world.n_intents // topic_intents, n_waves)
    )[:n_waves]

    # thinning-based inhomogeneous Poisson
    def intensity(t):
        lam = base_rate_frac
        for c in wave_centers:
            lam += np.exp(-0.5 * ((t - c) / width) ** 2)
        return lam

    grid = np.linspace(0, duration, 2048)
    total_mass = np.trapezoid([intensity(t) for t in grid], grid)
    out = []
    t = 0.0
    i = 0
    lam_max = intensity(wave_centers[0]) * 1.2
    scale = n_requests / total_mass / lam_max * lam_max
    while i < n_requests:
        t += rng.exponential(total_mass / n_requests / max(intensity(t), 1e-3))
        if t > duration:
            t = duration  # tail burst clipped
        # pick the wave whose bump dominates at t (or background)
        weights = np.array(
            [np.exp(-0.5 * ((t - c) / width) ** 2) for c in wave_centers]
            + [base_rate_frac]
        )
        weights /= weights.sum()
        k = int(rng.choice(n_waves + 1, p=weights))
        if k < n_waves:
            base = int(topics[k]) * topic_intents
            intent = (base + int(rng.zipf(1.5))) % world.n_intents
        else:
            intent = int(rng.integers(0, world.n_intents))
        rounds = []
        for r in range(n_rounds):
            it = intent if (r == 0 or rng.random() >= 0.3) \
                else (intent + 1) % world.n_intents
            rounds.append(world.query(it, int(rng.integers(0, n_paraphrases))))
        out.append(
            Request(i, float(t), rounds[0], session=i, n_rounds=n_rounds,
                    round_queries=tuple(rounds))
        )
        i += 1
    out.sort(key=lambda r: r.arrival)
    return out


# SWE-bench file-access frequencies for sqlfluff (paper Table 2)
SWE_FILE_FREQ = [1.0, 0.28, 0.22, 0.14, 0.1, 0.08, 0.04, 0.04, 0.04]


def swe_workload(
    world: SemanticWorld,
    n_tasks: int,
    *,
    files_per_task: tuple[int, int] = (3, 8),
    n_paraphrases: int = 6,
    rate: float = 2.0,
    tail_files: int = 60,
    seed: int = 2,
) -> list[Request]:
    """Code-agent workload: each task (GitHub issue) touches a set of repo
    files; hot core files recur across tasks per Table 2, the long tail is
    task-specific. One request per file access; requests of one task share
    a session (prefetcher learns file→file transitions)."""
    rng = np.random.default_rng(seed)
    n_core = len(SWE_FILE_FREQ)
    freqs = np.array(SWE_FILE_FREQ + [0.02] * tail_files)
    probs = freqs / freqs.sum()
    n_files = len(freqs)
    out = []
    t = 0.0
    rid = 0
    for task in range(n_tasks):
        t += rng.exponential(1.0 / rate)
        n_f = int(rng.integers(files_per_task[0], files_per_task[1] + 1))
        # core file 0 is required by nearly all tasks (freq 1.0)
        files = [0] if rng.random() < 0.95 else []
        files += list(
            rng.choice(n_files, size=n_f, replace=False, p=probs)
        )
        dt = 0.0
        for f in dict.fromkeys(files):  # dedupe, keep order
            intent = int(f) % world.n_intents
            para = int(rng.integers(0, n_paraphrases))
            out.append(
                Request(
                    rid, float(t + dt), world.query(intent, para),
                    session=task, n_rounds=1,
                )
            )
            rid += 1
            dt += float(rng.exponential(0.5))
    out.sort(key=lambda r: r.arrival)
    for i, r in enumerate(out):
        r.rid = i
    return out


def longtail_workload(
    world: SemanticWorld,
    n_requests: int,
    *,
    head_intents: int = 48,
    head_frac: float = 0.35,
    tail_len: int | None = None,
    zipf_s: float = 0.9,
    n_paraphrases: int = 30,
    rate: float = 4.0,
    seed: int = 0,
) -> list[Request]:
    """Capacity-pressure workload for the tiered-storage experiments
    (DESIGN.md §10): a small Zipf head every request might touch, plus a
    cyclic scan over a long tail of ``tail_len`` intents.

    The scan is the classic capacity-killer: each tail intent returns
    after a reuse distance of exactly ``tail_len`` draws, so any tier
    whose byte budget holds fewer than ``tail_len`` values evicts the
    entry before its next use — every tail revisit pays the WAN fetch.
    A warm tier at the same TOTAL bytes holds ~1/value_ratio× more
    entries, converting those refetches into demote→promote round trips.
    Paraphrases rotate per visit so exact-match caches never hit.
    """
    rng = np.random.default_rng(seed)
    if tail_len is None:
        tail_len = world.n_intents - head_intents
    if head_intents + tail_len > world.n_intents:
        raise ValueError("head + tail exceeds world intents")
    perm = rng.permutation(world.n_intents)
    head = perm[:head_intents]
    tail = perm[head_intents:head_intents + tail_len]
    p_head = _zipf_probs(head_intents, zipf_s)
    out = []
    t = 0.0
    pos = 0
    for i in range(n_requests):
        t += rng.exponential(1.0 / rate)
        if rng.random() < head_frac:
            intent = int(head[rng.choice(head_intents, p=p_head)])
        else:
            intent = int(tail[pos % tail_len])
            pos += 1
        q = world.query(intent, int(rng.integers(0, n_paraphrases)))
        out.append(Request(i, t, q, session=i, n_rounds=1))
    return out


def churn_workload(
    world: SemanticWorld,
    n_requests: int,
    *,
    zipf_s: float = 0.9,
    n_paraphrases: int = 40,
    rate: float = 4.0,
    seed: int = 0,
) -> list[Request]:
    """Freshness workload (DESIGN.md §11): steady Zipf revisits meant to
    run against a :class:`~repro_torch.data.world.MutableWorld`.

    Single-round requests on a fixed moderate-skew popularity law, so
    the same intents are revisited throughout the run and the run
    duration (``n_requests / rate``) spans several update periods of the
    low-staticity intents — every revisit-after-update is a chance to
    serve stale knowledge, which is exactly what the freshness policies
    (TTL-only vs invalidation vs invalidation+refresh-ahead) differ on.
    Paraphrases rotate per visit so exact-match caches can't shortcut.
    The generator itself is world-agnostic: on a static world it is just
    a single-round Zipf stream (and ``stale_hits`` must stay 0).
    """
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(world.n_intents, zipf_s)
    perm = rng.permutation(world.n_intents)
    out = []
    t = 0.0
    for i in range(n_requests):
        t += rng.exponential(1.0 / rate)
        intent = int(perm[rng.choice(world.n_intents, p=probs)])
        q = world.query(intent, int(rng.integers(0, n_paraphrases)))
        out.append(Request(i, t, q, session=i, n_rounds=1))
    return out


def region_workloads(
    world: SemanticWorld,
    n_per_region: int,
    n_regions: int,
    *,
    overlap: float = 0.5,
    shared_frac: float = 0.3,
    zipf_s: float = 0.99,
    rate: float = 2.0,
    n_paraphrases: int = 100,
    n_rounds: int = 2,
    seed: int = 0,
) -> list[list[Request]]:
    """Region-skewed request streams for the federation experiments
    (DESIGN.md §9).

    The intent space splits into one *shared* pool (``shared_frac`` of all
    intents — globally hot knowledge every region asks about) and
    ``n_regions`` disjoint *private* pools (region-local interest). Each
    request draws from the shared pool with probability ``overlap``, else
    from its region's private pool; both draws are Zipf(``zipf_s``) within
    the pool. ``overlap`` is therefore the knob peering exploits: at 0 the
    regions are disjoint and peeking siblings is pure overhead; at 1 every
    region serves the same hot set and a sibling has almost everything.

    Arrivals are independent per-region Poisson(``rate``); request ids are
    globally unique across regions (records can be merged), and each
    request keeps its own session id so per-region prefetchers learn
    uncontaminated transition chains.
    """
    if not 0.0 <= overlap <= 1.0:
        raise ValueError("overlap must be in [0, 1]")
    rng = np.random.default_rng(seed)
    n = world.n_intents
    perm = rng.permutation(n)
    n_shared = max(int(n * shared_frac), 1)
    shared = perm[:n_shared]
    private_all = perm[n_shared:]
    if len(private_all) < n_regions:
        raise ValueError("need at least one private intent per region")
    privates = np.array_split(private_all, n_regions)
    p_shared = _zipf_probs(len(shared), zipf_s)
    out: list[list[Request]] = []
    rid = 0
    for r in range(n_regions):
        priv = privates[r]
        p_priv = _zipf_probs(len(priv), zipf_s)
        reqs = []
        t = 0.0
        for _ in range(n_per_region):
            t += rng.exponential(1.0 / rate)
            if rng.random() < overlap:
                intent = int(shared[rng.choice(len(shared), p=p_shared)])
            else:
                intent = int(priv[rng.choice(len(priv), p=p_priv)])
            rounds = []
            for rr in range(n_rounds):
                it = intent
                if rr > 0 and rng.random() < 0.3:
                    it = (intent + 1) % n
                rounds.append(
                    world.query(it, int(rng.integers(0, n_paraphrases)))
                )
            reqs.append(
                Request(rid, t, rounds[0], session=rid, n_rounds=n_rounds,
                        round_queries=tuple(rounds))
            )
            rid += 1
        out.append(reqs)
    return out


def closed_loop(requests: list[Request], concurrency: int) -> list[Request]:
    """Strip arrival times for closed-loop replay at fixed concurrency —
    the engine dispatches the next request when a slot frees (Fig 10)."""
    out = [dataclasses.replace(r, arrival=0.0) for r in requests]
    return out

"""Remote data service emulation: WAN latency, per-call cost, API rate
limits with retry/backoff — the paper's cross-region deployment constants
(300–500 ms, $0.005/call, 100 QPM — §2.2, §6.1). All in virtual time."""
from __future__ import annotations

import dataclasses

import numpy as np


class TokenBucket:
    """QPM rate limiter in virtual time."""

    def __init__(self, qpm: float, burst: float | None = None):
        self.rate = qpm / 60.0
        self.capacity = burst if burst is not None else max(qpm / 12.0, 1.0)
        self.tokens = self.capacity
        self.t_last = 0.0

    def _refill(self, now: float):
        # Clamp to monotonic time: interleaved fetches resolve future
        # retry instants (fetch() advances its local `t` through backoff),
        # so a later-issued fetch can legally arrive with an *earlier*
        # timestamp. Refilling with a negative dt would subtract tokens
        # and drag t_last backwards (double-crediting the next refill);
        # out-of-order callers simply see the bucket as of t_last.
        if now <= self.t_last:
            return
        self.tokens = min(
            self.capacity, self.tokens + (now - self.t_last) * self.rate
        )
        self.t_last = now

    def try_acquire(self, now: float) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def headroom(self, now: float) -> float:
        self._refill(now)
        return self.tokens / self.capacity


@dataclasses.dataclass
class FetchOutcome:
    finish: float          # virtual completion time
    cost: float
    retries: int
    throttled_wait: float
    failed: bool = False   # terminal failure (brownout + retries exhausted)


class RemoteDataService:
    """Latency ~ U(lat_lo, lat_hi); throttle -> exponential backoff retry."""

    def __init__(
        self,
        *,
        lat_lo: float = 0.3,
        lat_hi: float = 0.5,
        cost_per_call: float = 0.005,
        qpm: float | None = 100.0,
        backoff0: float = 0.5,
        backoff_mult: float = 2.0,
        max_retries: int = 8,
        seed: int = 0,
        faults=None,
        region: int = 0,
    ):
        self.lat_lo = lat_lo
        self.lat_hi = lat_hi
        self.cost_per_call = cost_per_call
        self.limiter = TokenBucket(qpm) if qpm else None
        self.backoff0 = backoff0
        self.backoff_mult = backoff_mult
        self.max_retries = max_retries
        self.rng = np.random.default_rng(seed)
        # fault injection (DESIGN.md §17): brownout error/throttle draws
        # come from a dedicated rng that is only advanced inside an
        # active origin_brownout window, so the main latency stream —
        # and therefore every fault-free run — is byte-identical.
        self.faults = faults
        self.region = region
        self.fault_rng = np.random.default_rng(seed + 7919)
        # counters
        self.calls = 0
        self.attempts = 0
        self.retries = 0
        self.failed = 0
        self.total_cost = 0.0
        self.throttled_wait = 0.0

    def sample_latency(self) -> float:
        return float(self.rng.uniform(self.lat_lo, self.lat_hi))

    def fetch(self, now: float, *, latency_mult: float = 1.0,
              cost_mult: float = 1.0) -> FetchOutcome:
        """One logical fetch (may include throttled retries). The
        multipliers model heterogeneous tools (premium/slow vs cheap)."""
        t = now
        backoff = self.backoff0
        retries = 0
        waited = 0.0
        while True:
            self.attempts += 1
            # origin brownout (DESIGN.md §17): the active window elevates
            # per-attempt error and throttle rates; the dedicated fault
            # rng is only drawn inside a window so fault-free runs keep
            # every stream untouched.
            bw = (self.faults.brownout(self.region, t)
                  if self.faults is not None else None)
            errored = (bw is not None and bw.error_rate > 0.0
                       and float(self.fault_rng.random()) < bw.error_rate)
            choked = (bw is not None and bw.throttle > 0.0
                      and float(self.fault_rng.random()) < bw.throttle)
            if not errored and not choked:
                if self.limiter is None or self.limiter.try_acquire(t):
                    lat = self.sample_latency() * latency_mult
                    cost = self.cost_per_call * cost_mult
                    self.calls += 1
                    self.total_cost += cost
                    self.throttled_wait += waited
                    return FetchOutcome(t + lat, cost, retries, waited)
            # throttled (or brownout error / spurious 429)
            retries += 1
            self.retries += 1
            if retries > self.max_retries:
                if bw is not None:
                    # retries exhausted inside a brownout: terminal
                    # failure — the engine must answer through a
                    # degraded path, not wait the window out here.
                    self.failed += 1
                    self.throttled_wait += waited
                    return FetchOutcome(t, 0.0, retries, waited,
                                        failed=True)
                # final forced wait until a token is definitely available
                wait = max(1.0 / self.limiter.rate, backoff)
            else:
                wait = backoff * float(self.rng.uniform(0.8, 1.2))
            t += wait
            waited += wait
            backoff = min(backoff * self.backoff_mult, 8.0)

    def headroom(self, now: float) -> float:
        return 1.0 if self.limiter is None else self.limiter.headroom(now)

    @property
    def retry_ratio(self) -> float:
        return self.retries / self.attempts if self.attempts else 0.0

"""Overload actuation (DESIGN.md §17): policies that react to the §16
telemetry instead of just alerting on it.

The :class:`OverloadController` closes the loop between the sensing half
(``TimeSeriesSampler`` gauges + ``SLOMonitor`` breach/recovery state) and
the serving engine's degradation seams:

* **shed-to-nojudge** — while the watched latency SLO is breached, or
  while the judge backlog exceeds ``judge_backlog_cap``, requests the
  admission band classified as "judge" are served through the trust
  (nojudge) path instead: the band effectively widens toward trust
  under pressure, so the judge lane stops being the queueing bottleneck.
* **prefetch / refresh-ahead pause** — background origin traffic
  (Markov prefetch, freshness refresh-ahead) is paused while limiter
  headroom is below a floor or the SLO is breached, reserving API
  budget for on-path misses.
* **serve-stale-on-origin-failure** — when a fetch terminates with
  ``FetchOutcome.failed`` (origin brownout, DESIGN.md §17), a
  known-stale but present cache entry beats an error.

Every decision method is a pure function of controller config + monitor
state + the gauge values passed in: no rng, no clock mutation, no
side effects beyond its own counters and trace markers. With
``enabled=False`` (or no controller at all) every policy answers the
legacy way, so runs are bit-identical to a controller-free engine —
that is the §17 neutrality contract, mirrored from §15/§16.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.trace import BACKGROUND, NULL_TRACER


@dataclasses.dataclass
class OverloadConfig:
    """Policy knobs; each policy has an independent off-switch."""
    enabled: bool = True                 # master switch ("off" = armed but inert)
    shed_on_slo: bool = True             # shed-to-nojudge while SLO breached
    slo_name: Optional[str] = None       # watch one SLO (None = any breach)
    judge_backlog_cap: Optional[int] = 16  # shed above this backlog depth
    shed_margin: float = 0.02            # only shed candidates with
                                         # best-sim >= tau_sim + this —
                                         # the band widens toward trust,
                                         # it does not trust everything
                                         # (keeps the accuracy floor)
    pause_prefetch: bool = True          # pause Markov prefetch under pressure
    pause_refresh: bool = True           # pause refresh-ahead under pressure
    min_headroom: float = 0.35           # limiter-headroom floor for background work
    serve_stale_on_failure: bool = True  # stale-but-present beats an error


@dataclasses.dataclass
class OverloadStats:
    """Actuation counters, surfaced via the ``overload.*`` registry
    namespace and (when armed) ``summary()``."""
    shed_hits: int = 0        # judge-classified requests served via trust path
    slo_sheds: int = 0        # ... of which triggered by an SLO breach
    backlog_sheds: int = 0    # ... of which triggered by the backlog cap
    shed_flips: int = 0       # shedding-state transitions (on↔off)
    prefetch_paused: int = 0  # prefetch decisions suppressed
    refresh_paused: int = 0   # refresh-ahead fetches suppressed
    stale_served: int = 0     # failed fetches answered from a stale entry
    failed_retries: int = 0   # failed fetches rescheduled (no stale entry)


class OverloadController:
    """See module docstring. One controller per engine; under federation
    each region's controller shares the fleet :class:`SLOMonitor`."""

    def __init__(self, cfg: Optional[OverloadConfig] = None, *,
                 monitor=None, tracer=None, region: int = 0):
        self.cfg = cfg if cfg is not None else OverloadConfig()
        self.monitor = monitor
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.region = region
        self.stats = OverloadStats()
        self._shedding = False

    # -- sensing ---------------------------------------------------------

    def slo_breached(self) -> bool:
        """Is the watched SLO (or any SLO) currently in breach? Pure
        read of the monitor's hysteresis state."""
        if self.monitor is None:
            return False
        active = self.monitor.active()
        if self.cfg.slo_name is not None:
            return self.cfg.slo_name in active
        return bool(active)

    # -- actuation decisions --------------------------------------------

    def shed_judge(self, now: float, backlog: int, *,
                   best_sim: float = 1.0, tau: float = 0.0) -> bool:
        """Should a request the admission band classified as "judge" be
        served through the trust path instead? Called on-path per
        judge-classified request. Only candidates whose best stage-1
        similarity clears ``tau + shed_margin`` are eligible — shedding
        widens the trust edge toward τ_sim, it never serves matches the
        threshold itself would reject."""
        if not self.cfg.enabled:
            return False
        if best_sim < tau + self.cfg.shed_margin:
            return False
        over_cap = (self.cfg.judge_backlog_cap is not None
                    and backlog >= self.cfg.judge_backlog_cap)
        breached = self.cfg.shed_on_slo and self.slo_breached()
        shed = over_cap or breached
        if shed != self._shedding:
            self._shedding = shed
            self.stats.shed_flips += 1
            self.trace.marker(BACKGROUND, "shed_on" if shed else "shed_off",
                              now, self.region)
        if shed:
            self.stats.shed_hits += 1
            if over_cap:
                self.stats.backlog_sheds += 1
            if breached:
                self.stats.slo_sheds += 1
        return shed

    def allow_prefetch(self, headroom: float, now: float) -> bool:
        """May the Markov prefetcher spend origin budget right now?"""
        if not self.cfg.enabled or not self.cfg.pause_prefetch:
            return True
        if headroom < self.cfg.min_headroom or self.slo_breached():
            self.stats.prefetch_paused += 1
            return False
        return True

    def allow_refresh(self, headroom: float, now: float) -> bool:
        """May refresh-ahead spend origin budget right now?"""
        if not self.cfg.enabled or not self.cfg.pause_refresh:
            return True
        if headroom < self.cfg.min_headroom or self.slo_breached():
            self.stats.refresh_paused += 1
            return False
        return True

    def serve_stale_ok(self) -> bool:
        return self.cfg.enabled and self.cfg.serve_stale_on_failure

    def metrics(self) -> dict:
        return dataclasses.asdict(self.stats)

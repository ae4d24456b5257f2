"""Time-series telemetry: interval sampling of the metrics registry
(DESIGN.md §16).

:class:`TimeSeriesSampler` rides the shared
:class:`~repro_torch.serving.clock.VirtualClock`: every ``interval`` virtual
seconds it snapshots each engine's :class:`~repro_torch.obs.metrics.
MetricsRegistry`, diffs against the previous snapshot, and appends one
sample row — per-window rates (hit-rate, rps, rows-scanned/s,
judge-calls/s), windowed latency percentiles over the requests that
*completed* in the window, live pressure gauges (judge backlog, stage-1
pending, in-flight requests, GPU lane occupancy, limiter headroom,
federation peek queue), and cumulative totals.

**Observational neutrality** — the strict contract everything here is
built around: a sampled run must be bit-identical in virtual time (and
therefore in summary) to an unsampled run.

* The sampler's tick events consume heap sequence numbers, but the seq
  counter is strictly monotonic, so the *relative* order of every other
  pair of events is unchanged — ties between engine events still break
  exactly as before.
* Tick callbacks only **read**: registry collectors, record lists,
  gauge state. The one read that looks mutating — token-bucket headroom
  — is taken through the pure :func:`limiter_headroom` below instead of
  ``TokenBucket.headroom`` (whose ``_refill`` rewrites float state along
  a different operation order than a single later refill would, which
  can flip a ``tokens >= 1.0`` comparison bit).
* The engine / federation run loops terminate on ``done``, not on heap
  exhaustion, so a self-rescheduling sampler can neither extend nor
  hang a run; at most one un-fired tick is left pending.

**Exact reconciliation** — the first snapshot is taken at ``start()``
and :meth:`finalize` emits a final partial-window sample at the run's
last virtual instant, so the integer window deltas telescope: for every
counter, ``sum(window deltas) == final total - start total`` exactly
(integer arithmetic, no float accumulation). The ``obs_timeseries``
benchmark gates on this.

Under federation the "global" topology shares one cache across engines,
so each engine's registry reports the SAME cache counters; fleet
aggregates therefore count cache-derived namespaces (``cache.``,
``scan.``, ``tier.``, ``pipeline.``) once per *distinct cache object*
(the first engine holding it is the owner), while per-engine namespaces
(``remote.``, ``engine.``, ``gauge.``, ``exact.``) sum over every
engine. Gauge aggregation sums counts; ``*_headroom`` gauges take the
fleet ``min`` (the most-constrained region is the pressure signal).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.obs.metrics import percentile

# cache-derived namespaces: counted once per distinct cache object in
# fleet aggregates (the federation "global" topology shares one cache)
_CACHE_NAMESPACES = ("cache.", "scan.", "tier.", "pipeline.")


def limiter_headroom(remote, now: float) -> float:
    """Pure-read token-bucket headroom in [0, 1] — semantically
    ``TokenBucket.headroom(now)`` but WITHOUT the ``_refill`` mutation
    (splitting one refill into two is not float-bit-neutral), so the
    sampler can read it without perturbing the run."""
    lim = getattr(remote, "limiter", None)
    if lim is None:
        return 1.0
    tokens = lim.tokens
    if now > lim.t_last:
        tokens = min(lim.capacity, tokens + (now - lim.t_last) * lim.rate)
    return tokens / lim.capacity


def _d(cur: dict, prev: dict, key: str) -> float | int:
    """Delta of one numeric snapshot key (missing counts as 0)."""
    a = cur.get(key, 0)
    b = prev.get(key, 0)
    a = a if isinstance(a, (int, float)) and not isinstance(a, bool) else 0
    b = b if isinstance(b, (int, float)) and not isinstance(b, bool) else 0
    return a - b


def _lat_stats(lats: Sequence[float]) -> dict:
    """Windowed latency stats over the requests completed in a window;
    all-``None`` when the window completed nothing (an SLO skips
    no-data samples rather than treating them as 0)."""
    if not lats:
        return {"latency_p50": None, "latency_p99": None,
                "latency_max": None, "latency_mean": None}
    return {
        "latency_p50": percentile(lats, 50),
        "latency_p99": percentile(lats, 99),
        "latency_max": float(max(lats)),
        "latency_mean": float(np.mean(lats)),
    }


class TimeSeriesSampler:
    """Fixed-interval registry sampler on the shared virtual clock.

    Parameters
    ----------
    clock : VirtualClock shared by every engine being observed.
    interval : virtual seconds between samples (the window length).
    engines : engines to observe (one for a solo run; one per region
        under federation — they must all share ``clock``).
    federation : optional :class:`~repro_torch.serving.federation.Federation`
        whose queue-depth gauges ride along in fleet samples.
    monitor : optional :class:`~repro_torch.obs.slo.SLOMonitor`; every
        emitted sample is fed to it in order.
    """

    def __init__(self, clock, interval: float, engines,
                 federation=None, monitor=None):
        if interval <= 0:
            raise ValueError("sample interval must be > 0")
        self.clock = clock
        self.interval = float(interval)
        self.engines = list(engines)
        self.federation = federation
        self.monitor = monitor
        self.samples: list[dict] = []
        self._t0: Optional[float] = None
        self._prev_t: float = 0.0
        self._prev: list[dict] = []       # per-engine snapshots
        self._rec_idx: list[int] = []     # records consumed per engine
        self._k = 0                       # ticks scheduled so far
        self._finalized = False
        # fleet-aggregate owner mask: count cache-derived namespaces
        # once per distinct cache object (global topology shares one)
        seen: set[int] = set()
        self._cache_owner: list[bool] = []
        for e in self.engines:
            c = getattr(e, "cache", None)
            own = c is not None and id(c) not in seen
            if c is not None:
                seen.add(id(c))
            self._cache_owner.append(own)

    # ------------------------------------------------------------ clock

    def start(self) -> None:
        """Take the baseline snapshot at the current virtual instant and
        schedule the first tick. Call once, before the run loop."""
        if self._t0 is not None:
            raise RuntimeError("sampler already started")
        self._t0 = self.clock.now
        self._prev_t = self._t0
        self._prev = [e.metrics.snapshot() for e in self.engines]
        self._rec_idx = [len(e.records) for e in self.engines]
        # the start-of-run baseline the cumulative totals subtract (a
        # sampler attached mid-run still reconciles exactly)
        self._base = list(self._prev)
        self._base_recs = list(self._rec_idx)
        self._schedule()

    def _schedule(self) -> None:
        self._k += 1
        self.clock.push(self._t0 + self._k * self.interval, self._tick)

    def _tick(self, now=None) -> None:
        if self._finalized:
            return
        # the grid instant, computed with the same float expression the
        # push used — events fire in time order, so clock.now == label
        self._sample(self._t0 + self._k * self.interval)
        self._schedule()

    def finalize(self) -> None:
        """Emit one final partial-window sample at the run's last virtual
        instant (unless a grid tick already landed exactly there), so the
        window deltas telescope to the end-of-run totals exactly."""
        if self._finalized:
            return
        if self._t0 is None:
            raise RuntimeError("sampler never started")
        self._finalized = True
        t = self.clock.now
        if t > self._prev_t:
            self._sample(t)

    # ----------------------------------------------------------- sample

    def _engine_window(self, i: int, cur: dict, dur: float) -> dict:
        """Window block for ONE engine from its snapshot delta + the
        records completed since the previous sample."""
        prev = self._prev[i]
        e = self.engines[i]
        new_recs = e.records[self._rec_idx[i]:]
        hits = _d(cur, prev, "cache.hits") + _d(cur, prev, "exact.hits")
        lookups = (_d(cur, prev, "cache.lookups")
                   + _d(cur, prev, "exact.lookups"))
        api = _d(cur, prev, "remote.calls")
        rows = _d(cur, prev, "scan.total_rows")
        judge = _d(cur, prev, "cache.judge_calls")
        stale = _d(cur, prev, "engine.stale_hits")
        w = {
            "n_done": len(new_recs),
            "rps": len(new_recs) / dur,
            "hits": int(hits),
            "lookups": int(lookups),
            "hit_rate": (hits / lookups) if lookups else None,
            "api_calls": int(api),
            "api_cost": float(_d(cur, prev, "remote.total_cost")),
            "rows_scanned": int(rows),
            "rows_per_s": rows / dur,
            "judge_calls": int(judge),
            "judge_calls_per_s": judge / dur,
            "stale_hits": int(stale),
            "stale_rate": (stale / hits) if hits else None,
            "info_accuracy": (
                float(np.mean([r.info_correct for r in new_recs]))
                if new_recs else None
            ),
        }
        w.update(_lat_stats([r.latency for r in new_recs]))
        return w

    def _merge_windows(self, wins: list[dict], dur: float,
                       all_lats: list[float]) -> dict:
        """Fleet window: sum counts (cache-derived ones were already
        deduped per owner at snapshot time — see _engine_window's caller),
        re-derive ratios, pool latencies."""
        keys = ("n_done", "hits", "lookups", "api_calls", "rows_scanned",
                "judge_calls", "stale_hits")
        agg = {k: sum(w[k] for w in wins) for k in keys}
        agg["api_cost"] = float(sum(w["api_cost"] for w in wins))
        agg["rps"] = agg["n_done"] / dur
        agg["rows_per_s"] = agg["rows_scanned"] / dur
        agg["judge_calls_per_s"] = agg["judge_calls"] / dur
        agg["hit_rate"] = (agg["hits"] / agg["lookups"]
                           if agg["lookups"] else None)
        agg["stale_rate"] = (agg["stale_hits"] / agg["hits"]
                             if agg["hits"] else None)
        accs = [w["info_accuracy"] for w in wins
                if w["info_accuracy"] is not None]
        ns = [w["n_done"] for w in wins if w["info_accuracy"] is not None]
        agg["info_accuracy"] = (
            float(sum(a * n for a, n in zip(accs, ns)) / sum(ns))
            if ns and sum(ns) else None
        )
        agg.update(_lat_stats(all_lats))
        return agg

    def _gauges(self, snaps: list[dict]) -> dict:
        """Fleet gauges from the engines' ``gauge.`` namespaces (counts
        sum; ``*_headroom`` takes the fleet min) + federation depths."""
        out: dict[str, float | int] = {}
        for snap in snaps:
            for k, v in snap.items():
                if not k.startswith("gauge."):
                    continue
                name = k[len("gauge."):]
                if name.endswith("_headroom"):
                    out[name] = min(out.get(name, v), v)
                else:
                    out[name] = out.get(name, 0) + v
        if self.federation is not None:
            for k, v in self.federation.gauges().items():
                out[f"fed_{k}"] = v
        return out

    def _sample(self, t: float) -> None:
        dur = t - self._prev_t
        snaps = [e.metrics.snapshot() for e in self.engines]
        # per-engine windows; cache-derived counters zeroed on non-owner
        # engines so the fleet sums count each distinct cache once
        wins = []
        per_region_lats: list[list[float]] = []
        for i, cur in enumerate(snaps):
            if not self._cache_owner[i] and \
                    getattr(self.engines[i], "cache", None) is not None:
                cur_dedup = {
                    k: (self._prev[i].get(k, v)
                        if k.startswith(_CACHE_NAMESPACES) else v)
                    for k, v in cur.items()
                }
            else:
                cur_dedup = cur
            wins.append(self._engine_window(i, cur_dedup, dur))
            per_region_lats.append([
                r.latency
                for r in self.engines[i].records[self._rec_idx[i]:]
            ])
        all_lats = [x for ls in per_region_lats for x in ls]
        row = {
            "t": float(t),
            "dur": float(dur),
            "window": self._merge_windows(wins, dur, all_lats),
            "gauges": self._gauges(snaps),
            "cum": self._cum(snaps),
        }
        if len(self.engines) > 1:
            regions = {}
            for i, e in enumerate(self.engines):
                g = {k[len("gauge."):]: v for k, v in snaps[i].items()
                     if k.startswith("gauge.")}
                blk = {
                    "n_done": wins[i]["n_done"],
                    "api_calls": wins[i]["api_calls"],
                    "gauges": g,
                }
                blk.update(_lat_stats(per_region_lats[i]))
                regions[str(getattr(e, "region_id", i))] = blk
            row["regions"] = regions
        self.samples.append(row)
        # advance window state
        self._prev = snaps
        self._prev_t = t
        self._rec_idx = [len(e.records) for e in self.engines]
        if self.monitor is not None:
            self.monitor.observe(row)

    def _cum(self, snaps: list[dict]) -> dict:
        """Cumulative integer totals since ``start()`` — what the window
        deltas must telescope to (the reconciliation gate)."""
        def total(key_cache: str, key_exact: str | None = None) -> int:
            tot = 0
            for i, snap in enumerate(snaps):
                if key_cache.startswith(_CACHE_NAMESPACES) \
                        and not self._cache_owner[i] \
                        and getattr(self.engines[i], "cache", None) \
                        is not None:
                    continue
                v = snap.get(key_cache, 0) - self._base[i].get(key_cache, 0)
                if key_exact is not None:
                    v += (snap.get(key_exact, 0)
                          - self._base[i].get(key_exact, 0))
                tot += int(v)
            return tot

        return {
            "n_done": int(sum(
                len(e.records) - b
                for e, b in zip(self.engines, self._base_recs)
            )),
            "hits": total("cache.hits", "exact.hits"),
            "lookups": total("cache.lookups", "exact.lookups"),
            "api_calls": total("remote.calls"),
            "rows_scanned": total("scan.total_rows"),
            "judge_calls": total("cache.judge_calls"),
            "stale_hits": total("engine.stale_hits"),
        }

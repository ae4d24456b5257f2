"""Deterministic fault injection for the virtual-time serving stack
(DESIGN.md §17).

A :class:`FaultSchedule` is a set of half-open virtual-time windows
``[start, end)``, each describing one failure mode at one blast radius:

* ``region_outage`` — the target region goes dark: its cache stops
  answering semantic peeks (the probe lands and nothing comes back;
  only a federation ``peek_timeout`` resolves the broadcast).
* ``wan_degrade`` — region links touching the target region (or all
  links when no region is given) have their RTT multiplied by ``mult``.
* ``origin_brownout`` — the remote data service's origin is degraded:
  each attempt fails with probability ``error_rate`` and is spuriously
  throttled with probability ``throttle``; retries stay bounded by
  ``max_retries`` and then the fetch terminates with
  ``FetchOutcome.failed`` instead of waiting forever.
* ``judge_slowdown`` — the judge device runs ``mult``× slower (the
  stage-2 micro-batch token cost is scaled up).

The schedule itself is pure: every method is a read-only query of
``(kind, region, t)``, so an *armed but empty* schedule is byte-identical
to no schedule at all. The only randomness faults introduce (brownout
error/throttle draws) lives in a dedicated rng owned by
``RemoteDataService`` that is never touched outside an active brownout
window — the main request/latency streams are unperturbed.

CLI spec grammar (``--faults``, repeatable)::

    kind:start:end[:key=val[,key=val...]]

    region_outage:60:120:region=1
    wan_degrade:30:90:region=1,mult=4
    origin_brownout:20:80:error_rate=0.6,throttle=0.2
    judge_slowdown:10:50:mult=3
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

KINDS = ("region_outage", "wan_degrade", "origin_brownout",
         "judge_slowdown")


@dataclasses.dataclass(frozen=True)
class FaultWindow:
    """One failure window, active over virtual time ``[start, end)``.
    ``region=None`` means every region (or every link) is affected."""
    kind: str
    start: float
    end: float
    region: Optional[int] = None
    mult: float = 1.0          # wan_degrade / judge_slowdown multiplier
    error_rate: float = 0.0    # origin_brownout: P(attempt errors)
    throttle: float = 0.0      # origin_brownout: P(attempt 429s)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not self.end > self.start:
            raise ValueError(f"empty fault window [{self.start}, {self.end})")

    def active(self, t: float) -> bool:
        return self.start <= t < self.end

    def hits(self, region: Optional[int], t: float) -> bool:
        return self.active(t) and (self.region is None or region is None
                                   or self.region == region)


class FaultSchedule:
    """Pure query interface over a list of :class:`FaultWindow`."""

    def __init__(self, windows: Iterable[FaultWindow] = ()):
        self.windows = list(windows)
        for w in self.windows:
            if not isinstance(w, FaultWindow):
                raise TypeError(f"not a FaultWindow: {w!r}")
        # per-kind buckets so on-path queries touch only relevant windows
        self._by_kind = {k: [w for w in self.windows if w.kind == k]
                         for k in KINDS}

    def region_down(self, rid: int, t: float) -> bool:
        """Is region ``rid`` dark (not answering peeks) at ``t``?"""
        return any(w.hits(rid, t) for w in self._by_kind["region_outage"])

    def link_mult(self, a: int, b: int, t: float) -> float:
        """RTT multiplier for the link a<->b at ``t`` (product of active
        degradation windows touching either endpoint)."""
        m = 1.0
        for w in self._by_kind["wan_degrade"]:
            if w.active(t) and (w.region is None
                                or w.region in (a, b)):
                m *= w.mult
        return m

    def brownout(self, region: Optional[int], t: float) -> Optional[FaultWindow]:
        """The active origin-brownout window for ``region`` at ``t``
        (None when the origin is healthy)."""
        for w in self._by_kind["origin_brownout"]:
            if w.hits(region, t):
                return w
        return None

    def judge_mult(self, region: Optional[int], t: float) -> float:
        """Judge-device slowdown multiplier for ``region`` at ``t``."""
        m = 1.0
        for w in self._by_kind["judge_slowdown"]:
            if w.hits(region, t):
                m *= w.mult
        return m

    # -- CLI spec parsing ------------------------------------------------

    @classmethod
    def parse(cls, specs: Iterable[str]) -> "FaultSchedule":
        """Parse ``kind:start:end[:k=v,...]`` spec strings (see module
        docstring for the grammar)."""
        wins = []
        for spec in specs:
            parts = spec.strip().split(":")
            if len(parts) < 3:
                raise ValueError(
                    f"fault spec {spec!r}: want kind:start:end[:k=v,...]")
            kind, start, end = parts[0], float(parts[1]), float(parts[2])
            kw: dict = {}
            if len(parts) > 3:
                for item in ":".join(parts[3:]).split(","):
                    if not item:
                        continue
                    k, _, v = item.partition("=")
                    k = k.strip()
                    if k == "region":
                        kw[k] = int(v)
                    elif k in ("mult", "error_rate", "throttle"):
                        kw[k] = float(v)
                    else:
                        raise ValueError(
                            f"fault spec {spec!r}: unknown key {k!r}")
            wins.append(FaultWindow(kind, start, end, **kw))
        return cls(wins)

    def __len__(self) -> int:
        return len(self.windows)

    def __repr__(self) -> str:
        return f"FaultSchedule({self.windows!r})"

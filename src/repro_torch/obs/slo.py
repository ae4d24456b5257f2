"""Declarative SLO monitoring over the telemetry sample stream
(DESIGN.md §16).

An :class:`SLO` names one metric inside a sample row (dotted path, e.g.
``window.latency_p99`` or ``gauges.judge_backlog``), an objective
direction, a bound, and hysteresis counts. The :class:`SLOMonitor`
consumes sample rows in virtual-time order and emits deterministic
breach / recovery alert events:

* **breach** — raised after ``breach_after`` *consecutive* violating
  samples while not currently breached;
* **recovery** — raised after ``recover_after`` consecutive OK samples
  while breached;
* samples where the metric is ``None``/missing (e.g. a windowed
  percentile over a window that completed nothing) are **skipped** —
  they advance neither counter, so an idle tail cannot fake a recovery.

Alerts are plain dicts stamped with the sample's virtual time — same
seed ⇒ byte-identical alert JSONL (see :func:`~repro_torch.obs.export.
write_alerts`) — and, when a tracer is armed, each alert also lands in
the span stream as a zero-width BACKGROUND marker (``slo_breach`` /
``slo_recovery``, tagged with the SLO name) so breaches are visible in
Perfetto next to the request spans. The monitor only ever *reads* the
sample rows: monitoring is as observationally neutral as sampling.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.trace import BACKGROUND

_OPS = ("<=", ">=")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective: ``metric op bound`` must hold per sample.

    ``op`` is the *objective*, not the violation test: ``"<="`` is an
    upper bound (violating when value > bound, e.g. p99 latency);
    ``">="`` is a floor (violating when value < bound, e.g. accuracy).
    """

    name: str
    metric: str            # dotted path into a sample row
    op: str                # "<=" (upper bound) or ">=" (floor)
    bound: float
    breach_after: int = 2  # consecutive violating samples to raise
    recover_after: int = 2  # consecutive OK samples to clear

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}, got {self.op!r}")
        if self.breach_after < 1 or self.recover_after < 1:
            raise ValueError("hysteresis counts must be >= 1")

    def violated(self, value: float) -> bool:
        return value > self.bound if self.op == "<=" else value < self.bound

    @classmethod
    def parse(cls, spec: str) -> "SLO":
        """Parse the CLI form
        ``name:metric:op:bound[:breach_after[:recover_after]]`` —
        e.g. ``p99:window.latency_p99:<=:3.0:2:2``."""
        parts = spec.split(":")
        if len(parts) < 4 or len(parts) > 6:
            raise ValueError(
                f"bad SLO spec {spec!r}; want "
                "name:metric:op:bound[:breach_after[:recover_after]]"
            )
        name, metric, op, bound = parts[:4]
        breach = int(parts[4]) if len(parts) > 4 else 2
        recover = int(parts[5]) if len(parts) > 5 else breach
        return cls(name=name, metric=metric, op=op, bound=float(bound),
                   breach_after=breach, recover_after=recover)


def _dig(row: dict, path: str):
    """Resolve a dotted path inside a sample row (None when absent)."""
    cur = row
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


@dataclasses.dataclass
class _SLOState:
    breached: bool = False
    bad: int = 0   # consecutive violating samples
    ok: int = 0    # consecutive OK samples


class SLOMonitor:
    """Evaluate a set of SLOs against the sample stream.

    Feed every sample (in order) to :meth:`observe` — a
    :class:`~repro_torch.obs.sampler.TimeSeriesSampler` built with
    ``monitor=`` does this automatically. Alerts accumulate on
    ``self.alerts`` in emission order (deterministic: sample order ×
    declaration order).
    """

    def __init__(self, slos, tracer=None, region: int = 0):
        self.slos = [SLO.parse(s) if isinstance(s, str) else s
                     for s in slos]
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.tracer = tracer
        self.region = region
        self.alerts: list[dict] = []
        self._state = {s.name: _SLOState() for s in self.slos}

    def observe(self, sample: dict) -> None:
        t = sample["t"]
        for slo in self.slos:
            value = _dig(sample, slo.metric)
            if value is None:
                continue  # no data: advances neither counter
            st = self._state[slo.name]
            if slo.violated(value):
                st.bad += 1
                st.ok = 0
            else:
                st.ok += 1
                st.bad = 0
            if not st.breached and st.bad >= slo.breach_after:
                st.breached = True
                self._alert(t, slo, "breach", value)
            elif st.breached and st.ok >= slo.recover_after:
                st.breached = False
                self._alert(t, slo, "recovery", value)

    def _alert(self, t: float, slo: SLO, event: str, value) -> None:
        self.alerts.append({
            "t": float(t),
            "event": event,
            "slo": slo.name,
            "metric": slo.metric,
            "op": slo.op,
            "bound": slo.bound,
            "value": float(value),
        })
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.marker(BACKGROUND, f"slo_{event}", t,
                               self.region, tag=slo.name)

    # ------------------------------------------------------------ stats

    @property
    def breaches(self) -> int:
        return sum(1 for a in self.alerts if a["event"] == "breach")

    @property
    def recoveries(self) -> int:
        return sum(1 for a in self.alerts if a["event"] == "recovery")

    def active(self) -> list[str]:
        """Names of SLOs currently in breach."""
        return [n for n, st in self._state.items() if st.breached]

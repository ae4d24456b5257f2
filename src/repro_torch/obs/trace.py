"""Request-lifecycle tracing in virtual time (DESIGN.md §15).

A :class:`Tracer` records *spans*: half-open ``[t0, t1)`` segments of
virtual time attributed to one request (``rid >= 0``) or to background
work (``rid == BACKGROUND``). Spans are emitted by the serving layers at
the instants they already know exactly — the engine's stage-1 flush, the
judge dispatcher, the federation router's response handler, the
freshness manager's refetch — so tracing never pushes clock events, never
draws randomness, and a traced run is bit-identical in virtual time to an
untraced one.

Span taxonomy (request-scoped unless noted):

  ``agent_think`` / ``agent_answer``  accelerator lane time for a think
                                      round / the final answer
  ``stage1_queue_wait``   tool-call arrival -> its stage-1 pass opening
                          (host busy-wait serialization, §12)
  ``stage1_scan``         the pass itself: fixed host cost + RTT to a
                          non-local cache + per-row scan streaming
  ``warm_consult``        extra WARM-tier access latency (§10)
  ``band_bypass``         zero-duration marker: hit served without judge
                          latency (admission-band trust, §14)
  ``judge_queue_wait``    stage-1 resolve -> judge micro-batch submit
                          (the backlog + admission-guardrail wait)
  ``judge_compute``       micro-batch submit -> completion on the judge
                          lane (lane queueing + processor sharing)
  ``peek_rtt``            federation broadcast -> winning response (or
                          the last NAK) (§9)
  ``lease_transfer``      winning response -> transferred value arrival
  ``origin_fetch``        origin WAN fetch incl. rate-limiter wait
  ``refresh``             background: revalidation fetch in flight (§11)
  ``invalidation_drop``   background marker: entry dropped by a
                          change-feed notice (§11)
  ``lease_validate``      background marker: holder-side judge score on
                          an in-band federation lease (§14)

**Conservation law**: for every completed request, its request-scoped
spans — sorted by start time — tile ``[rec.arrival, rec.t_done]``
exactly: the first span starts at the arrival instant, every span ends
where the next begins (float ``==``, no tolerance), and the last ends at
completion. The telescoped sum of the segments is therefore *exactly*
``rec.latency``. :func:`repro_torch.obs.analyze.check_conservation` verifies
this per request; a gap or overlap names the offending boundary.

The disabled path is a zero-allocation no-op: :data:`NULL_TRACER` is a
singleton whose ``span`` is an empty method, and every instrumentation
site either calls it directly (cold paths) or guards a loop with
``tracer.enabled`` (the per-batch hot paths), so an untraced engine does
no per-span work at all.
"""
from __future__ import annotations

from typing import Optional

# rid used for spans that belong to no request (refresh-ahead fetches,
# invalidation drops, holder-side lease validation)
BACKGROUND = -1

# tuple field offsets of one span record (plain tuples: the enabled-path
# cost is one append, nothing else)
RID, NAME, T0, T1, REGION, TAG = range(6)


class Tracer:
    """Span sink shared by every layer of one run (one per engine, or one
    per federation — spans carry the region id either way)."""

    enabled = True
    __slots__ = ("spans",)

    def __init__(self):
        # (rid, name, t0, t1, region, tag) in emission order — which is
        # deterministic (clock event order), making the exported JSONL
        # byte-identical across same-seed runs
        self.spans: list[tuple] = []

    def span(self, rid: int, name: str, t0: float, t1: float,
             region: int = 0, tag: Optional[str] = None) -> None:
        self.spans.append((rid, name, t0, t1, region, tag))

    def marker(self, rid: int, name: str, t: float, region: int = 0,
               tag: Optional[str] = None) -> None:
        """Zero-duration span: an event worth seeing on the timeline that
        consumes no virtual time (band bypass, invalidation drop)."""
        self.spans.append((rid, name, t, t, region, tag))

    def request_spans(self) -> dict[tuple[int, int], list[tuple]]:
        """Request-scoped spans grouped by ``(region, rid)`` — the pair is
        the unique request key under federation, where per-region
        workloads reuse rid ranges."""
        out: dict[tuple[int, int], list[tuple]] = {}
        for s in self.spans:
            if s[RID] >= 0:
                out.setdefault((s[REGION], s[RID]), []).append(s)
        return out


class NullTracer:
    """Disabled tracer: every method is a no-op, no state, no allocation.
    The singleton :data:`NULL_TRACER` is the default everywhere a tracer
    can be threaded."""

    enabled = False
    __slots__ = ()

    def span(self, rid, name, t0, t1, region=0, tag=None) -> None:
        return None

    def marker(self, rid, name, t, region=0, tag=None) -> None:
        return None


NULL_TRACER = NullTracer()

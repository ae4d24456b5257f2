"""Critical-path decomposition + latency attribution (DESIGN.md §15).

:func:`check_conservation` proves the conservation law for a finished
run: every completed request's request-scoped spans — sorted by start
time — tile ``[rec.arrival, rec.t_done]`` with NO gap and NO overlap,
every boundary compared with exact float ``==``. Because the segments
tile the interval exactly, their summed duration telescopes:
``sum(t1_i - t0_i) = t_last - t_first = rec.t_done - rec.arrival``,
which is *bit-for-bit* the expression the engine used to compute
``rec.latency`` — so the spans sum exactly (``==``, not ``≈``) to the
recorded latency. (Summing the float durations naively would NOT
telescope exactly — float addition is not associative — which is why
the law is stated, and checked, as exact tiling.)

:func:`attribution` then answers *where the time went*: per-segment
p50/p99 (shared :func:`~repro_torch.obs.metrics.percentile`) split by request
class — pure cache hits (``remote_calls == 0``), federated
(``peer_transfers > 0``), and origin misses — the trace-derived
replacement for the engine's hand-rolled ``hitpath_*`` means.
"""
from __future__ import annotations

from typing import Iterable, Mapping

from repro_torch.obs.metrics import percentile
from repro_torch.obs.trace import T0, T1, Tracer


def _records_by_key(records) -> dict[tuple[int, int], object]:
    """Normalize records to ``{(region, rid): rec}``. Accepts a plain
    list (solo engine ⇒ region 0) or a ``{region: [recs]}`` mapping
    (federation — per-region workloads reuse rid ranges, so rid alone
    is not a key)."""
    if isinstance(records, Mapping):
        return {
            (int(region), r.rid): r
            for region, recs in records.items() for r in recs
        }
    return {(0, r.rid): r for r in records}


def check_conservation(tracer: Tracer, records) -> list[str]:
    """Return a list of violations (empty ⇒ the law holds).

    Checked per completed request, all comparisons exact float ``==``:

    1. the request has spans at all;
    2. the first span starts at ``rec.arrival``;
    3. each span ends exactly where the next begins (zero-duration
       markers tile trivially);
    4. the last span ends at ``rec.t_done``;
    5. the telescoped total ``t_last - t_first`` equals ``rec.latency``.
    """
    by_req = tracer.request_spans()
    violations: list[str] = []
    for key, rec in _records_by_key(records).items():
        spans = by_req.get(key)
        tag = f"region {key[0]} rid {key[1]}"
        if not spans:
            violations.append(f"{tag}: no spans recorded")
            continue
        spans = sorted(spans, key=lambda s: (s[T0], s[T1]))
        if spans[0][T0] != rec.arrival:
            violations.append(
                f"{tag}: first span {spans[0][1]} starts at "
                f"{spans[0][T0]!r} != arrival {rec.arrival!r}"
            )
        for a, b in zip(spans, spans[1:]):
            if a[T1] != b[T0]:
                kind = "gap" if a[T1] < b[T0] else "overlap"
                violations.append(
                    f"{tag}: {kind} between {a[1]} (ends {a[T1]!r}) and "
                    f"{b[1]} (starts {b[T0]!r})"
                )
        if spans[-1][T1] != rec.t_done:
            violations.append(
                f"{tag}: last span {spans[-1][1]} ends at "
                f"{spans[-1][T1]!r} != t_done {rec.t_done!r}"
            )
        if spans[-1][T1] - spans[0][T0] != rec.latency:
            violations.append(
                f"{tag}: telescoped span total "
                f"{spans[-1][T1] - spans[0][T0]!r} != latency "
                f"{rec.latency!r}"
            )
    return violations


def _req_class(rec) -> str:
    if rec.remote_calls == 0:
        return "hit"
    if rec.peer_transfers > 0:
        return "federated"
    return "miss"


def attribution(tracer: Tracer, records) -> dict:
    """Queueing-delay attribution: per request class, per span name,
    the count / total seconds / p50 / p99 of **per-request time in that
    segment** (a request's multiple rounds of, say, ``judge_queue_wait``
    are summed before the quantile — the unit of the paper's Fig 11 is
    the request, not the span)."""
    by_req = tracer.request_spans()
    recs = _records_by_key(records)
    # class -> name -> list of per-request summed durations
    acc: dict[str, dict[str, list[float]]] = {}
    lat: dict[str, list[float]] = {}
    for key, rec in recs.items():
        cls = _req_class(rec)
        lat.setdefault(cls, []).append(rec.latency)
        per_name: dict[str, float] = {}
        for s in by_req.get(key, ()):
            per_name[s[1]] = per_name.get(s[1], 0.0) + (s[T1] - s[T0])
        slot = acc.setdefault(cls, {})
        for name, d in per_name.items():
            slot.setdefault(name, []).append(d)
    out: dict[str, dict] = {}
    for cls in sorted(acc):
        segs = {}
        for name in sorted(acc[cls]):
            ds = acc[cls][name]
            segs[name] = {
                "n": len(ds),
                "total_s": float(sum(ds)),
                "p50": percentile(ds, 50),
                "p99": percentile(ds, 99),
            }
        out[cls] = {
            "n_requests": len(lat[cls]),
            "latency_p50": percentile(lat[cls], 50),
            "latency_p99": percentile(lat[cls], 99),
            "segments": segs,
        }
    return out


def critical_path(tracer: Tracer, records) -> dict:
    """Per-request-class critical-path aggregates (DESIGN.md §16).

    The conservation law makes the critical path trivial to extract:
    each request's spans *tile* ``[arrival, t_done]``, so every span IS
    on the critical path — the per-class question is not *which* spans
    matter but *where a millisecond of improvement lands*. For each
    class and segment name this reports:

    * ``n_requests`` / ``occurrences`` — requests containing the
      segment, and total span count (a request can pass a segment
      several times across rounds);
    * ``total_s`` and ``frac`` — summed seconds and share of the
      class's total latency;
    * ``leverage`` — occurrences / class requests: shaving 1 ms off
      every pass through this segment cuts the class's *mean* latency
      by ``leverage`` ms. The per-class ``ranked`` list orders segment
      names by ``total_s`` (descending, name-tiebroken) — the answer to
      "optimize what first".
    """
    by_req = tracer.request_spans()
    recs = _records_by_key(records)
    # class -> name -> [occurrences, total_s, n_requests]
    acc: dict[str, dict[str, list]] = {}
    cls_lat: dict[str, float] = {}
    cls_n: dict[str, int] = {}
    for key, rec in recs.items():
        cls = _req_class(rec)
        cls_lat[cls] = cls_lat.get(cls, 0.0) + rec.latency
        cls_n[cls] = cls_n.get(cls, 0) + 1
        seen: set[str] = set()
        slot = acc.setdefault(cls, {})
        for s in by_req.get(key, ()):
            cell = slot.setdefault(s[1], [0, 0.0, 0])
            cell[0] += 1
            cell[1] += s[T1] - s[T0]
            if s[1] not in seen:
                seen.add(s[1])
                cell[2] += 1
    out: dict[str, dict] = {}
    for cls in sorted(acc):
        total = cls_lat[cls]
        n_req = cls_n[cls]
        segs = {}
        for name in sorted(acc[cls]):
            occ, tot_s, nr = acc[cls][name]
            segs[name] = {
                "n_requests": nr,
                "occurrences": occ,
                "total_s": float(tot_s),
                "frac": float(tot_s / total) if total else 0.0,
                "leverage": float(occ / n_req),
            }
        ranked = sorted(segs, key=lambda n: (-segs[n]["total_s"], n))
        out[cls] = {
            "n_requests": n_req,
            "total_latency_s": float(total),
            "segments": segs,
            "ranked": ranked,
        }
    return out


def flamegraph_folded(tracer: Tracer, records) -> list[str]:
    """Span-duration aggregates as folded-stack lines —
    ``class;segment <microseconds>`` — the input format of the standard
    flamegraph toolchain (one frame deep: the conservation law makes
    request span trees linear, so class;segment is the whole stack).
    Lines are sorted, weights are integer µs: deterministic output."""
    report = critical_path(tracer, records)
    lines = []
    for cls, blk in report.items():
        for name, seg in blk["segments"].items():
            lines.append(f"{cls};{name} {int(round(seg['total_s'] * 1e6))}")
    return sorted(lines)


def format_critical_path(report: Mapping) -> str:
    """Human-readable critical-path table (one block per class, segments
    in ranked order)."""
    lines = []
    for cls, blk in report.items():
        lines.append(
            f"[{cls}] n={blk['n_requests']} "
            f"total={blk['total_latency_s']:.3f}s"
        )
        lines.append(f"  {'segment':<18}{'occ':>6}{'total_s':>10}"
                     f"{'frac':>7}{'lev':>6}")
        for name in blk["ranked"]:
            seg = blk["segments"][name]
            lines.append(
                f"  {name:<18}{seg['occurrences']:>6}"
                f"{seg['total_s']:>10.3f}{seg['frac']:>7.1%}"
                f"{seg['leverage']:>6.2f}"
            )
    return "\n".join(lines)


def format_attribution(report: Mapping) -> str:
    """Human-readable attribution table (one block per request class)."""
    lines = []
    for cls, blk in report.items():
        lines.append(
            f"[{cls}] n={blk['n_requests']} "
            f"latency p50={blk['latency_p50']:.4f}s "
            f"p99={blk['latency_p99']:.4f}s"
        )
        lines.append(f"  {'segment':<18}{'n':>6}{'total_s':>10}"
                     f"{'p50':>9}{'p99':>9}")
        for name, seg in blk["segments"].items():
            lines.append(
                f"  {name:<18}{seg['n']:>6}{seg['total_s']:>10.3f}"
                f"{seg['p50']:>9.4f}{seg['p99']:>9.4f}"
            )
    return "\n".join(lines)

"""Trace export: JSONL + Chrome trace-event JSON (DESIGN.md §15).

Both writers are byte-deterministic: spans are written in the tracer's
emission order (which is clock-event order, itself deterministic),
every ``json.dumps`` pins ``sort_keys=True`` and compact separators,
and floats serialize via Python's ``repr`` (shortest round-trip form) —
so same seed ⇒ byte-identical files, and a trace diff IS a regression
signal.

The Chrome file loads directly in Perfetto (https://ui.perfetto.dev →
"Open trace file") or ``chrome://tracing``: one process row per region,
one thread row per request id, complete events (``ph: "X"``) with
microsecond timestamps.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.trace import BACKGROUND, Tracer


def write_jsonl(tracer: Tracer, path: str) -> str:
    """One span per line: ``{"rid", "name", "t0", "t1", "dur", "region",
    "tag"}`` (tag omitted when absent)."""
    with open(path, "w") as f:
        for rid, name, t0, t1, region, tag in tracer.spans:
            row = {
                "rid": rid, "name": name, "t0": t0, "t1": t1,
                "dur": t1 - t0, "region": region,
            }
            if tag is not None:
                row["tag"] = tag
            f.write(json.dumps(row, sort_keys=True,
                               separators=(",", ":")) + "\n")
    return path


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    """Chrome trace-event JSON array: ``pid`` = region, ``tid`` = rid
    (background spans land on a dedicated ``tid``), times in µs."""
    events = []
    for rid, name, t0, t1, region, tag in tracer.spans:
        ev = {
            "name": name,
            "ph": "X",
            "ts": t0 * 1e6,
            "dur": (t1 - t0) * 1e6,
            "pid": region,
            "tid": rid if rid != BACKGROUND else 999999,
            "args": {} if tag is None else {"tag": tag},
        }
        events.append(ev)
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": f"region {pid}"}}
        for pid in sorted({s[4] for s in tracer.spans})
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events,
                   "displayTimeUnit": "ms"},
                  f, sort_keys=True, separators=(",", ":"))
    return path


def _canon_dumps(obj) -> str:
    """The repo's canonical JSON form: sorted keys, compact separators,
    floats via ``repr`` — same seed ⇒ byte-identical artifact."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def write_timeseries(samples: list[dict], path: str) -> str:
    """One telemetry sample per line (DESIGN.md §16), in emission order
    (= virtual-time order). Rows come straight from
    :class:`~repro_torch.obs.sampler.TimeSeriesSampler.samples` — pure-Python
    scalars only, so serialization is byte-deterministic."""
    with open(path, "w") as f:
        for row in samples:
            f.write(_canon_dumps(row) + "\n")
    return path


def write_alerts(alerts: list[dict], path: str) -> str:
    """One SLO breach/recovery alert per line, in emission order (the
    :class:`~repro_torch.obs.slo.SLOMonitor`'s deterministic sample-order ×
    declaration-order). An empty alert list writes an empty file — the
    steady-baseline gate byte-compares against exactly that."""
    with open(path, "w") as f:
        for a in alerts:
            f.write(_canon_dumps(a) + "\n")
    return path


def export_timeseries(sampler, monitor, prefix: str) -> dict[str, str]:
    """Write ``<prefix>.timeseries.jsonl`` (always) and
    ``<prefix>.alerts.jsonl`` (when a monitor ran, even if it raised
    nothing)."""
    out = {"timeseries": write_timeseries(sampler.samples,
                                          prefix + ".timeseries.jsonl")}
    if monitor is not None:
        out["alerts"] = write_alerts(monitor.alerts,
                                     prefix + ".alerts.jsonl")
    return out


def export_trace(tracer: Tracer, prefix: str) -> dict[str, str]:
    """Write both formats next to each other:
    ``<prefix>.jsonl`` + ``<prefix>.chrome.json``."""
    return {
        "jsonl": write_jsonl(tracer, prefix + ".jsonl"),
        "chrome": write_chrome_trace(tracer, prefix + ".chrome.json"),
    }

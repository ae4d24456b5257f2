"""The port's continuous telemetry (``repro_torch.obs.{sampler,slo,
analyze}``) held to the reference's (``tests/test_telemetry.py``): the
sampler's neutrality over the engine matrix and the three federation
topologies, window deltas that telescope to the summary, the virtual-time
grid, byte-identical time series and alerts, SLO hysteresis, the
critical path and the registry/histogram modes. Every sampled summary,
time series and alert file equals the reference's byte for byte, on the
port's numpy backend and on its kernel backend on the CPU."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.data.workloads import region_workloads as ref_region_workloads
from repro.data.world import SemanticWorld as RefWorld
from repro.launch.serve import run_once as ref_run_once
from repro.serving.federation import FederationRunner as RefRunner
from repro_torch.data.workloads import region_workloads
from repro_torch.data.world import SemanticWorld
from repro_torch.launch.serve import run_once
from repro_torch.obs.analyze import (critical_path, flamegraph_folded,
                                     format_critical_path)
from repro_torch.obs.metrics import FixedHistogram, MetricsRegistry
from repro_torch.obs.slo import SLO, SLOMonitor
from repro_torch.obs.trace import BACKGROUND, Tracer
from repro_torch.serving.federation import FederationRunner

torch.set_num_threads(1)

BACKENDS = ("numpy", "kernel")
TELE_KEYS = ("timeseries_samples", "slo_breaches", "slo_recoveries",
             "timeseries_path", "alerts_path")
PATHS = ("timeseries_path", "alerts_path")


def _canon(s: dict) -> str:
    return json.dumps(s, sort_keys=True, default=float)


def _strip(s: dict) -> dict:
    return {k: v for k, v in s.items() if k not in TELE_KEYS}


def _both(backend, **kw) -> dict:
    """The port's summary on ``backend``, checked equal to the
    reference's byte for byte."""
    got = run_once(backend=backend, device="cpu", **kw)
    assert _canon(got) == _canon(ref_run_once(**kw))
    return got


# ------------------------------------------------------------ neutrality

MATRIX = {
    "closed_loop": dict(concurrency=4),
    "open_loop": dict(concurrency=None),
    "tiered_longtail": dict(workload="longtail", tail_len=30,
                            warm_frac=0.5, concurrency=4),
    "churn_refresh": dict(churn_period=30.0, invalidation=True,
                          refresh_ahead=True, concurrency=4),
    "ivf_sharded": dict(cluster=True, n_clusters=16, nprobe=4, shards=2,
                        t_shard_merge=1e-4, t_cache_per_row=1e-6,
                        concurrency=4),
    "judge_band": dict(judge_band=0.1, concurrency=4),
    "exact": dict(mode="exact", concurrency=4),
    "nojudge": dict(mode="cortex-nojudge", concurrency=4),
    "vanilla": dict(mode="vanilla", concurrency=4),
}
_BASE = dict(n_requests=60, n_intents=150, dim=32, seed=5)


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_sampler_is_observationally_neutral(name):
    """Both backends: the sampled summary equals the reference's sampled
    summary, and with the telemetry keys stripped the unsampled one."""
    kw = {**_BASE, **MATRIX[name]}
    plain = _both("numpy", **kw)
    for backend in BACKENDS:
        sampled = _both(backend, sample_interval=2.0,
                        slo=["p99:window.latency_p99:<=:1e9"], **kw)
        assert sampled["timeseries_samples"] > 0
        assert _canon(_strip(sampled)) == _canon(plain)


def _fed(world_cls, workloads, runner_cls, topology, **extra):
    world = world_cls(n_intents=200, dim=32, seed=5)
    reqs = workloads(world, n_regions=3, n_per_region=40, seed=6)
    return runner_cls(world=world, region_requests=reqs, topology=topology,
                      seed=7, **extra)


@pytest.mark.parametrize("topology", ["local", "peered", "global"])
def test_federation_sampler_is_neutral(topology):
    slos = dict(sample_interval=5.0, slos=["p99:window.latency_p99:<=:1e9"])
    ref = _fed(RefWorld, ref_region_workloads, RefRunner, topology, **slos)
    want = _canon(ref.run())
    plain = None
    for backend in BACKENDS:
        port = dict(backend=backend, device="cpu")
        fr = _fed(SemanticWorld, region_workloads, FederationRunner,
                  topology, **slos, **port)
        sampled = fr.run()
        assert _canon(sampled) == want
        assert fr.sampler.samples == ref.sampler.samples
        assert sampled["aggregate"]["timeseries_samples"] > 0
        sampled["aggregate"] = _strip(sampled["aggregate"])
        if plain is None:
            plain = _fed(SemanticWorld, region_workloads, FederationRunner,
                         topology, **port).run()
        assert _canon(sampled) == _canon(plain)
        row = fr.sampler.samples[-1]
        assert set(row["regions"]) == {"0", "1", "2"}
        assert "fed_inflight_peeks" in row["gauges"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_federation_summary_attributes_p99_by_region(backend):
    from repro_torch.obs.metrics import percentile

    fr = _fed(SemanticWorld, region_workloads, FederationRunner, "local",
              backend=backend, device="cpu")
    s = fr.run()
    by_region = s["aggregate"]["latency_p99_by_region"]
    assert len(by_region) == 3
    for rid, rrecs in fr.records_by_region().items():
        name = fr.regions[rid].cfg.name
        assert by_region[name] == percentile(
            [r.latency for r in rrecs], 99)
    ref = _fed(RefWorld, ref_region_workloads, RefRunner, "local").run()
    assert _canon(s) == _canon(ref)


# ----------------------------------------------- reconciliation, timing

@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """``series(backend)``: the sampled run with an SLO at _BASE, on the
    reference ("ref") or a port backend, each once: (summary without its
    paths, time-series rows, the two files' bytes)."""
    d = tmp_path_factory.mktemp("series")
    kw = dict(sample_interval=2.0, slo=["p99:window.latency_p99:<=:0.5"],
              **_BASE)
    memo = {}

    def get(side):
        if side not in memo:
            prefix = str(d / side)
            if side == "ref":
                s = ref_run_once(timeseries=prefix, **kw)
            else:
                s = run_once(timeseries=prefix, backend=side, device="cpu",
                             **kw)
            files = tuple(open(s.pop(p), "rb").read() for p in PATHS)
            rows = [json.loads(line) for line in
                    files[0].decode().splitlines()]
            memo[side] = (s, rows, files)
        return memo[side]
    return get


@pytest.mark.parametrize("backend", BACKENDS)
def test_window_deltas_telescope_to_summary_totals(backend, series):
    s, rows, _ = series(backend)
    cum = rows[-1]["cum"]
    for key, total in cum.items():
        assert sum(r["window"].get(key, 0) or 0 for r in rows) == total, key
    assert cum["n_done"] == s["n"]
    assert cum["api_calls"] == s["api_calls"]
    assert cum["judge_calls"] == s["judge_calls"]
    assert cum["rows_scanned"] == s["rows_scanned"]
    assert cum["stale_hits"] == s["stale_hits"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_samples_land_on_the_virtual_time_grid(backend, series):
    interval = 2.0
    _, rows, _ = series(backend)
    for k, r in enumerate(rows[:-1]):
        assert r["t"] == (k + 1) * interval
    assert rows[0]["dur"] == rows[0]["t"]
    for a, b in zip(rows, rows[1:]):
        assert b["dur"] == b["t"] - a["t"]
    assert "inflight" in rows[0]["gauges"]
    assert "limiter_headroom" in rows[0]["gauges"]
    assert "agent_active" in rows[0]["gauges"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_seed_artifacts_are_byte_identical(backend, series, tmp_path):
    s, _, files = series(backend)
    b = run_once(timeseries=str(tmp_path / "b"), backend=backend,
                 device="cpu", sample_interval=2.0,
                 slo=["p99:window.latency_p99:<=:0.5"], **_BASE)
    assert (tmp_path / "b.timeseries.jsonl").read_bytes() == files[0]
    assert (tmp_path / "b.alerts.jsonl").read_bytes() == files[1]
    assert s["timeseries_samples"] == b["timeseries_samples"] > 0
    ref, _, ref_files = series("ref")
    assert files == ref_files and _canon(s) == _canon(ref)


def test_slo_without_interval_is_rejected():
    with pytest.raises(ValueError):
        run_once(slo=["p99:window.latency_p99:<=:1.0"], backend="kernel",
                 device="cpu", **_BASE)
    with pytest.raises(ValueError):
        run_once(timeseries="nope", backend="kernel", device="cpu", **_BASE)


# ------------------------------------------------------------ hysteresis

def _sample(t, value):
    return {"t": float(t), "window": {"m": value}}


def test_slo_spec_parsing():
    s = SLO.parse("p99:window.latency_p99:<=:3.0")
    assert (s.name, s.metric, s.op, s.bound) \
        == ("p99", "window.latency_p99", "<=", 3.0)
    assert s.breach_after == s.recover_after == 2
    s = SLO.parse("acc:window.info_accuracy:>=:0.9:3:1")
    assert (s.breach_after, s.recover_after) == (3, 1)
    with pytest.raises(ValueError):
        SLO.parse("bad:only:three")
    with pytest.raises(ValueError):
        SLO(name="x", metric="m", op="<", bound=1.0)
    with pytest.raises(ValueError):
        SLO(name="x", metric="m", op="<=", bound=1.0, breach_after=0)


def test_hysteresis_breach_recovery_ordering():
    mon = SLOMonitor([SLO("lat", "window.m", "<=", 1.0,
                          breach_after=2, recover_after=2)])
    vals = [0.5, 2.0, 0.5, 2.0, 2.0, 0.5, 2.0, 0.5, 0.5, 2.0, 2.0]
    for t, v in enumerate(vals):
        mon.observe(_sample(t, v))
    assert [(a["t"], a["event"]) for a in mon.alerts] \
        == [(4.0, "breach"), (8.0, "recovery"), (10.0, "breach")]
    assert mon.breaches == 2 and mon.recoveries == 1
    assert mon.active() == ["lat"]


def test_hysteresis_skips_none_samples():
    mon = SLOMonitor([SLO("lat", "window.m", "<=", 1.0)])
    for t, v in enumerate([2.0, None, 2.0]):
        mon.observe(_sample(t, v))
    assert [(a["t"], a["event"]) for a in mon.alerts] == [(2.0, "breach")]
    for t in range(3, 10):
        mon.observe(_sample(t, None))
    assert mon.recoveries == 0 and mon.active() == ["lat"]


def test_floor_objective_and_breach_after_one():
    mon = SLOMonitor([SLO("acc", "window.m", ">=", 0.9,
                          breach_after=1, recover_after=1)])
    for t, v in enumerate([0.95, 0.5, 0.95]):
        mon.observe(_sample(t, v))
    assert [(a["t"], a["event"]) for a in mon.alerts] \
        == [(1.0, "breach"), (2.0, "recovery")]


def test_monitor_emits_trace_markers():
    tr = Tracer()
    mon = SLOMonitor([SLO("lat", "window.m", "<=", 1.0,
                          breach_after=1, recover_after=1)],
                     tracer=tr, region=2)
    mon.observe(_sample(1, 5.0))
    mon.observe(_sample(2, 0.5))
    names = [(s[0], s[1], s[4], s[5]) for s in tr.spans]
    assert (BACKGROUND, "slo_breach", 2, "lat") in names
    assert (BACKGROUND, "slo_recovery", 2, "lat") in names


def test_duplicate_slo_names_rejected():
    with pytest.raises(ValueError):
        SLOMonitor(["a:m:<=:1", "a:n:<=:2"])


# --------------------------------------------------------- critical path

class _Rec:
    def __init__(self, rid, arrival, t_done, remote_calls, peer_transfers=0):
        self.rid, self.arrival, self.t_done = rid, arrival, t_done
        self.latency = t_done - arrival
        self.remote_calls = remote_calls
        self.peer_transfers = peer_transfers


def test_critical_path_folds_span_trees():
    tr = Tracer()
    tr.span(0, "queue", 0.0, 1.0)
    tr.span(0, "cache", 1.0, 3.0)
    tr.span(1, "queue", 10.0, 11.0)
    tr.span(1, "remote", 11.0, 14.0)
    tr.span(1, "remote", 14.0, 15.0)
    recs = [_Rec(0, 0.0, 3.0, 0), _Rec(1, 10.0, 15.0, 2)]
    rep = critical_path(tr, recs)
    assert set(rep) == {"hit", "miss"}
    hit, miss = rep["hit"], rep["miss"]
    assert hit["n_requests"] == 1 and hit["total_latency_s"] == 3.0
    assert hit["segments"]["cache"]["frac"] == pytest.approx(2 / 3)
    assert hit["ranked"] == ["cache", "queue"]
    seg = miss["segments"]["remote"]
    assert (seg["occurrences"], seg["n_requests"]) == (2, 1)
    assert seg["leverage"] == 2.0
    assert seg["total_s"] == 4.0
    assert miss["ranked"][0] == "remote"
    for blk in rep.values():
        assert sum(s["total_s"] for s in blk["segments"].values()) \
            == pytest.approx(blk["total_latency_s"])
    assert flamegraph_folded(tr, recs) == sorted(
        ["hit;queue 1000000", "hit;cache 2000000", "miss;queue 1000000",
         "miss;remote 4000000"])
    txt = format_critical_path(rep)
    assert "[miss]" in txt and "remote" in txt


@pytest.mark.parametrize("backend", BACKENDS)
def test_critical_path_on_a_real_traced_run(backend, tmp_path):
    kw = dict(n_requests=80, concurrency=4, judge_band=0.1, seed=3)
    run_once(trace=str(tmp_path / "t"), backend=backend, device="cpu", **kw)
    ref_run_once(trace=str(tmp_path / "r"), **kw)
    jsonl = (tmp_path / "t.jsonl").read_bytes()
    assert jsonl == (tmp_path / "r.jsonl").read_bytes()
    tr = Tracer()
    for r in (json.loads(line) for line in jsonl.decode().splitlines()):
        tr.span(r["rid"], r["name"], r["t0"], r["t1"],
                region=r["region"], tag=r.get("tag"))
    recs = []
    for (region, rid), spans in tr.request_spans().items():
        if rid < 0:
            continue
        spans = sorted(spans, key=lambda s: s[2])
        names = [s[1] for s in spans]
        recs.append(_Rec(rid, spans[0][2], spans[-1][3],
                         sum(n == "origin_fetch" for n in names)))
    rep = critical_path(tr, recs)
    assert rep
    for blk in rep.values():
        total = sum(s["total_s"] for s in blk["segments"].values())
        assert total == pytest.approx(blk["total_latency_s"])
        assert abs(sum(s["frac"] for s in blk["segments"].values()) - 1.0) \
            < 1e-9
    assert len(flamegraph_folded(tr, recs)) \
        == sum(len(b["segments"]) for b in rep.values())


# ------------------------------------------- registry / histogram modes

def test_registry_register_is_idempotent_and_unregisterable():
    reg = MetricsRegistry()
    reg.register("a", lambda: {"x": 1})
    reg.register("b", lambda: {"y": 2})
    reg.register("a", lambda: {"x": 10})
    snap = reg.snapshot()
    assert snap["a.x"] == 10 and snap["b.y"] == 2
    assert list(snap) == ["a.x", "b.y"]
    assert reg.unregister("b") is True
    assert reg.unregister("b") is False
    assert "b.y" not in reg.snapshot()


def test_histogram_raw_mode_is_bit_exact_legacy():
    h_old = FixedHistogram([1.0, 2.0])
    h_new = FixedHistogram([1.0, 2.0], max_samples=None)
    vals = np.random.default_rng(0).exponential(1.0, 500)
    for v in vals:
        h_old.add(float(v))
        h_new.add(float(v))
    assert h_new.to_dict() == h_old.to_dict()
    assert h_new.mean == float(np.mean(vals))
    assert len(h_new) == 500


def test_histogram_reservoir_mode_bounds_memory_exactly():
    h = FixedHistogram([1.0, 2.0], max_samples=64, seed=7)
    vals = [float(v) for v in
            np.random.default_rng(1).exponential(1.0, 1000)]
    for v in vals:
        h.add(v)
    assert len(h.values) == 64
    assert len(h) == 1000
    assert set(h.values) <= set(vals)
    d = h.to_dict()
    assert d["0-1"] == sum(v < 1.0 for v in vals)
    assert d["1-2"] == sum(1.0 <= v < 2.0 for v in vals)
    assert d["2+"] == sum(v >= 2.0 for v in vals)
    assert h.mean == pytest.approx(sum(vals) / len(vals))
    h2 = FixedHistogram([1.0, 2.0], max_samples=64, seed=7)
    for v in vals:
        h2.add(v)
    assert h2.values == h.values


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_reservoir_mode_preserves_behavior(backend):
    kw = dict(churn_period=30.0, invalidation=True, **_BASE)
    full = _both(backend, **kw)
    capped = _both(backend, stale_age_reservoir=8, **kw)
    assert capped["stale_age_mean"] \
        == pytest.approx(full["stale_age_mean"])
    a = {k: v for k, v in capped.items() if k != "stale_age_mean"}
    b = {k: v for k, v in full.items() if k != "stale_age_mean"}
    assert _canon(a) == _canon(b)

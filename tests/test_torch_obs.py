"""The port's observability layer (``repro_torch.obs``) held to the
reference's (``tests/test_obs.py``): metrics registry, tracer, span
conservation, export and attribution. Traced runs give the reference's
summary, span JSONL and Chrome trace byte for byte (plain, tiered with
the admission band, and a three-region federation), on the port's numpy
backend and on its kernel backend on the CPU."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.data.workloads import region_workloads as ref_region_workloads
from repro.data.world import SemanticWorld as RefWorld
from repro.launch.serve import run_once as ref_run_once
from repro.obs.export import export_trace as ref_export_trace
from repro.obs.trace import Tracer as RefTracer
from repro.serving.federation import FederationRunner as RefRunner
from repro_torch.data.workloads import region_workloads
from repro_torch.data.world import SemanticWorld
from repro_torch.launch.serve import run_once
from repro_torch.obs.analyze import (attribution, check_conservation,
                                     format_attribution)
from repro_torch.obs.export import export_trace
from repro_torch.obs.metrics import (FixedHistogram, MetricsRegistry,
                                     ScanMetrics, percentile)
from repro_torch.obs.trace import BACKGROUND, NULL_TRACER, Tracer
from repro_torch.serving.federation import FederationRunner

torch.set_num_threads(1)

BACKENDS = ("numpy", "kernel")


def _canon(s):
    return json.dumps(s, sort_keys=True, default=float)


@dataclasses.dataclass
class _Rec:
    rid: int
    arrival: float
    t_done: float
    latency: float
    remote_calls: int = 0
    peer_transfers: int = 0


# ------------------------------------------------------------- unit tests

def test_percentile_matches_numpy_linear_default():
    vals = [0.3, 1.7, 0.02, 9.4, 2.2, 2.2, 0.5]
    for q in (0, 25, 50, 99, 100):
        assert percentile(vals, q) == float(np.percentile(vals, q))


def test_fixed_histogram_legacy_keys_and_mean():
    h = FixedHistogram((30.0, 60.0))
    for v in (0.0, 29.999, 30.0, 45.0, 60.0, 1e4):
        h.add(v)
    assert h.to_dict() == {"0-30": 2, "30-60": 2, "60+": 2}
    assert h.mean == float(np.mean(h.values))
    assert len(h) == 6
    assert FixedHistogram().mean == 0.0


def test_scan_metrics_pass_accounting():
    s = ScanMetrics()
    s.note_pass(100)
    assert (s.last_rows, s.last_max_shard_rows) == (100, 100)
    s.note_pass(80, max_shard_rows=50)
    s.add_warm_pass(40, max_shard_rows=40)
    assert (s.last_rows, s.last_max_shard_rows) == (120, 90)
    assert (s.total_rows, s.total_max_shard_rows) == (220, 190)


def test_registry_snapshot_and_delta():
    reg = MetricsRegistry()
    state = {"hits": 3, "ratio": 0.5, "hist": {"0-30": 1}, "flag": True}
    reg.register("cache", lambda: state)
    reg.register("gpu", lambda: {"chips": 2})
    assert reg.namespaces() == ["cache", "gpu"]
    snap = reg.snapshot()
    assert snap == {"cache.hits": 3, "cache.ratio": 0.5,
                    "cache.hist": {"0-30": 1}, "cache.flag": True,
                    "gpu.chips": 2}
    state["hits"] = 10
    d = MetricsRegistry.delta(reg.snapshot(), snap)
    assert d["cache.hits"] == 7
    assert d["gpu.chips"] == 0
    assert d["cache.hist"] == {"0-30": 1}
    assert d["cache.flag"] is True
    assert MetricsRegistry.delta({"a.x": 4}, {})["a.x"] == 4


def test_tracer_groups_by_region_and_rid():
    tr = Tracer()
    assert tr.enabled
    tr.span(7, "stage1_scan", 0.0, 1.0)
    tr.span(7, "stage1_scan", 0.0, 1.0, region=2)
    tr.marker(7, "band_bypass", 1.0, region=2, tag="x")
    tr.span(BACKGROUND, "refresh", 0.0, 5.0)
    by_req = tr.request_spans()
    assert set(by_req) == {(0, 7), (2, 7)}
    assert len(by_req[(2, 7)]) == 2
    assert len(tr.spans) == 4


def test_null_tracer_is_inert():
    assert not NULL_TRACER.enabled
    NULL_TRACER.span(1, "x", 0.0, 1.0)
    NULL_TRACER.marker(1, "y", 0.0)
    assert not hasattr(NULL_TRACER, "spans")


def test_conservation_checker_names_gaps_overlaps_and_totals():
    tr = Tracer()
    tr.span(1, "a", 0.0, 1.0)
    tr.span(1, "b", 2.0, 3.0)
    recs = [_Rec(rid=1, arrival=0.0, t_done=3.0, latency=3.0)]
    v = check_conservation(tr, recs)
    assert len(v) == 1 and "gap" in v[0]

    tr = Tracer()
    tr.span(1, "a", 0.5, 1.0)
    v = check_conservation(tr, recs)
    assert any("arrival" in x for x in v)
    assert any("t_done" not in x or "3.0" in x for x in v)

    v = check_conservation(Tracer(), recs)
    assert v == ["region 0 rid 1: no spans recorded"]

    tr = Tracer()
    tr.span(1, "a", 0.0, 3.0)
    assert check_conservation(tr, recs) == []


# ------------------------------------------ traced runs, held to the reference

KW = dict(n_requests=120, concurrency=4, seed=3)
TIERED = dict(KW, warm_frac=0.5, workload="longtail", tail_len=40,
              judge_band=0.1)
CASES = {"plain": KW, "tiered_banded": TIERED,
         "banded": dict(KW, judge_band=0.1)}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """``traced(case, side)``: (summary without its paths, span JSONL,
    Chrome trace) of one traced run, each (case, side) run once; side is
    "ref" or a port backend."""
    d = tmp_path_factory.mktemp("traced")
    memo = {}

    def get(case, side):
        if (case, side) not in memo:
            prefix = str(d / f"{case}_{side}")
            if side == "ref":
                s = ref_run_once(trace=prefix, **CASES[case])
            else:
                s = run_once(trace=prefix, backend=side, device="cpu",
                             **CASES[case])
            paths = (s.pop("trace_jsonl"), s.pop("trace_chrome"))
            memo[case, side] = (s, *(open(p, "rb").read() for p in paths))
        s, jsonl, chrome = memo[case, side]
        return dict(s), jsonl, chrome
    return get


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["plain", "tiered_banded"])
def test_conservation_on_engine_runs(case, backend, traced):
    """Analogue of test_conservation_plain_engine and
    test_conservation_tiered_banded_engine: 0 violations, and the port's
    summary, span JSONL and Chrome trace equal the reference's."""
    s, jsonl, chrome = traced(case, backend)
    rs, rjsonl, rchrome = traced(case, "ref")
    assert _canon(s) == _canon(rs)
    assert jsonl == rjsonl and chrome == rchrome
    assert s["trace_conservation_violations"] == 0
    assert s["trace_spans"] > 0


def _federation_spans(world_cls, workloads, runner_cls, tracer_cls, **kw):
    world = world_cls(n_intents=300, dim=64, seed=5)
    reqs = workloads(world, n_regions=3, n_per_region=60, seed=6)
    tracer = tracer_cls()
    fr = runner_cls(world=world, region_requests=reqs, topology="peered",
                    seed=7, tracer=tracer, **kw)
    summary = fr.run()
    return fr, tracer, summary


@pytest.mark.parametrize("backend", BACKENDS)
def test_conservation_federation(backend, tmp_path):
    fr, tracer, summary = _federation_spans(
        SemanticWorld, region_workloads, FederationRunner, Tracer,
        backend=backend, device="cpu")
    recs = fr.records_by_region()
    assert check_conservation(tracer, recs) == []
    assert {k[0] for k in tracer.request_spans()} == set(recs)
    _, ref_tracer, ref_summary = _federation_spans(
        RefWorld, ref_region_workloads, RefRunner, RefTracer)
    assert _canon(summary) == _canon(ref_summary)
    got = export_trace(tracer, str(tmp_path / "port"))
    want = ref_export_trace(ref_tracer, str(tmp_path / "ref"))
    for key in ("jsonl", "chrome"):
        assert open(got[key], "rb").read() == open(want[key], "rb").read()


@pytest.mark.parametrize("backend", BACKENDS)
def test_traced_run_is_event_neutral(backend, traced):
    plain = run_once(backend=backend, device="cpu", **TIERED)
    s, _, _ = traced("tiered_banded", backend)
    for k in ("trace_spans", "trace_conservation_violations"):
        s.pop(k)
    assert _canon(s) == _canon(plain)


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_seed_traces_are_byte_identical(backend, traced, tmp_path):
    a, ajsonl, achrome = traced("banded", backend)
    b = run_once(trace=str(tmp_path / "b"), backend=backend, device="cpu",
                 **CASES["banded"])
    assert (tmp_path / "b.jsonl").read_bytes() == ajsonl
    assert (tmp_path / "b.chrome.json").read_bytes() == achrome
    assert a["trace_spans"] == b["trace_spans"] > 0
    assert ajsonl == traced("banded", "ref")[1]


def test_export_artifacts_are_well_formed(tmp_path):
    paths, ref_paths = {}, {}
    for tracer_cls, export, out, name in (
            (Tracer, export_trace, paths, "t"),
            (RefTracer, ref_export_trace, ref_paths, "r")):
        tr = tracer_cls()
        tr.span(1, "stage1_scan", 0.5, 0.75, region=2)
        tr.marker(BACKGROUND, "invalidation_drop", 1.0, tag="stale")
        out.update(export(tr, str(tmp_path / name)))
    rows = [json.loads(line) for line in
            open(paths["jsonl"]).read().splitlines()]
    assert rows[0] == {"dur": 0.25, "name": "stage1_scan", "region": 2,
                       "rid": 1, "t0": 0.5, "t1": 0.75}
    assert rows[1]["rid"] == BACKGROUND and rows[1]["tag"] == "stale"
    doc = json.load(open(paths["chrome"]))
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert evs[0]["ts"] == 0.5e6 and evs[0]["dur"] == 0.25e6
    assert evs[0]["pid"] == 2 and evs[0]["tid"] == 1
    assert any(e.get("ph") == "M" for e in doc["traceEvents"])
    for key in ("jsonl", "chrome"):
        assert open(paths[key], "rb").read() == \
            open(ref_paths[key], "rb").read()


def test_attribution_splits_by_request_class():
    tr = Tracer()
    tr.span(1, "stage1_scan", 0.0, 1.0)
    tr.span(1, "stage1_scan", 1.0, 2.0)
    tr.span(2, "origin_fetch", 0.0, 4.0)
    recs = [_Rec(rid=1, arrival=0.0, t_done=2.0, latency=2.0),
            _Rec(rid=2, arrival=0.0, t_done=4.0, latency=4.0,
                 remote_calls=1, peer_transfers=1)]
    rep = attribution(tr, recs)
    assert set(rep) == {"hit", "federated"}
    seg = rep["hit"]["segments"]["stage1_scan"]
    assert seg["n"] == 1 and seg["total_s"] == 2.0 == seg["p50"]
    assert rep["federated"]["latency_p99"] == 4.0
    txt = format_attribution(rep)
    assert "[hit]" in txt and "origin_fetch" in txt


@pytest.mark.parametrize("backend", BACKENDS)
def test_summary_keeps_legacy_keys_and_registry_backs_them(backend):
    out = run_once(backend=backend, device="cpu", **KW)
    for k in ("latency_p50", "latency_p99", "api_calls", "retry_ratio",
              "hit_rate", "rows_scanned", "stale_hits", "stale_age_hist",
              "judge_calls", "gpu_cost"):
        assert k in out, k
    assert "trace_jsonl" not in out
    assert _canon(out) == _canon(ref_run_once(**KW))

"""The port's overload control (``repro_torch.serving.overload``) held to
the reference's (``tests/test_overload.py``): the controller's decision
functions in isolation, the armed-but-off neutrality end to end, shed-to-
nojudge under a flash crowd, and the judge-timeout span discipline under
sustained backlog. Every run's summary equals
``repro.launch.serve.run_once``'s byte for byte, and the traced run's
span JSONL equals the reference's, on the port's numpy backend and on
its kernel backend on the CPU."""
import json

import pytest
import torch

from repro.launch.serve import run_once as ref_run_once
from repro_torch.launch.serve import run_once
from repro_torch.serving.overload import OverloadConfig, OverloadController

torch.set_num_threads(1)

BACKENDS = ("numpy", "kernel")


def _canon(s):
    return json.dumps(s, sort_keys=True, default=float)


class _FakeMonitor:
    """SLOMonitor stand-in: `active()` returns whatever the test set."""

    def __init__(self, names=()):
        self.names = set(names)

    def active(self):
        return set(self.names)


# ------------------------------------------------- decision functions


def test_shed_requires_pressure_and_similarity_margin():
    ctrl = OverloadController(
        OverloadConfig(judge_backlog_cap=4, shed_margin=0.02),
        monitor=_FakeMonitor())
    assert not ctrl.shed_judge(0.0, backlog=0, best_sim=0.99, tau=0.8)
    assert ctrl.shed_judge(1.0, backlog=4, best_sim=0.83, tau=0.8)
    assert not ctrl.shed_judge(2.0, backlog=4, best_sim=0.81, tau=0.8)
    assert ctrl.stats.shed_hits == 1
    assert ctrl.stats.backlog_sheds == 1
    assert ctrl.stats.slo_sheds == 0


def test_shed_on_slo_breach_and_flip_accounting():
    mon = _FakeMonitor()
    ctrl = OverloadController(OverloadConfig(judge_backlog_cap=None),
                              monitor=mon)
    assert not ctrl.shed_judge(0.0, backlog=0, best_sim=1.0, tau=0.0)
    mon.names = {"p99"}
    assert ctrl.shed_judge(1.0, backlog=0, best_sim=1.0, tau=0.0)
    assert ctrl.stats.slo_sheds == 1
    mon.names = set()
    assert not ctrl.shed_judge(2.0, backlog=0, best_sim=1.0, tau=0.0)
    assert ctrl.stats.shed_flips == 2


def test_slo_name_filter_watches_one_slo():
    mon = _FakeMonitor({"other"})
    ctrl = OverloadController(OverloadConfig(slo_name="p99"), monitor=mon)
    assert not ctrl.slo_breached()
    mon.names = {"other", "p99"}
    assert ctrl.slo_breached()


def test_background_work_pauses_on_headroom_or_breach():
    mon = _FakeMonitor()
    ctrl = OverloadController(OverloadConfig(min_headroom=0.35),
                              monitor=mon)
    assert ctrl.allow_prefetch(0.5, 0.0)
    assert not ctrl.allow_prefetch(0.2, 1.0)
    mon.names = {"p99"}
    assert not ctrl.allow_refresh(0.9, 2.0)
    assert ctrl.stats.prefetch_paused == 1
    assert ctrl.stats.refresh_paused == 1


def test_every_policy_has_an_off_switch():
    mon = _FakeMonitor({"p99"})
    off = OverloadController(OverloadConfig(enabled=False), monitor=mon)
    assert not off.shed_judge(0.0, backlog=10 ** 6, best_sim=1.0, tau=0.0)
    assert off.allow_prefetch(0.0, 0.0) and off.allow_refresh(0.0, 0.0)
    assert not off.serve_stale_ok()
    assert not any(off.metrics().values())
    ctrl = OverloadController(
        OverloadConfig(shed_on_slo=False, judge_backlog_cap=None,
                       pause_prefetch=False, pause_refresh=False,
                       serve_stale_on_failure=False),
        monitor=mon)
    assert not ctrl.shed_judge(0.0, backlog=10 ** 6, best_sim=1.0, tau=0.0)
    assert ctrl.allow_prefetch(0.0, 0.0) and ctrl.allow_refresh(0.0, 0.0)
    assert not ctrl.serve_stale_ok()


# ------------------------------------------ end to end, held to the reference

FLASH = dict(workload="trend", n_requests=200, n_intents=150, dim=64,
             qpm=400.0, trend_duration=8.0, seed=9, sample_interval=5.0,
             slo=["p99:window.latency_p99:<=:5.0"])
CASES = {
    "plain": dict(n_requests=120, n_intents=100, dim=64, concurrency=4,
                  seed=3),
    "off": dict(n_requests=120, n_intents=100, dim=64, concurrency=4,
                seed=3, overload="off"),
    "flash_off": dict(FLASH, overload="off"),
    "flash_on": dict(FLASH, overload="on"),
}
_memo: dict = {}


def _run(case: str, backend: str) -> dict:
    """The port's summary on ``backend``, checked equal to the
    reference's byte for byte; each (case, backend) runs once."""
    if case not in _memo:
        _memo[case] = {"ref": _canon(ref_run_once(**CASES[case]))}
    if backend not in _memo[case]:
        got = _canon(run_once(backend=backend, device="cpu", **CASES[case]))
        assert got == _memo[case]["ref"], case
        _memo[case][backend] = got
    return json.loads(_memo[case][backend])


@pytest.mark.parametrize("backend", BACKENDS)
def test_armed_off_run_is_byte_neutral(backend):
    plain, off = _run("plain", backend), _run("off", backend)
    assert not any(off["overload"].values())
    assert "overload" not in plain
    off.pop("overload")
    assert _canon(off) == _canon(plain)


def test_run_once_rejects_unknown_overload_mode():
    with pytest.raises(ValueError):
        run_once(n_requests=10, overload="sideways", backend="kernel",
                 device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_flash_crowd_sheds_and_recovers_latency(backend):
    off, on = _run("flash_off", backend), _run("flash_on", backend)
    assert on["overload"]["shed_hits"] > 0
    assert on["overload"]["backlog_sheds"] > 0
    assert on["latency_p99"] < off["latency_p99"]
    assert on["hit_rate"] >= off["hit_rate"]
    assert on["info_accuracy"] >= 0.98


# ------------------------------- judge timeout under sustained backlog

TIMEOUT = dict(workload="trend", n_requests=200, n_intents=150, dim=64,
               qpm=400.0, trend_duration=10.0, judge_timeout=0.05, seed=9)


@pytest.fixture(scope="module")
def timeout_runs(tmp_path_factory):
    """The reference's traced run once, and the port's on both backends:
    (summary without its paths, span JSONL bytes) per side."""
    d = tmp_path_factory.mktemp("timeout")
    out = {}
    for side in ("ref", *BACKENDS):
        prefix = str(d / side)
        if side == "ref":
            s = ref_run_once(trace=prefix, **TIMEOUT)
        else:
            s = run_once(trace=prefix, backend=side, device="cpu", **TIMEOUT)
        paths = (s.pop("trace_jsonl"), s.pop("trace_chrome"))
        out[side] = (_canon(s), *(open(p, "rb").read() for p in paths))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_judge_timeout_spans_under_sustained_backlog(backend, timeout_runs):
    """Flash crowd + tight judge deadline: the port's span JSONL and
    Chrome trace equal the reference's byte for byte, and hold the
    reference's span discipline (queued and dispatched timeouts, each
    followed by an origin fetch at the timeout instant, never two
    overlapping)."""
    summary, jsonl, chrome = timeout_runs[backend]
    assert (summary, jsonl, chrome) == timeout_runs["ref"]
    assert json.loads(summary)["trace_conservation_violations"] == 0
    rows = [json.loads(line) for line in jsonl.decode().splitlines()]
    by_rid = {}
    for r in rows:
        by_rid.setdefault(r["rid"], []).append(r)
    queued = [r for r in rows if r["name"] == "judge_queue_wait"
              and r.get("tag") == "timeout"]
    computed = [r for r in rows if r["name"] == "judge_compute"
                and r.get("tag") == "timeout"]
    assert queued and computed
    for span in computed:
        assert [r for r in by_rid[span["rid"]]
                if r["name"] == "judge_queue_wait"
                and r.get("tag") is None and r["t1"] == span["t0"]]
    for span in queued + computed:
        assert [r for r in by_rid[span["rid"]]
                if r["name"] == "origin_fetch" and r["t0"] == span["t1"]]
    for spans in by_rid.values():
        tagged = sorted((r for r in spans if r.get("tag") == "timeout"
                         and r["name"].startswith("judge_")),
                        key=lambda r: r["t0"])
        for a, b in zip(tagged, tagged[1:]):
            assert a["t1"] <= b["t0"]

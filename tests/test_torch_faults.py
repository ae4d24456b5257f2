"""The port's fault injection (``repro_torch.serving.faults``) held to the
reference's (``tests/test_faults.py``): the FaultSchedule window algebra
and spec grammar, origin-brownout terminal failure in the remote service
(each outcome equal to the reference service's on the same seed), and
end to end the armed-but-inactive neutrality and the brownout run, whose
summaries equal ``repro.launch.serve.run_once``'s byte for byte on the
port's numpy backend and on its kernel backend on the CPU."""
import dataclasses
import json

import pytest
import torch

from repro.launch.serve import run_once as ref_run_once
from repro.serving.faults import FaultSchedule as RefFaultSchedule
from repro.serving.remote import RemoteDataService as RefRemote
from repro_torch.launch.serve import run_once
from repro_torch.serving.faults import FaultSchedule, FaultWindow
from repro_torch.serving.remote import RemoteDataService

torch.set_num_threads(1)

BACKENDS = ("numpy", "kernel")


def _canon(s):
    return json.dumps(s, sort_keys=True, default=float)


# the reference's two end-to-end configurations, at its sizes
CASES = {
    "plain": dict(n_requests=120, n_intents=100, dim=64, concurrency=4,
                  seed=3),
    "armed": dict(n_requests=120, n_intents=100, dim=64, concurrency=4,
                  seed=3, faults=["origin_brownout:1e8:2e8:error_rate=1.0"]),
    "brownout_on": dict(n_requests=300, n_intents=200, dim=64,
                        churn_period=20.0, qpm=None, seed=3, overload="on",
                        faults=["origin_brownout:50:150:error_rate=1.0"]),
    "brownout_off": dict(n_requests=300, n_intents=200, dim=64,
                         churn_period=20.0, qpm=None, seed=3,
                         overload="off",
                         faults=["origin_brownout:50:150:error_rate=1.0"]),
}
_memo: dict = {}


def _run(case: str, backend: str) -> dict:
    """The port's summary on ``backend``, after checking it equals the
    reference's byte for byte; each (case, backend) runs once."""
    if case not in _memo:
        _memo[case] = {"ref": _canon(ref_run_once(**CASES[case]))}
    if backend not in _memo[case]:
        got = _canon(run_once(backend=backend, device="cpu", **CASES[case]))
        assert got == _memo[case]["ref"], case
        _memo[case][backend] = got
    return json.loads(_memo[case][backend])


# ------------------------------------------------------- window algebra


def test_windows_are_half_open_and_region_scoped():
    sched = FaultSchedule([
        FaultWindow("region_outage", 10.0, 20.0, region=1),
    ])
    assert sched.region_down(1, 10.0)
    assert sched.region_down(1, 19.999)
    assert not sched.region_down(1, 20.0)
    assert not sched.region_down(1, 9.999)
    assert not sched.region_down(0, 15.0)


def test_region_none_hits_every_region():
    sched = FaultSchedule([FaultWindow("region_outage", 0.0, 5.0)])
    assert sched.region_down(0, 1.0) and sched.region_down(7, 1.0)


def test_link_mult_composes_and_touches_either_endpoint():
    sched = FaultSchedule([
        FaultWindow("wan_degrade", 0.0, 10.0, region=1, mult=3.0),
        FaultWindow("wan_degrade", 0.0, 10.0, mult=2.0),
    ])
    assert sched.link_mult(0, 1, 5.0) == pytest.approx(6.0)
    assert sched.link_mult(1, 2, 5.0) == pytest.approx(6.0)
    assert sched.link_mult(0, 2, 5.0) == pytest.approx(2.0)
    assert sched.link_mult(0, 1, 10.0) == 1.0


def test_judge_mult_and_brownout_queries():
    sched = FaultSchedule([
        FaultWindow("judge_slowdown", 0.0, 5.0, region=2, mult=4.0),
        FaultWindow("origin_brownout", 1.0, 3.0, error_rate=0.5,
                    throttle=0.25),
    ])
    assert sched.judge_mult(2, 1.0) == pytest.approx(4.0)
    assert sched.judge_mult(0, 1.0) == 1.0
    bw = sched.brownout(0, 2.0)
    assert bw is not None and bw.error_rate == 0.5 and bw.throttle == 0.25
    assert sched.brownout(0, 3.0) is None


# --------------------------------------------------------- spec grammar

SPECS = ["region_outage:60:120:region=1",
         "wan_degrade:30:90:region=1,mult=4",
         "origin_brownout:20:80:error_rate=0.6,throttle=0.2",
         "judge_slowdown:10:50:mult=3"]


def test_parse_full_grammar():
    sched = FaultSchedule.parse(SPECS)
    assert len(sched) == 4
    assert sched.region_down(1, 60.0) and not sched.region_down(0, 60.0)
    assert sched.link_mult(1, 2, 40.0) == pytest.approx(4.0)
    assert sched.brownout(0, 20.0).error_rate == pytest.approx(0.6)
    assert sched.judge_mult(0, 10.0) == pytest.approx(3.0)
    # the same windows as the reference's parser, field for field
    assert [dataclasses.asdict(w) for w in sched.windows] == \
        [dataclasses.asdict(w) for w in RefFaultSchedule.parse(SPECS).windows]


@pytest.mark.parametrize("spec", ["region_outage:60", "meteor_strike:0:10",
                                  "wan_degrade:0:10:speed=3",
                                  "wan_degrade:10:10"])
def test_parse_rejects_bad_specs(spec):
    with pytest.raises(ValueError):
        FaultSchedule.parse([spec])
    with pytest.raises(ValueError):
        RefFaultSchedule.parse([spec])


# -------------------------------------------- origin brownout (remote)


def test_brownout_exhausts_retries_into_terminal_failure():
    spec = ["origin_brownout:0:1e9:error_rate=1.0"]
    svc = RemoteDataService(qpm=None, seed=0,
                            faults=FaultSchedule.parse(spec))
    out = svc.fetch(0.0)
    assert out.failed
    assert out.retries == svc.max_retries + 1
    assert out.cost == 0.0
    assert svc.failed == 1
    assert svc.calls == 0
    assert svc.throttled_wait == pytest.approx(out.throttled_wait)
    ref = RefRemote(qpm=None, seed=0, faults=RefFaultSchedule.parse(spec))
    assert dataclasses.astuple(out) == dataclasses.astuple(ref.fetch(0.0))


def test_fetch_outside_brownout_window_is_untouched():
    sched = FaultSchedule.parse(["origin_brownout:50:60:error_rate=1.0"])
    a = RemoteDataService(qpm=None, seed=0, faults=sched)
    b = RemoteDataService(qpm=None, seed=0)
    oa, ob = a.fetch(0.0), b.fetch(0.0)
    assert not oa.failed
    assert oa == ob


def test_armed_empty_schedule_is_stream_neutral():
    a = RemoteDataService(qpm=50.0, seed=4, faults=FaultSchedule())
    b = RemoteDataService(qpm=50.0, seed=4)
    ref = RefRemote(qpm=50.0, seed=4, faults=RefFaultSchedule())
    for i in range(40):
        oa = a.fetch(i * 0.1)
        assert oa == b.fetch(i * 0.1)
        assert dataclasses.astuple(oa) == \
            dataclasses.astuple(ref.fetch(i * 0.1))
    assert (a.calls, a.retries, a.total_cost) == \
        (b.calls, b.retries, b.total_cost) == \
        (ref.calls, ref.retries, ref.total_cost)


# ------------------------------------------------- end-to-end neutrality


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_once_with_inactive_faults_matches_plain_summary(backend):
    plain, armed = _run("plain", backend), _run("armed", backend)
    assert "fetch_failed" not in plain
    assert armed.pop("fetch_failed") == 0
    armed.pop("throttled_wait")
    assert _canon(armed) == _canon(plain)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_once_brownout_completes_with_degraded_paths(backend):
    on, off = _run("brownout_on", backend), _run("brownout_off", backend)
    assert on["n"] == off["n"] == 300
    assert on["fetch_failed"] > 0 and off["fetch_failed"] > 0
    assert on["overload"]["stale_served"] > 0
    assert off["overload"]["stale_served"] == 0

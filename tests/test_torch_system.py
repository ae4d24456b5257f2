"""The paper's end-to-end claims on the port's serving path: analogues of
tests/test_system.py's 9 tests. Each runs the port's ``run_once`` (the
kernel backend on ``device="cpu"``: stage 1 through the kernels' plain
PyTorch versions) and the reference's on the same arguments, holds the
port's summary ``json.dumps(sort_keys=True)``-identical to the
reference's, and checks the reference test's claim on the port's numbers
(semantic hits far above exact hits, the judge protecting accuracy,
rate-limit relief, co-location near parity, cheap recalibration, the
coding workload's gains)."""
import json

import pytest
import torch

from repro.launch.serve import run_once as ref_run_once
from repro_torch.launch.serve import run_once as port_run_once

torch.set_num_threads(1)


def both(**kw) -> dict:
    """The port's summary of ``run_once(**kw)``, after holding it equal
    to the reference's."""
    got = port_run_once(backend="kernel", device="cpu", **kw)
    want = ref_run_once(**kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    return got


@pytest.fixture(scope="module")
def results():
    return {mode: both(workload="zipf", mode=mode, n_requests=500,
                       cache_ratio=0.5, n_intents=600, concurrency=8, seed=0)
            for mode in ("vanilla", "exact", "cortex", "cortex-nojudge")}


def test_cortex_hit_rate_dominates_exact(results):
    assert results["cortex"]["hit_rate"] > 0.55
    assert results["cortex"]["hit_rate"] > 2 * results["exact"]["hit_rate"]


def test_cortex_throughput_dominates(results):
    assert (results["cortex"]["throughput_rps"]
            > 1.5 * results["exact"]["throughput_rps"])
    assert (results["cortex"]["throughput_rps"]
            > 2.0 * results["vanilla"]["throughput_rps"])


def test_api_calls_slashed(results):
    assert results["cortex"]["api_calls"] < \
        0.5 * results["vanilla"]["api_calls"]
    assert results["cortex"]["retry_ratio"] < results["vanilla"]["retry_ratio"]


def test_judge_protects_accuracy(results):
    """Naive ANN caching loses EM; the full pipeline stays near vanilla
    (paper Fig 13)."""
    assert results["cortex"]["em"] >= results["vanilla"]["em"] - 0.03
    assert results["cortex-nojudge"]["em"] < results["cortex"]["em"]
    assert results["cortex"]["info_accuracy"] > 0.97


def test_cost_efficiency(results):
    assert (results["cortex"]["thpt_per_dollar"]
            > 2 * results["vanilla"]["thpt_per_dollar"])


def test_rate_limit_ablation():
    """Table 4: removing the rate limit helps vanilla more than cortex."""
    kw = dict(workload="zipf", n_requests=300, cache_ratio=0.5,
              concurrency=8, seed=1)
    lim = {m: both(mode=m, qpm=100.0, **kw) for m in ("vanilla", "cortex")}
    nolim = {m: both(mode=m, qpm=None, **kw) for m in ("vanilla", "cortex")}
    gain_lim = lim["cortex"]["throughput_rps"] / \
        lim["vanilla"]["throughput_rps"]
    gain_nolim = nolim["cortex"]["throughput_rps"] / \
        nolim["vanilla"]["throughput_rps"]
    assert gain_lim > gain_nolim > 1.0


def test_colocation_near_parity():
    """Table 7: co-located keeps most of the dedicated two-chip throughput
    at half the hardware (prefetch off, as in the reference's test)."""
    kw = dict(workload="zipf", mode="cortex", n_requests=400,
              cache_ratio=0.6, concurrency=12, prefetch=False, seed=2)
    co = both(colocated=True, **kw)
    ded = both(colocated=False, **kw)
    assert co["throughput_rps"] > 0.8 * ded["throughput_rps"]
    assert co["thpt_per_dollar"] > ded["thpt_per_dollar"]


def test_recalibration_runs_and_is_cheap():
    kw = dict(workload="zipf", mode="cortex", n_requests=400,
              cache_ratio=0.5, concurrency=8, seed=3)
    base = both(**kw)
    recal = both(recalibrate_every=30.0, **kw)
    assert recal["throughput_rps"] > 0.9 * base["throughput_rps"]


def test_swe_workload_gains():
    """Fig 9: the coding workload sees moderate (but real) gains."""
    kw = dict(workload="swe", n_requests=400, cache_ratio=0.5,
              concurrency=8, seed=4)
    ex = both(mode="exact", **kw)
    co = both(mode="cortex", **kw)
    assert co["hit_rate"] > ex["hit_rate"]
    assert co["throughput_rps"] >= ex["throughput_rps"]

"""The host options of the port's ``run_once`` that ``test_torch_serve``
never sets, one case each at 300 requests over 300 intents: the summary
is ``json.dumps(sort_keys=True)``-identical to the reference's
``repro.launch.serve.run_once`` on the port's numpy backend and on its
kernel backend on the CPU."""
import functools
import json

import pytest
import torch

from repro.launch.serve import run_once as ref_run_once
from repro_torch.launch.serve import run_once

torch.set_num_threads(1)

BASE = dict(n_requests=300, n_intents=300)
OPTIONS = {
    "judge_band": dict(judge_band=0.1),
    # the adaptive band recalibrates its width with tau_lsm
    "judge_adaptive_band": dict(judge_band=0.1, judge_adaptive_band=True,
                                recalibrate_every=20.0),
    "recalibrate_every": dict(recalibrate_every=20.0),
    "prefetch": dict(prefetch=False),
    "colocated": dict(colocated=False),
    "gpu_capacity": dict(gpu_capacity=1500.0, colocated=False),
    "qpm": dict(qpm=None),
    "workload_swe": dict(workload="swe"),
    "warmup_frac": dict(warmup_frac=0.2),
    "trend_duration": dict(workload="trend", trend_duration=60.0),
    # the reservoir bounds stale-age samples, so the world must churn
    "stale_age_reservoir": dict(stale_age_reservoir=8, churn_period=20.0),
    "judge_timeout": dict(judge_timeout=0.05),
    "em_p_base": dict(em_p_base=0.5),
    "t_cache_per_row": dict(t_cache_per_row=2e-5),
}


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> str:
    return json.dumps(ref_run_once(**BASE, **OPTIONS[case]), sort_keys=True)


# The adaptive band's width is 2 x (sim_tau - tau_sim), where sim_tau is
# one recorded stage-1 cosine (core/recalibrate.py). The kernel backend's
# cosines (its plain version on the CPU, the CUDA kernel on the card) sum
# in another order than numpy's fp32 matmul, so that one cosine may sit a
# rounding away and the width twice that: 2 x 2**-24, one fp32 ulp in
# [0.5, 1). Every other key is exact (ROADMAP §3).
BAND_WIDTH_TOL = 2 * 2.0 ** -24


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_host_option_matches_reference(case, backend):
    got = run_once(backend=backend, device="cpu", **BASE, **OPTIONS[case])
    want = json.loads(_reference(case))
    if case == "judge_adaptive_band" and backend == "kernel":
        assert abs(got.pop("band_width") - want.pop("band_width")) \
            <= BAND_WIDTH_TOL
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)

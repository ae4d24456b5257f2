"""The port's serving path end to end on the CPU: ``run_once`` summaries
are ``json.dumps(sort_keys=True)``-identical to the JAX package's
``repro.launch.serve.run_once`` (whose engine runs the numpy stage 1),
for the port's numpy backend and for its kernel backend on
``device="cpu"`` (the kernels' plain PyTorch versions), brute force, with
the int8 warm tier, with clustered stage 1, and with both."""
import functools
import json
from pathlib import Path

import pytest
import torch

from repro.launch.serve import run_once as ref_run_once
from repro_torch.kernels.ann_topk import ann_topk
from repro_torch.kernels.ann_topk_ivf import ann_topk_ivf, ann_topk_ivf_quant
from repro_torch.kernels.ann_topk_quant import ann_topk_quant
from repro_torch.launch.serve import main as port_main
from repro_torch.launch.serve import run_once as port_run_once

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "seed0": {"seed": 0},
    "seed1": {"seed": 1},
    "seed2": {"seed": 2},
    "evict": {"cache_ratio": 0.05, "eviction": "lcfu", "n_requests": 300,
              "concurrency": 16},
    "trend": {"workload": "trend"},
    "exact": {"mode": "exact"},
    "nojudge": {"mode": "cortex-nojudge"},
    "vanilla": {"mode": "vanilla"},
    # (a) the repo's tiered config (benchmarks/figures.py:281-288): the
    # int8 warm tier, brute force; (b) zipf defaults with clustering: the
    # hot router trains; (c) tiered and clustered where both routers train
    "tiered": {"workload": "longtail", "n_requests": 700, "n_intents": 688,
               "dim": 64, "tail_len": 640, "cache_ratio": 0.18,
               "concurrency": 8, "max_ttl": 1800.0, "seed": 31,
               "warm_frac": 0.5},
    "clustered": {"cluster": True},
    "tiered_clustered": {"workload": "longtail", "n_intents": 3000,
                         "n_requests": 3000, "tail_len": 2800,
                         "concurrency": 16, "cache_ratio": 0.3,
                         "warm_frac": 0.5, "cluster": True},
}
# the kernels each case's kernel-backend run must reach (ann_topk aside)
NEW_KERNELS = {"tiered": (ann_topk_quant,), "clustered": (ann_topk_ivf,),
               "tiered_clustered": (ann_topk_quant, ann_topk_ivf,
                                    ann_topk_ivf_quant)}


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> str:
    return json.dumps(ref_run_once(**CASES[case]), sort_keys=True)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_run_once_matches_reference(case, backend):
    wrappers = (ann_topk, ann_topk_quant, ann_topk_ivf, ann_topk_ivf_quant)
    plain_before = [w.plain_calls for w in wrappers]
    got = port_run_once(backend=backend, device="cpu", **CASES[case])
    assert json.dumps(got, sort_keys=True) == _reference(case)
    stage1_runs = backend == "kernel" and CASES[case].get("mode", "cortex") \
        in ("cortex", "cortex-nojudge")
    reached = {w for w, n in zip(wrappers, plain_before) if w.plain_calls > n}
    want = {ann_topk, *NEW_KERNELS.get(case, ())} if stage1_runs else set()
    assert reached == want
    if case == "evict":
        assert got["evictions"] > 0
    if "warm_frac" in CASES[case]:
        assert got["demotions"] > 0 and got["warm_hits"] > 0


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_nprobe_all_run_equals_brute(backend):
    """Analogue of tests/test_clustering.py:267: an engine run routed over
    every cluster equals the brute-force run (the scan-volume counters
    aside), and both equal the reference's."""
    kw = dict(workload="zipf", mode="cortex", n_requests=120, n_intents=200,
              dim=32, concurrency=4, seed=14, cache_ratio=0.9)

    def strip(s):
        return json.dumps({k: v for k, v in s.items()
                           if k not in ("rows_scanned", "rows_per_lookup")},
                          sort_keys=True, default=float)

    brute = port_run_once(backend=backend, device="cpu", **kw)
    routed = port_run_once(backend=backend, device="cpu", cluster=True,
                           n_clusters=8, nprobe=None, **kw)
    assert strip(routed) == strip(brute)
    assert json.dumps(routed, sort_keys=True) == json.dumps(
        ref_run_once(cluster=True, n_clusters=8, nprobe=None, **kw),
        sort_keys=True)


def test_cli_matches_reference(capsys):
    got = port_main(["--backend", "kernel", "--device", "cpu",
                     "--n-requests", "300", "--cache-ratio", "0.05",
                     "--concurrency", "16"])
    assert json.dumps(got, sort_keys=True) == _reference("evict")
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(got, default=float))


def test_cli_tiers_and_clustering_match_reference(capsys):
    """--warm-frac, --cluster, --n-clusters and --nprobe reach run_once as
    the reference's CLI passes them."""
    from repro.launch.serve import main as ref_main

    argv = ["--workload", "longtail", "--n-requests", "300",
            "--cache-ratio", "0.2", "--concurrency", "8", "--warm-frac",
            "0.5", "--cluster", "--n-clusters", "16", "--nprobe", "4"]
    want = ref_main(argv)
    capsys.readouterr()
    got = port_main(argv + ["--backend", "kernel", "--device", "cpu"])
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["demotions"] > 0


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_quickstart_replay_matches_reference(backend, capsys):
    """examples/quickstart.py run as written, then on the port (imports
    rewritten, the cache asked for on the CPU): the same hits, candidates,
    evictions and stats, line for line."""
    src = (ROOT / "examples" / "quickstart.py").read_text()
    exec(compile(src, "quickstart.py", "exec"), {"__name__": "quickstart"})
    want = capsys.readouterr().out
    port = src.replace("from repro.", "from repro_torch.").replace(
        "make_cache(\n", f"make_cache(\n    backend={backend!r}, device='cpu',\n")
    assert port.count("repro_torch.") == 3 and "device='cpu'" in port
    exec(compile(port, "quickstart_port.py", "exec"),
         {"__name__": "quickstart_port"})
    got = capsys.readouterr().out
    assert "paraphrase lookup: hit=True" in want
    assert got == want

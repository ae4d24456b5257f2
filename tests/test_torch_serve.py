"""The port's serving path end to end on the CPU: ``run_once`` summaries
are ``json.dumps(sort_keys=True)``-identical to the JAX package's
``repro.launch.serve.run_once`` (whose engine runs the numpy stage 1),
for the port's numpy backend and for its kernel backend on
``device="cpu"`` (the kernel's plain PyTorch version)."""
import functools
import json
from pathlib import Path

import pytest
import torch

from repro.launch.serve import run_once as ref_run_once
from repro_torch.kernels.ann_topk import ann_topk
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
}


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> str:
    return json.dumps(ref_run_once(**CASES[case]), sort_keys=True)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_run_once_matches_reference(case, backend):
    plain_before = ann_topk.plain_calls
    got = port_run_once(backend=backend, device="cpu", **CASES[case])
    assert json.dumps(got, sort_keys=True) == _reference(case)
    stage1_runs = backend == "kernel" and CASES[case].get("mode", "cortex") \
        in ("cortex", "cortex-nojudge")
    assert (ann_topk.plain_calls > plain_before) == stage1_runs
    if case == "evict":
        assert got["evictions"] > 0


def test_cli_matches_reference(capsys):
    got = port_main(["--backend", "kernel", "--device", "cpu",
                     "--n-requests", "300", "--cache-ratio", "0.05",
                     "--concurrency", "16"])
    assert json.dumps(got, sort_keys=True) == _reference("evict")
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(got, default=float))


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

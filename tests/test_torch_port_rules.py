"""Rules of the port: what it may import, how it picks its device, what it
refuses until its ROADMAP slice lands, what it builds, and the config
arithmetic the stage-2 judge prices itself with."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.roofline import active_params as ref_active_params
from repro.launch.roofline import model_flops as ref_model_flops
from repro_torch.configs import get_config, list_archs, shrink
from repro_torch.core.judge import ModelJudge, OracleJudge
from repro_torch.core.judge_pipeline import judge_token_cost
from repro_torch.core.cache import make_cache
from repro_torch.data.world import SemanticWorld
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.launch.roofline import active_params, model_flops
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import run_once

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("d_model,cost", [(128, 16.0), (256, 32.0)])
def test_judge_token_cost(d_model, cost):
    from repro_torch.core.judge_pipeline import default_judge_cfg

    assert judge_token_cost(default_judge_cfg(d_model=d_model)) == cost


@pytest.mark.parametrize("name", list_archs())
@pytest.mark.parametrize("shrunk", [False, True])
def test_configs_and_model_flops_match_reference(name, shrunk):
    cfg, ref = get_config(name), ref_get_config(name)
    if shrunk:
        from repro.configs import shrink as ref_shrink

        cfg, ref = shrink(cfg, d_model=128), ref_shrink(ref, d_model=128)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert active_params(cfg) == ref_active_params(ref)
    for kind in ("train", "prefill", "decode"):
        assert model_flops(cfg, kind, 128) == ref_model_flops(ref, kind, 128)
    assert cfg.pdt == torch.bfloat16 and cfg.cdt == torch.bfloat16


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_serving_path_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        run_once(n_requests=10)            # defaults: kernel on cuda
    world = SemanticWorld(n_intents=10, dim=8, seed=0)
    with pytest.raises(RuntimeError):
        make_cache(capacity_bytes=1000, dim=8, judge=OracleJudge(world))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


UNPORTED = {
    "shards": ({"shards": 2}, "Sharded stage 1"),
    "churn_period": ({"churn_period": 20.0}, "Freshness"),
    "invalidation": ({"invalidation": True}, "Freshness"),
    "refresh_ahead": ({"refresh_ahead": True}, "Freshness"),
    "faults": ({"faults": ["origin_brownout:20:80"]}, "Freshness"),
    "overload": ({"overload": "on"}, "Freshness"),
    "churn_workload": ({"workload": "churn"}, "Freshness"),
    "sample_interval": ({"sample_interval": 5.0}, "telemetry"),
    "slo": ({"slo": ["p99:window.latency_p99:<=:3.0"]}, "telemetry"),
    "timeseries": ({"timeseries": "ts"}, "telemetry"),
    "trace": ({"trace": "tr"}, "telemetry"),
    "judge_compute": ({"judge_compute": "model"}, "Real stage-2 compute"),
}


@pytest.mark.parametrize("option", sorted(UNPORTED))
def test_unported_option_names_its_roadmap_slice(option):
    kwargs, roadmap_slice = UNPORTED[option]
    with pytest.raises(NotImplementedError, match=roadmap_slice):
        run_once(n_requests=10, backend="numpy", device="cpu", **kwargs)


@pytest.mark.parametrize("option", ["warm_frac", "cluster"])
def test_tiers_and_clustering_no_longer_raise(option):
    """The options of the ported slices run; shards > 1 still raises."""
    kwargs = {"warm_frac": 0.5} if option == "warm_frac" else \
        {"cluster": True}
    out = run_once(n_requests=10, backend="numpy", device="cpu", **kwargs)
    assert out["hit_rate"] >= 0
    with pytest.raises(NotImplementedError, match="Sharded stage 1"):
        run_once(n_requests=10, backend="numpy", device="cpu", shards=2,
                 **kwargs)


def test_unported_entry_points_raise():
    from repro_torch.core.clustering import ClusterConfig

    with pytest.raises(NotImplementedError, match="Freshness"):
        serve_main(["--regions", "3", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Real stage-2 compute"):
        ModelJudge()
    world = SemanticWorld(n_intents=10, dim=8, seed=0)
    cache = make_cache(capacity_bytes=1000, dim=8, judge=OracleJudge(world),
                       backend="kernel", device="cpu",
                       cluster=ClusterConfig(n_shards=2))
    with pytest.raises(NotImplementedError, match="Sharded stage 1"):
        cache.seri.index.router.kernel_shard_buckets(cache.seri.index)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing toolkit is an error, never a fall back to the plain
    version; nothing is written when the build cannot start."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("ann_topk")
    assert not (tmp_path / "build").exists()


def test_every_kernel_source_is_built_and_hashed_with_its_headers():
    """build.SOURCES names every csrc/*.cu, and a library's name changes
    with the shared headers its source includes."""
    assert sorted(build.SOURCES) == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))
    assert {"dot.cuh", "select.cuh"} <= {p.name for p in
                                         build.CSRC.glob("*.cuh")}
    for name in build.SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "dot.cuh"' in text and '#include "select.cuh"' in text
    paths = {n: build.library_path(n) for n in build.SOURCES}
    assert len(set(paths.values())) == len(paths)

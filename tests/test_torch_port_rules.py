"""Rules of the port: what it may import, how it picks its device, the
options it once refused until their ROADMAP slice landed (each runs now),
what it builds, and the config arithmetic the stage-2 judge prices itself
with."""
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
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_serving_path_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.serving.generator, repro_torch.core.embedder, "
            "repro_torch.core.judge, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "sys.exit(bool(bad))")
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
    # the LM entry points default to cuda too
    from repro_torch.core.embedder import ModelEmbedder
    from repro_torch.serving.generator import ContinuousBatcher

    with pytest.raises(RuntimeError, match="is_available"):
        ModelJudge()
    with pytest.raises(RuntimeError, match="is_available"):
        ModelEmbedder()
    with pytest.raises(RuntimeError, match="is_available"):
        ContinuousBatcher(shrink(get_config("search-r1-7b")))
    with pytest.raises(RuntimeError, match="is_available"):
        run_once(n_requests=10, backend="numpy", judge_compute="model")


# options once refused here, each ported since its ROADMAP slice landed;
# "trace"/"timeseries" prefixes go under the test's tmp_path
PORTED_SINCE = {
    "shards": {"shards": 2},
    "judge_compute": {"judge_compute": "model", "judge_d_model": 64},
    "churn_period": {"churn_period": 20.0},
    "invalidation": {"invalidation": True},
    "refresh_ahead": {"refresh_ahead": True},
    "faults": {"faults": ["origin_brownout:20:80"]},
    "overload": {"overload": "on"},
    "churn_workload": {"workload": "churn"},
    "sample_interval": {"sample_interval": 5.0},
    "slo": {"slo": ["p99:window.latency_p99:<=:3.0"],
            "sample_interval": 5.0},
    "timeseries": {"timeseries": "ts", "sample_interval": 5.0},
    "trace": {"trace": "tr"},
}
# the keys that carry a run's output paths (they name the backend's files)
PATH_KEYS = ("trace_jsonl", "trace_chrome", "timeseries_path", "alerts_path")


def _kernel_equals_numpy(tmp_path=None, **kwargs) -> dict:
    runs = {}
    for backend in ("kernel", "numpy"):
        kw = {k: (str(tmp_path / f"{v}_{backend}")
                  if k in ("trace", "timeseries") else v)
              for k, v in kwargs.items()}
        runs[backend] = run_once(n_requests=10, backend=backend,
                                 device="cpu", **kw)
    got, want = runs["kernel"], runs["numpy"]
    for key in PATH_KEYS:
        if key in got:
            with open(got.pop(key), "rb") as a, open(want.pop(key), "rb") as b:
                assert a.read() == b.read(), key
    assert got == want
    return got


@pytest.mark.parametrize("option", sorted(PORTED_SINCE))
def test_unported_option_names_its_roadmap_slice(option, tmp_path):
    """Every option once refused here, naming its ROADMAP slice, runs
    now, on the kernel backend as on the numpy one (their output files
    byte for byte equal), and but for the model judge equal to the
    reference's ``run_once``."""
    got = _kernel_equals_numpy(tmp_path, **PORTED_SINCE[option])
    if option in ("shards", "judge_compute"):
        return
    from repro.launch.serve import run_once as ref_run_once

    kw = {k: (str(tmp_path / f"{v}_ref") if k in ("trace", "timeseries")
              else v) for k, v in PORTED_SINCE[option].items()}
    want = ref_run_once(n_requests=10, **kw)
    for key in PATH_KEYS:
        want.pop(key, None)
    assert got == want


@pytest.mark.parametrize("option", ["warm_frac", "cluster"])
def test_tiers_and_clustering_no_longer_raise(option):
    """The options of the ported slices run, sharded too (shards > 1), the
    kernel backend's summary equal to the numpy backend's."""
    kwargs = {"warm_frac": 0.5} if option == "warm_frac" else \
        {"cluster": True}
    out = run_once(n_requests=10, backend="numpy", device="cpu", **kwargs)
    assert out["hit_rate"] >= 0
    assert _kernel_equals_numpy(shards=2, **kwargs)["stage1_shards"] == 2


def test_unported_entry_points_raise(capsys):
    """Every entry point once refused here runs: ``main --regions 3``
    (the federation) on the CPU gives the reference's summary; the model
    judge and the sharded kernel layout build on the CPU."""
    from repro.launch.serve import main as ref_main
    from repro_torch.core.clustering import ClusterConfig

    args = ["--regions", "3", "--n-requests", "60"]
    fed = serve_main(args + ["--device", "cpu"])
    assert fed == ref_main(args)
    assert fed["aggregate"]["n"] == 60 and len(fed["regions"]) == 3
    capsys.readouterr()
    # the model judge is ported: it builds and scores on the CPU
    judge = ModelJudge(max_len=16, device="cpu")
    scores = judge.score_pairs(["a query", "b"], ["a cached key", "c"])
    assert scores.shape == (2,) and ((scores > 0) & (scores < 1)).all()
    world = SemanticWorld(n_intents=10, dim=8, seed=0)
    cache = make_cache(capacity_bytes=1000, dim=8, judge=OracleJudge(world),
                       backend="kernel", device="cpu",
                       cluster=ClusterConfig(n_shards=2))
    # the sharded kernel layout is ported: the even split of 64 clusters
    sh = cache.seri.index.router.kernel_shard_buckets(cache.seri.index)
    assert sh.bounds.tolist() == sh.bounds_dev.tolist() == [0, 32, 64]


@pytest.mark.parametrize("name", ["run_once", "run_federated"])
def test_entry_points_take_every_reference_argument(name):
    """The port's serving entry points take every argument of the
    reference's, with the same defaults, plus ``backend`` and ``device``
    (defaulting to the CUDA kernels)."""
    import inspect

    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve

    ref = inspect.signature(getattr(ref_serve, name)).parameters
    port = inspect.signature(getattr(port_serve, name)).parameters
    assert {k: p.default for k, p in ref.items()} == \
        {k: p.default for k, p in port.items()
         if k not in ("backend", "device")}
    assert (port["backend"].default, port["device"].default) == \
        ("kernel", "cuda")


# the reference modules the later slices ported, of which the port keeps
# its own copies: freshness, robustness, telemetry export and federation;
# then the MoE mixer and the ten assigned configs
ASSIGNED_CONFIGS = ("deepseek_v2_236b", "deepseek_v3_671b", "gemma3_12b",
                    "granite_3_8b", "jamba_1_5_large_398b", "qwen1_5_110b",
                    "qwen2_vl_7b", "seamless_m4t_large_v2", "xlstm_350m",
                    "yi_34b")
EXAMPLES = ("quickstart", "serve_cortex", "multi_region", "colocated_serving",
            "train_lm", "multi_pod_dryrun")
PORTED_MODULES = ("obs.export", "obs.analyze", "obs.slo", "core.freshness",
                  "serving.faults", "serving.overload", "serving.federation",
                  "nn.moe", "nn.ssm", "nn.xlstm", "nn.runtime",
                  *(f"configs.{c}" for c in ASSIGNED_CONFIGS),
                  *(f"examples.{e}" for e in EXAMPLES))


def test_port_keeps_its_own_copies_of_the_ported_modules():
    """Importing the port's copy of every module of the freshness,
    robustness, telemetry-export and federation slice, of the MoE, Mamba
    and xLSTM mixers, of the counted loop, of the assigned configs and of
    the six examples loads none of ``repro.obs.*``,
    ``repro.core.freshness``, ``repro.serving.{faults,overload,
    federation}``, ``repro.nn.{moe,ssm,xlstm,runtime}`` or
    ``repro.configs.*`` (nor JAX)."""
    for mod in PORTED_MODULES:
        assert (ROOT / "src" / "repro_torch" / (mod.replace(".", "/")
                                                + ".py")).is_file(), mod
    code = ("import sys, importlib; "
            f"[importlib.import_module('repro_torch.' + m) for m in "
            f"{PORTED_MODULES!r}]; "
            "import repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for path in PORT_FILES:
        bad = [m for m in _imports(path) if m and any(
            m == f"repro.{p}" or m.startswith(f"repro.{p}.")
            for p in ("obs", *PORTED_MODULES))]
        assert not bad, f"{path} imports {bad}"


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


HEADERS = {"ann_topk": ("dot.cuh", "select.cuh"),
           "ann_topk_quant": ("dot.cuh", "select.cuh"),
           "ann_topk_ivf": ("dot.cuh", "select.cuh"),
           "flash_attention": ("attention.cuh",),
           "decode_attention": ("attention.cuh",)}


def test_every_kernel_source_is_built_and_hashed_with_its_headers():
    """build.SOURCES names every csrc/*.cu, each includes the shared
    headers of its family (the stage-1 scans, the attention kernels), and
    a library's name changes with the headers."""
    assert sorted(build.SOURCES) == sorted(
        p.stem for p in build.CSRC.glob("*.cu")) == sorted(HEADERS)
    assert {h for hs in HEADERS.values() for h in hs} == {
        p.name for p in build.CSRC.glob("*.cuh")}
    for name in build.SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        for header in HEADERS[name]:
            assert f'#include "{header}"' in text, (name, header)
    paths = {n: build.library_path(n) for n in build.SOURCES}
    assert len(set(paths.values())) == len(paths)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """Kernels 6 and 7 return tensors without a grad_fn on the card, so
    with grad mode on both wrappers refuse inputs that require grad,
    naming the differentiable path (``nn/flash.flash_attention``); under
    no_grad they run."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 1, 2, 16), generator=g).requires_grad_()
    k, v = (torch.randn((1, 8, 1, 16), generator=g) for _ in range(2))
    with pytest.raises(RuntimeError, match="nn/flash.flash_attention"):
        flash_attention_fwd(q, k, v, scale=0.25)
    with pytest.raises(RuntimeError, match="nn/flash.flash_attention"):
        decode_attention(q[:, 0], k, v, 7, scale=0.25)
    with torch.no_grad():
        flash_attention_fwd(q, k, v, scale=0.25)
        decode_attention(q[:, 0], k, v, 7, scale=0.25)


def _flags(main, capsys) -> set:
    import re

    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", capsys.readouterr().out))


def test_train_main_takes_every_reference_flag(capsys):
    """``launch.train.main`` takes every flag of the reference's, plus
    ``--device`` (defaulting to cuda)."""
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main, parse_args

    ref, port = _flags(ref_main, capsys), _flags(main, capsys)
    assert "--fail-at" in ref and ref <= port
    assert port - ref == {"--device"}
    assert parse_args([]).device == "cuda"
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            main(["--smoke", "--steps", "1"])
    finally:
        monkey.undo()


TRAIN_MODULES = ("nn.flash", "nn.xent", "train.tree", "train.optim",
                 "train.compression", "train.quant_opt", "train.data",
                 "train.checkpoint", "train.supervisor", "launch.steps",
                 "launch.train")


def test_training_modules_load_no_jax():
    """The training slice's modules import neither JAX, ml_dtypes nor the
    reference (bf16 checkpoints read back through a torch uint16 view)."""
    code = ("import sys, importlib; "
            f"[importlib.import_module('repro_torch.' + m) for m in "
            f"{TRAIN_MODULES!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# the launch and dry-run layer (ROADMAP slice 12), the sharding under it,
# the pipeline and the trainer that runs over a mesh
SHARDING_MODULES = ("nn.sharding", "launch.mesh", "launch.costs",
                    "launch.roofline", "launch.dryrun", "launch.report",
                    "launch.steps", "nn.pipeline", "launch.train")


def test_sharding_and_dryrun_modules_load_no_jax():
    """The port's copies of the reference's sharding, mesh, roofline,
    dry-run and report modules (and the cost counter that replaces XLA's
    analyses) load neither JAX nor the reference, and importing them
    touches no process group; ``resolve_device`` still refuses ``meta``,
    which only the dry run, outside it, uses."""
    for mod in SHARDING_MODULES:
        assert (ROOT / "src" / "repro_torch" / (mod.replace(".", "/")
                                                + ".py")).is_file(), mod
    code = ("import sys, importlib; "
            f"[importlib.import_module('repro_torch.' + m) for m in "
            f"{SHARDING_MODULES!r}]; "
            "import torch.distributed as dist; "
            "assert not dist.is_initialized(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    with pytest.raises(ValueError):
        resolve_device("meta")

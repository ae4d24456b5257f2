"""The port's launch and dry-run layer against the reference's: input
stand-ins, collective pricing, roofline terms, report tables, and the dry
run itself on a fake process group (shrunk configs; about 25 s of tier-1,
most of it the reference's compile in a subprocess)."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro.configs import common as ref_common
from repro.configs import get_config as ref_get_config
from repro.launch import report as ref_report
from repro.launch.roofline import parse_collectives
from repro.nn.config import SHAPES as REF_SHAPES
from repro_torch.configs import ASSIGNED, get_config, input_layout, shrink
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import report
from repro_torch.launch.roofline import (Roofline, collective_stats,
                                         wire_bytes)
from repro_torch.nn.config import SHAPES, ShapeCell

ROOT = Path(__file__).resolve().parents[1]
# the keys of the reference's dry-run record (launch/dryrun.py run_cell)
REF_KEYS = ("arch", "shape", "mesh", "status", "t_lower_s", "t_compile_s",
            "arg_bytes", "out_bytes", "temp_bytes", "alias_bytes",
            "hbm_per_device", "fits_hbm", "flops_per_device",
            "bytes_per_device", "wire_bytes_per_device", "raw_flops_rolled",
            "coll_by_op", "coll_counts", "t_compute", "t_memory",
            "t_collective", "bottleneck", "model_flops",
            "useful_flops_ratio", "mfu")


class StubMesh:
    def __init__(self, shape):
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        self.shape = dict(zip(names, shape))
        self.axis_names = names


@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 32, 8)])
@pytest.mark.parametrize("name", ASSIGNED)
def test_input_specs_match_reference(name, mesh_shape, monkeypatch):
    """Every input of every workload cell: the reference's shape, dtype
    and pspec (its ``NamedSharding`` read back through a stand-in)."""
    monkeypatch.setattr(ref_common, "NamedSharding", lambda m, ps: ps)
    monkeypatch.setattr(ref_common, "jax", types.SimpleNamespace(
        ShapeDtypeStruct=lambda shape, dtype, sharding=None:
        (shape, dtype, sharding)))
    mesh = StubMesh(mesh_shape)
    cfg, ref_cfg = get_config(name), ref_get_config(name)
    for shape in SHAPES:
        want = ref_common.input_specs(ref_cfg, REF_SHAPES[shape], mesh)
        got = input_layout(cfg, SHAPES[shape], mesh)
        assert set(got) == set(want), (name, shape)
        for k, (shp, dt, ps) in got.items():
            rshp, rdt, rps = want[k]
            assert shp == tuple(rshp), (name, shape, k)
            assert str(dt).split(".")[-1] == str(rdt.dtype if hasattr(
                rdt, "dtype") else rdt).split(".")[-1].replace(
                "bool_", "bool").replace("'>", ""), (k, dt, rdt)
            assert ps == tuple(rps), (name, shape, k, ps, rps)


HLO = """
  %ar = bf16[8,4096,4096]{2,1,0} all-reduce(bf16[8,4096,4096]{2,1,0} %x), replica_groups=[32,8]<=[256], to_apply=%sum
  %ag = bf16[4096,1600]{1,0} all-gather(bf16[128,1600]{1,0} %w), replica_groups=[8,32]<=[256], dimensions={0}
  %rs = bf16[128,1600]{1,0} reduce-scatter(bf16[4096,1600]{1,0} %g), replica_groups=[8,32]<=[256], dimensions={0}
  %rs2 = f32[64,128]{1,0} reduce-scatter(f32[512,128]{1,0} %h), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %a2a = bf16[16,512]{1,0} all-to-all(bf16[16,512]{1,0} %t), replica_groups=[32,8]<=[256], dimensions={0}
"""
RECORDS = [("all_reduce", 8 * 4096 * 4096 * 2, "g_model"),
           ("all_gather_into_tensor", 4096 * 1600 * 2, "g_data"),
           ("reduce_scatter_tensor", 128 * 1600 * 2, "g_data"),
           ("reduce_scatter_tensor", 64 * 128 * 4, "g_model"),
           ("all_to_all_single", 16 * 512 * 2, "g_model")]
GROUPS = {"g_model": ("model", 8), "g_data": ("data", 32)}


def test_collective_stats_match_parse_collectives():
    """The same five collectives as the dry run records them and as a
    hand-written HLO snippet has them: the reference's wire bytes, per-op
    bytes and counts; the port adds each axis's share."""
    want = parse_collectives(HLO, 256)
    got = collective_stats(RECORDS, GROUPS)
    assert got.counts == want.counts
    assert got.by_op == pytest.approx(want.by_op, rel=1e-12)
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)
    assert sum(got.wire_by_axis.values()) == pytest.approx(got.wire_bytes)
    assert got.wire_by_axis["data"] == pytest.approx(
        wire_bytes("all-gather", 4096 * 1600 * 2, 32)
        + wire_bytes("reduce-scatter", 128 * 1600 * 2, 32))


def test_roofline_terms_at_h100_constants():
    hw = mesh_mod.HW
    assert (hw["peak_flops_bf16"], hw["hbm_bw"], hw["nvlink_bw"],
            hw["ib_bw"], hw["hbm_bytes"]) == (989e12, 3.35e12, 450e9,
                                              50e9, 80e9)
    rl = Roofline(flops=989e12 * 0.010, bytes_accessed=3.35e12 * 0.004,
                  wire_bytes=3e9, n_devices=256, model_flops=1e15,
                  wire_by_axis={"model": 2e9, "data": 1e9})
    assert rl.t_compute == pytest.approx(0.010)
    assert rl.t_memory == pytest.approx(0.004)
    assert rl.t_collective == pytest.approx(2e9 / 450e9 + 1e9 / 50e9)
    assert rl.bottleneck == "collective"
    assert rl.step_time == pytest.approx(rl.t_collective)
    assert rl.useful_flops_ratio == pytest.approx(1e15 / (rl.flops * 256))
    assert rl.mfu == pytest.approx(1e15 / (rl.step_time * 989e12 * 256))
    assert Roofline(1, 1, 450e9, 1, 1).t_collective == pytest.approx(1.0)


def _records() -> list[dict]:
    base = {k: 0 for k in REF_KEYS}
    out = []
    for i, (arch, shape, mesh, status) in enumerate([
            ("yi-34b", "train_4k", "16x16", "OK"),
            ("yi-34b", "train_4k", "2x16x16", "OK"),
            ("granite-3-8b", "decode_32k", "16x16", "OK"),
            ("granite-3-8b", "long_500k", "16x16", "SKIP"),
            ("jamba-1.5-large-398b", "prefill_32k", "16x16", "FAIL")]):
        r = dict(base, arch=arch, shape=shape, mesh=mesh, status=status,
                 hbm_per_device=(i + 1) * 3.3e9, fits_hbm=i % 2 == 0,
                 t_compile_s=1.5 * i, t_compute=0.01 * (i + 1),
                 t_memory=0.02, t_collective=0.004 * i,
                 bottleneck=["compute", "memory", "collective"][i % 3],
                 useful_flops_ratio=0.5 + 0.1 * i, mfu=0.1 * i,
                 wire_bytes_per_device=2.0**31 * i,
                 coll_by_op={"all-reduce": 2.0**30 * i,
                             "all-gather": 2.0**29})
        if status == "SKIP":
            r["reason"] = "full-attention arch: long_500k skipped"
        if status == "FAIL":
            r["error"] = "RuntimeError: boom"
        out.append(r)
    return out


@pytest.mark.parametrize("table", ["dryrun_table", "roofline_table",
                                   "collective_detail", "summarize"])
def test_report_tables_byte_for_byte(table):
    recs = _records()
    assert getattr(report, table)(recs) == getattr(ref_report, table)(recs)


def _shrunk(name: str):
    return dataclasses.replace(
        shrink(get_config(name), d_model=64, vocab=128, n_repeat=2,
               seq_chunk=4))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", ["granite-3-8b", "deepseek-v3-671b"])
def test_run_cell_on_the_fake_group(name, shape):
    """A shrunk config's cell on the (32, 8) production mesh, one fake
    process standing for 256: OK, every key of the reference's record,
    the per-device counts positive, the collectives on the mesh's axes."""
    from repro_torch.launch import dryrun

    cell = ShapeCell(shape, 16, 256, SHAPES[shape].kind)
    rec = dryrun.run_cell(name, shape, False, verbose=False,
                          cfg=_shrunk(name), cell=cell)
    assert rec["status"] == "OK"
    assert rec["mesh"] == "32x8"
    assert set(REF_KEYS) <= set(rec)
    assert rec["arg_bytes"] > 0 and rec["hbm_per_device"] > 0
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert set(rec["wire_by_axis"]) <= {"data", "model"}
    assert rec["fits_hbm"]
    if SHAPES[shape].kind == "train":
        assert rec["alias_bytes"] > 0
    json.dumps(rec)


def test_long_500k_skips_full_attention():
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("granite-3-8b", "long_500k", False, verbose=False)
    assert rec["status"] == "SKIP" and "long_500k" in rec["reason"]


_REF_ARG_BYTES = """
import dataclasses, json, sys
sys.path.insert(0, {src!r})
from repro.launch import dryrun as d      # sets 512 host devices
import jax
from jax.sharding import AxisType
from repro.configs import get_config, shrink
from repro.nn.config import SHAPES, ShapeCell
SHAPES["train_4k"] = ShapeCell("train_4k", 64, 16, "train")
cfg = shrink(get_config("granite-3-8b"), d_model=64, vocab=128, n_repeat=2,
             seq_chunk=4)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
fn, args, donate = d.build_lowerable("granite-3-8b", "train_4k", mesh,
                                     cfg=cfg, force_mb1=True)
with mesh:
    c = jax.jit(fn, donate_argnums=donate).lower(*args).compile()
print(json.dumps(c.memory_analysis().argument_size_in_bytes))
"""


@pytest.mark.timeout(240)
def test_arg_bytes_equal_reference_compile():
    """The dry run's per-device argument bytes (parameters, AdamW state,
    batch) equal the bytes XLA's compile of the reference's step takes as
    arguments, on the same (2, 4) mesh of 8 host devices (the reference
    in a subprocess, as tests/test_pipeline.py runs it)."""
    from repro_torch.launch import dryrun

    code = _REF_ARG_BYTES.format(src=str(ROOT / "src"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=230)
    assert run.returncode == 0, run.stderr[-3000:]
    want = json.loads(run.stdout.strip().splitlines()[-1])
    rec = dryrun.run_cell("granite-3-8b", "train_4k", False, verbose=False,
                          mesh_shape=(2, 4), cfg=_shrunk("granite-3-8b"),
                          cell=ShapeCell("train_4k", 64, 16, "train"),
                          microbatches=1)
    assert rec["arg_bytes"] == want


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """The dry run makes a fake default process group; this file's last
    test leaves none behind for the next file on the worker."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    torch.manual_seed(0)

"""The dry run's train cells counted as the reference counts them: from
the step at (depth, microbatches) (n, μ) ∈ {1, 2}², extrapolated
bilinearly (``launch/dryrun.extrapolated_metrics``), against one count of
the whole step (``run_cell(..., full=True)``).

Each case is a cut train cell (64 tokens, batch 24: 12 rows a data rank,
which 1, 2, 3 and 4 microbatches split) of a config shrunk as
``tests/test_torch_dryrun.py`` shrinks them, at 3 superblocks, on a fake
(2, 4) production mesh. jamba's 8-layer superblock is cut to its layers 3
and 4 (Mamba with MoE, attention with a dense FFN) and xlstm's to its last
two (mLSTM, sLSTM), so that the whole counts stay short. Every count of
the record is held exactly: FLOPs, bytes, the collectives' wire bytes, by
op, counts and by mesh axis, the temporary bytes (the peak) and the HBM a
device needs.

The cases run in two fresh processes at once (:data:`GROUPS`), one
thread each, each on a fake process group of its own: DTensor caches
shardings by meshes that compare equal across process groups, so a dry
run after another file destroyed its group could read that group's names.
About 55 s, 100 s of CPU.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config, shrink
from repro_torch.launch import dryrun
from repro_torch.nn.config import ShapeCell

ROOT = Path(__file__).resolve().parents[1]
CELL = ShapeCell("train_4k", 64, 24, "train")
EXACT = ("flops_per_device", "bytes_per_device", "wire_bytes_per_device",
         "raw_flops_rolled", "coll_by_op", "coll_counts", "wire_by_axis",
         "arg_bytes", "out_bytes", "alias_bytes", "temp_bytes",
         "hbm_per_device", "fits_hbm", "t_compute", "t_memory",
         "t_collective", "bottleneck", "useful_flops_ratio", "mfu")
# the superblock's layers each case keeps
BLOCKS = {"jamba-1.5-large-398b": slice(3, 5), "xlstm-350m": slice(6, 8)}
# (arch, microbatches, remat) of each cut cell
CELLS = {"granite-mu1": ("granite-3-8b", 1, "full"),
         "granite-mu3": ("granite-3-8b", 3, "none"),
         "granite-mu4": ("granite-3-8b", 4, "none"),
         "deepseek-v2-mu2": ("deepseek-v2-236b", 2, "none"),
         "jamba-mu3": ("jamba-1.5-large-398b", 3, "none"),
         "xlstm-mu1": ("xlstm-350m", 1, "full")}
# the MoE configs in one process, the others in the other
GROUPS = (("deepseek-v2-mu2", "jamba-mu3", "fsdp"),
          ("granite-mu1", "granite-mu3", "granite-mu4", "xlstm-mu1", "phase"))
CHILD = """
import json, logging, sys
sys.path[:0] = [{src!r}, {tests!r}]
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
import torch
torch.set_num_threads(1)
import test_torch_dryrun_extrapolate as t
print(json.dumps({{name: t.RUN[name]() for name in {names!r}}}))
"""


def _cut(name: str, n: int = 3):
    cfg = shrink(get_config(name), d_model=64, vocab=128, n_repeat=n,
                 seq_chunk=4)
    if name in BLOCKS:
        cfg = dataclasses.replace(cfg, blocks=cfg.blocks[BLOCKS[name]])
    return cfg


def _pair(arch: str, microbatches, remat: str = "full", **kw) -> dict:
    """The extrapolated record and the full count's, their EXACT keys."""
    kw = dict(dict(verbose=False, mesh_shape=(2, 4), cfg=_cut(arch),
                   cell=CELL, microbatches=microbatches, remat=remat), **kw)
    got = dryrun.run_cell(arch, "train_4k", False, **kw)
    want = dryrun.run_cell(arch, "train_4k", False, full=True, **kw)
    assert got["status"] == want["status"] == "OK"
    return {"got": {k: got[k] for k in EXACT},
            "want": {k: want[k] for k in EXACT}}


def _spied_pair(*args, **kw) -> tuple[dict, list]:
    """:func:`_pair`, and ``(build, mesh, microbatches, counts)`` of each
    count behind its extrapolated record, the variants at depths 1 and 2
    (the full count's runs every microbatch and is left out)."""
    seen = []
    count = dryrun._count

    def spy(build, mesh, microbatches=None):
        m = count(build, mesh, microbatches)
        seen.append((build, mesh, microbatches, m))
        return m

    dryrun._count = spy
    try:
        out = _pair(*args, **kw)
    finally:
        dryrun._count = count
    return out, [s for s in seen if s[2] is not None]


def _with_variants(arch: str, microbatches, remat: str) -> dict:
    """:func:`_pair`, and the counts behind its extrapolated record: the
    microbatches each ran, its depth, the plan's microbatches it kept; the
    count at one microbatch read off each against a count that runs one;
    and the live bytes that the second microbatch adds and the third."""
    out, seen = _spied_pair(arch, microbatches, remat)
    read = []
    for build, mesh, _, two in seen:
        one = dryrun._count(build, mesh, 1)
        first = dryrun._first_microbatch(two, mesh)
        read.append({"equal": [k for k in ("flops", "bytes", "wire",
                                            "by_op", "counts", "by_axis")
                               if first[k] == one[k]],
                     "collectives": [len(two["colls"]), len(one["colls"])]})
    build, mesh, _, two = seen[0]
    return {**out, "variants": {
        "seen": [s[2] for s in seen],
        "depths": [s[0].keywords["cfg"].n_repeat for s in seen],
        "force_mb": sorted({s[0].keywords["force_mb"] for s in seen}),
        "read": read,
        "shifts": [two["shift"], dryrun._count(build, mesh, 3)["shift"]]}}


def _fsdp() -> dict:
    """Under ``REPRO_TRAIN_PLAN=fsdp`` (the plan's μ 1)."""
    plan = dryrun.TRAIN_PLAN_ENV
    dryrun.TRAIN_PLAN_ENV = "fsdp"
    try:
        return {"mu": dryrun.train_microbatches("granite-3-8b"),
                **_pair("granite-3-8b", None)}
    finally:
        dryrun.TRAIN_PLAN_ENV = plan


def _phase() -> dict:
    """A peak that changes phase with depth (see its test), and the
    line through the whole peaks at depths 1 and 2."""
    cfg = shrink(get_config("granite-3-8b"), d_model=256, vocab=2048,
                 n_repeat=4, seq_chunk=4)
    cfg = dataclasses.replace(cfg, blocks=tuple(
        dataclasses.replace(spec, d_ff=4096) for spec in cfg.blocks))
    cell = ShapeCell("train_4k", 16, 2, "train")
    out, seen = _spied_pair("granite-3-8b", 2, "none", mesh_shape=(1, 1),
                            cfg=cfg, cell=cell)
    peaks = [m["peak"] for *_, m in seen]
    return {**out, "line": peaks[0] + 3 * (peaks[1] - peaks[0])}


RUN = {**{name: functools.partial(_pair, *cell)
          for name, cell in CELLS.items()},
       "granite-mu4": functools.partial(_with_variants, *CELLS["granite-mu4"]),
       "fsdp": _fsdp, "phase": _phase}


@pytest.fixture(scope="module")
def results() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD.format(
            src=str(ROOT / "src"), tests=str(ROOT / "tests"),
            names=list(names))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for names in GROUPS]
    out = {}
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            out.update(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _assert_equal(pair: dict) -> None:
    got, want = pair["got"], pair["want"]
    for key in EXACT:
        assert got[key] == want[key], key
        assert json.dumps(got[key]) == json.dumps(want[key]), key


@pytest.mark.parametrize("case", list(CELLS))
def test_extrapolated_equals_the_full_count(case, results):
    """n 3 at μ 1, 3 and 4 (granite), with a prefix layer, MLA and MoE
    (deepseek-v2), Mamba, MoE and attention (jamba), mLSTM and sLSTM
    (xlstm): every count of the record the full count's, the JSON too."""
    pair = results[case]
    _assert_equal(pair)
    got = pair["got"]
    assert got["flops_per_device"] > 0 and got["temp_bytes"] > 0
    assert got["coll_counts"] and set(got["wire_by_axis"]) <= {"data",
                                                               "model"}


def test_peak_that_changes_phase_with_depth(results):
    """A cut cell whose peak at depths 1 and 2 is set by the head (a
    2048-token vocabulary) and at depth 3 and more by the backward's
    gradients (FFNs of 4096 on d_model 256, 32 tokens), one train (d)-like
    rank ((1, 1), 2 microbatches, no remat): the largest of the segments'
    peaks, each affine in depth, is the full count's at depth 4, where
    the whole peak's line through depths 1 and 2 falls short."""
    pair = results["phase"]
    _assert_equal(pair)
    assert pair["line"] < pair["want"]["temp_bytes"]


def test_fsdp_plan_has_one_microbatch(results):
    """Under ``REPRO_TRAIN_PLAN=fsdp`` the plan's μ is 1 (the batch shards
    over all chips): the variants collapse to depths 1 and 2, and the
    record is the full count's."""
    pair = results["fsdp"]
    assert pair["mu"] == 1
    _assert_equal(pair)
    assert set(pair["got"]["wire_by_axis"]) <= {"data", "model",
                                                "data+model"}


def test_variants_count_two_microbatches_at_depths_1_and_2(results):
    """The counts behind the record at μ 4: depths 1 and 2 of the cut
    config, each running the first two of its 4 microbatches; the counts
    at one microbatch read off each of them equal a count that runs one;
    and the second microbatch adds live bytes (the loss's running sum)
    where the third adds none, as ``dryrun._peak`` assumes."""
    v = results["granite-mu4"]["variants"]
    assert v["seen"] == [2, 2]
    assert v["depths"] == [1, 2]
    assert v["force_mb"] == [4]
    for read in v["read"]:
        assert read["equal"] == ["flops", "bytes", "wire", "by_op", "counts",
                                 "by_axis"]
        assert read["collectives"][0] > read["collectives"][1] > 0
    assert v["shifts"][0] > 0 and v["shifts"][1] == 0

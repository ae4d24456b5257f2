"""Dry run: every (architecture × input shape) as a DTensor program on the
production mesh, on a fake process group and ``meta`` tensors (shapes
only, nothing allocated), with per-device memory, FLOPs, bytes and
collectives from the cost counter (``launch/costs``) and the roofline
terms at H100 datasheet constants (``launch/mesh.HW``). The port of the
reference's ``launch/dryrun.py``; the numbers are estimates, not
measurements.

The reference lowers and compiles each cell with XLA and reads its
``cost_analysis``, which counts a while loop's body once; it therefore
compiled unrolled variants at depths 1 and 2 and extrapolated
(``extrapolated_metrics``, ``nn/runtime.UNROLL``). The port runs each cell
once, at its full depth, and counts every layer; a loop of same-shaped
trips written with ``nn/runtime.scan`` (sLSTM's time steps, the mLSTM and
Mamba chunks) runs two trips under the counter and is counted as all of
them, unless autograd records it (a train cell runs every trip).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod-only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, get_config, input_specs
from repro_torch.launch.costs import CostMode
from repro_torch.launch.mesh import (HW, MULTI, SINGLE, make_production_mesh,
                                     mesh_name)
from repro_torch.launch.roofline import (Roofline, active_params,
                                         collective_stats, model_flops)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.lm import LM
from repro_torch.nn.config import SHAPES, ModelConfig, ShapeCell
from repro_torch.nn.param import struct_tree
from repro_torch.nn.sharding import ShardingConfig, param_pspec
from repro_torch.train.optim import AdamWConfig, state_specs

KV_QUANT = os.environ.get("REPRO_KV_QUANT", "0") == "1"
TRAIN_PLAN_ENV = os.environ.get("REPRO_TRAIN_PLAN", "")  # "" | "fsdp"

PAPER_HEADS = {"yi-34b": 56, "qwen2-vl-7b": 28}

# Per-arch training memory plan: (microbatches, optimizer-state dtype,
# grad-accumulation dtype). μ trades activation memory for ×μ FSDP
# all-gathers; bf16 states halve optimizer memory at the 100B+ scale.
TRAIN_PLAN = {
    "default": (4, "float32", torch.float32),
    "jamba-1.5-large-398b": (8, "bfloat16", torch.bfloat16),
    "qwen1.5-110b": (8, "bfloat16", torch.bfloat16),
    "deepseek-v2-236b": (8, "bfloat16", torch.bfloat16),
    "deepseek-v3-671b": (8, "bfloat16", torch.bfloat16),
    "yi-34b": (8, "float32", torch.float32),
    "xlstm-350m": (1, "float32", torch.float32),
    "seamless-m4t-large-v2": (1, "float32", torch.float32),
}


def train_plan(arch: str):
    mb, sdt, accum = TRAIN_PLAN.get(arch, TRAIN_PLAN["default"])
    return AdamWConfig(state_dtype=sdt), mb, accum


def skip_reason(cfg: ModelConfig, cell: ShapeCell) -> str | None:
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: long_500k skipped (DESIGN.md §4)"
    return None


def _structs(mesh, spec_tree, shard_cfg: ShardingConfig | None = None):
    shard_cfg = shard_cfg or ShardingConfig()
    return struct_tree(spec_tree, mesh,
                       lambda s: param_pspec(mesh, s, shard_cfg))


def serve_shard_cfg(cfg: ModelConfig, mesh) -> ShardingConfig:
    """Serving parallelism plan: ZeRO-style param sharding over the data
    axis is a *training* memory optimization — at serve time it turns
    every step into a full-weight all-gather. When the TP-sharded weights
    fit an 8 GiB-per-device budget, disable FSDP so weights replicate
    across data (zero per-step weight traffic); only the 100B+ models
    keep FSDP at serve time."""
    _, total = active_params(cfg)
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    per_dev = total * 2 / tp  # bf16
    return ShardingConfig(enable_fsdp=per_dev > 8 * 2**30)


def _with_repeat(cfg: ModelConfig, n: int) -> ModelConfig:
    """Depth-n variant of a config (the reference extrapolated metrics
    from depths 1 and 2; here the depth of a cut-down cell)."""
    return dataclasses.replace(
        cfg,
        n_repeat=n,
        enc_repeat=n if cfg.enc_repeat else 0,
    )


def build_lowerable(arch: str, shape: str, mesh, cfg: ModelConfig = None,
                    force_mb1: bool = False, force_mb: int | None = None,
                    cell: ShapeCell | None = None, remat: str = "full"):
    """Returns ``(step, args, donate)``: the step, its DTensor stand-ins
    (``meta`` shards) and the indices of the arguments it updates in
    place (the reference's donated arguments)."""
    cfg = cfg or get_config(arch)
    cell = cell or SHAPES[shape]
    lm = LM(cfg)
    batch = input_specs(cfg, cell, mesh)

    if cell.kind == "train":
        opt_cfg, mb, accum = train_plan(arch)
        shard_cfg = None
        if TRAIN_PLAN_ENV == "fsdp":
            shard_cfg = ShardingConfig.fsdp_only()
            mb = 1  # batch shards over all chips; no accumulation needed
        elif TRAIN_PLAN_ENV == "fsdp_hybrid":
            shard_cfg = ShardingConfig.fsdp_hybrid()
        if force_mb is not None:
            mb = force_mb
        elif force_mb1:
            mb = 1
        pspecs = lm.param_specs()
        params = _structs(mesh, pspecs, shard_cfg)
        opt = _structs(mesh, state_specs(opt_cfg, pspecs), shard_cfg)
        step = make_train_step(cfg, opt_cfg, remat=remat, microbatches=mb,
                               accum_dtype=accum, donate=True, mesh=mesh,
                               shard_cfg=shard_cfg)
        return step, (params, opt, batch), (0, 1)
    scfg = serve_shard_cfg(cfg, mesh)
    params = _structs(mesh, lm.param_specs(), scfg)
    if cell.kind == "prefill":
        return make_prefill_step(cfg, mesh), (params, batch), ()
    caches = _structs(
        mesh,
        lm.cache_specs(cell.global_batch, cell.seq_len,
                       enc_len=cell.seq_len if cfg.enc_dec else 0,
                       kv_quant=KV_QUANT),
        scfg,
    )
    # the reference's pos is a traced scalar (every cache row in play); a
    # host int here, the last row
    pos = cell.seq_len - 1
    step = make_decode_step(cfg, mesh)
    return step, (params, batch["tokens"], caches, pos), (2,)


def _locals(tree) -> list:
    """The local shards of every DTensor (or tensor) leaf of a tree."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    return [x._local_tensor if isinstance(x, DTensor) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _group_axes(mesh, names) -> dict:
    """``{process group name: (mesh axes, size)}`` of the groups in
    ``names``: one mesh axis's group, or a group over several axes at once
    (DTensor flattens two axes for one collective), named by the axes its
    ranks differ on, joined with "+"."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    coords = {int(r): c for c, r in zip(
        torch.cartesian_prod(*(torch.arange(n) for n in mesh.shape))
        .reshape(-1, mesh.ndim).tolist(), mesh.mesh.flatten().tolist())}
    out = {}
    for name in set(names):
        ranks = dist.get_process_group_ranks(_resolve_process_group(name))
        axes = [a for i, a in enumerate(mesh.mesh_dim_names)
                if len({coords[r][i] for r in ranks}) > 1]
        out[name] = ("+".join(axes), len(ranks))
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             *, mesh_shape=None,
             cfg: ModelConfig | None = None, cell: ShapeCell | None = None,
             microbatches: int | None = None, remat: str = "full"):
    """One cell's record (the reference's ``metrics`` switch, for its
    extrapolated metrics, has no counterpart: every cell's counts are
    exact). ``mesh_shape``, ``cfg``, ``cell``, ``microbatches``
    and ``remat`` replace the production mesh, the registered config, the
    workload shape, the train plan's microbatches and the full remat, to
    dry-run a cut-down cell (e.g. one a single card trains)."""
    cfg = cfg or get_config(arch)
    cell = cell or SHAPES[shape]
    reason = skip_reason(cfg, cell)
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    rec = {"arch": arch, "shape": shape,
           "mesh": mesh_name(mesh.shape)}
    if reason:
        rec["status"] = "SKIP"
        rec["reason"] = reason
        return rec

    n_dev = mesh.size()
    t0 = time.time()
    fn, args, donate = build_lowerable(arch, shape, mesh, cfg=cfg,
                                       force_mb=microbatches, cell=cell,
                                       remat=remat)
    t_lower = time.time() - t0
    arg_locals = _locals(args)
    arg_bytes = sum(t.numel() * t.element_size() for t in arg_locals)
    mode = CostMode()
    t1 = time.time()
    with mode:
        out = fn(*args)
    t_run = time.time() - t1
    out_locals = _locals(out)
    donated = {id(t) for i in donate for t in _locals(args[i])}
    out_bytes = sum(t.numel() * t.element_size() for t in out_locals)
    alias_bytes = sum(t.numel() * t.element_size() for t in out_locals
                      if id(t) in donated)
    temp_bytes = max(0, mode.peak - (out_bytes - alias_bytes))
    hbm = arg_bytes + out_bytes + temp_bytes - alias_bytes
    colls = collective_stats(mode.collectives, _group_axes(
        mesh, [g for _, _, g in mode.collectives]))

    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mf = model_flops(cfg, cell.kind, tokens,
                     paper_heads=PAPER_HEADS.get(arch))
    rl = Roofline(flops=mode.flops, bytes_accessed=mode.bytes,
                  wire_bytes=colls.wire_bytes, n_devices=n_dev,
                  model_flops=mf, wire_by_axis=colls.wire_by_axis)
    rec.update(
        status="OK",
        t_lower_s=round(t_lower, 1),
        t_compile_s=round(t_run, 1),
        arg_bytes=arg_bytes,
        out_bytes=out_bytes,
        temp_bytes=temp_bytes,
        alias_bytes=alias_bytes,
        hbm_per_device=hbm,
        fits_hbm=bool(hbm <= HW["hbm_bytes"]),
        flops_per_device=rl.flops,
        bytes_per_device=rl.bytes_accessed,
        wire_bytes_per_device=rl.wire_bytes,
        raw_flops_rolled=rl.flops,
        coll_by_op={k: round(v) for k, v in colls.by_op.items()},
        coll_counts=colls.counts,
        wire_by_axis={k: round(v) for k, v in colls.wire_by_axis.items()},
        t_compute=rl.t_compute,
        t_memory=rl.t_memory,
        t_collective=rl.t_collective,
        bottleneck=rl.bottleneck,
        model_flops=mf,
        useful_flops_ratio=rl.useful_flops_ratio,
        mfu=rl.mfu,
    )
    if verbose:
        print(f"--- {arch} × {shape} × {rec['mesh']} ---")
        print(f"  build {t_lower:.1f}s fake run {t_run:.1f}s")
        print(
            f"  memory/device: args {arg_bytes/2**30:.2f}GiB "
            f"out {out_bytes/2**30:.2f}GiB temp {temp_bytes/2**30:.2f}GiB "
            f"alias {alias_bytes/2**30:.2f}GiB -> {hbm/2**30:.2f}GiB "
            f"({'fits' if rec['fits_hbm'] else 'EXCEEDS'} "
            f"{HW['hbm_bytes']/1e9:.0f} GB HBM)"
        )
        print(
            f"  per-device: {rl.flops/1e12:.2f} TFLOP, "
            f"{rl.bytes_accessed/2**30:.2f} GiB accessed, "
            f"{rl.wire_bytes/2**20:.1f} MiB on wire {colls.counts}"
        )
        print(
            f"  roofline: compute {rl.t_compute*1e3:.2f}ms "
            f"memory {rl.t_memory*1e3:.2f}ms "
            f"collective {rl.t_collective*1e3:.2f}ms "
            f"-> bottleneck={rl.bottleneck} "
            f"useful={rl.useful_flops_ratio:.2f} mfu={rl.mfu:.3f}"
        )
    return rec


def main(argv=None):
    # DTensor warns at each redistribute over two mesh dims at once
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--json", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for arch in ASSIGNED:
            for shape in SHAPES:
                cells.append((arch, shape, False))
                if not args.single_pod_only:
                    cells.append((arch, shape, True))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        cells.append((args.arch, args.shape, args.multi_pod))

    records = []
    failed = []
    for arch, shape, mp in cells:
        try:
            rec = run_cell(arch, shape, mp)
        except Exception as e:  # noqa: BLE001 — report all cell failures
            traceback.print_exc()
            rec = {
                "arch": arch, "shape": shape,
                "mesh": mesh_name((MULTI if mp else SINGLE)[0]),
                "status": "FAIL", "error": f"{type(e).__name__}: {e}",
            }
            failed.append(rec)
        records.append(rec)
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(rec) + "\n")

    ok = sum(1 for r in records if r["status"] == "OK")
    skip = sum(1 for r in records if r["status"] == "SKIP")
    print(f"\n=== dry-run: {ok} OK, {skip} SKIP, {len(failed)} FAIL ===")
    if failed:
        for r in failed:
            print(f"  FAIL {r['arch']} × {r['shape']} × {r['mesh']}: "
                  f"{r['error']}")
        sys.exit(1)
    return records


if __name__ == "__main__":
    main()

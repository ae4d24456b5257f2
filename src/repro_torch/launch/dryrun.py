"""Dry run: every (architecture × input shape) as a DTensor program on the
production mesh, on a fake process group and ``meta`` tensors (shapes
only, nothing allocated), with per-device memory, FLOPs, bytes and
collectives from the cost counter (``launch/costs``) and the roofline
terms at H100 datasheet constants (``launch/mesh.HW``). The port of the
reference's ``launch/dryrun.py``; the numbers are estimates, not
measurements.

The reference lowers and compiles each cell with XLA and reads its
``cost_analysis``, which counts a while loop's body once; it therefore
compiled unrolled variants at (depth, microbatches) (n, μ) ∈ {1, 2}² and
extrapolated bilinearly (``extrapolated_metrics``). The port counts a
train cell the same way, from its step at depths 1 and 2 running two of
the plan's microbatches, the count at one read off each
(:func:`extrapolated_metrics`); the full count's numbers equal them, since
each superblock and each microbatch after the first adds the same ops.
Its peak memory is the largest of the peaks of the step's segments
(between the edges of its layer stacks and microbatches), each affine in
depth. Prefill, decode and long cells run once at full depth. A loop of
same-shaped trips written with ``nn/runtime.scan`` (sLSTM's time steps,
the mLSTM and Mamba chunks) runs a few trips under the counter and is
counted as all of them, forward and backward. ``run_cell(...,
full=True)`` counts a train cell whole, every superblock and microbatch.
``--all`` runs its cells one after another and prints each one's
seconds; to run them in parallel, start a process a cell (one ``--arch A
--shape S --json F_A_S`` each).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod-only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out.json
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, get_config, input_specs
from repro_torch.launch.costs import CostMode, _nbytes
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


def train_microbatches(arch: str, force_mb: int | None = None,
                       rows: int | None = None) -> int:
    """A train cell's microbatches: ``force_mb``, else the plan's (1
    under ``REPRO_TRAIN_PLAN=fsdp``, whose batch shards over all chips),
    at most ``rows``, the rows a data rank holds: on the two-pod mesh's
    64 data ranks a rank holds 4 of ``train_4k``'s 256 rows, where the
    reference's 32 hold the 8 that its plan's 8 microbatches split, and a
    microbatch keeps the plan's one row a rank."""
    if force_mb is not None:
        return force_mb
    mb = 1 if TRAIN_PLAN_ENV == "fsdp" else train_plan(arch)[1]
    return mb if rows is None else max(1, min(mb, rows))


def _rank_rows(batch: dict) -> int:
    """The rows of a step's batch (its stand-ins) that one rank holds."""
    return _locals(batch["tokens"])[0].shape[0]


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
        opt_cfg, _, accum = train_plan(arch)
        shard_cfg = None
        if TRAIN_PLAN_ENV == "fsdp":
            shard_cfg = ShardingConfig.fsdp_only()
        elif TRAIN_PLAN_ENV == "fsdp_hybrid":
            shard_cfg = ShardingConfig.fsdp_hybrid()
        mb = train_microbatches(arch, 1 if force_mb1 and force_mb is None
                                else force_mb, _rank_rows(batch))
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


def _metrics(mesh, flops: float, nbytes: float, colls: list) -> dict:
    """FLOPs, bytes and the collectives' wire bytes, by op, their counts
    and by mesh axis, of a count's ``(op, bytes, group)`` records."""
    stats = collective_stats(colls, _group_axes(mesh,
                                                [g for _, _, g in colls]))
    return {"flops": flops, "bytes": nbytes, "wire": stats.wire_bytes,
            "by_op": stats.by_op, "counts": stats.counts,
            "by_axis": stats.wire_by_axis}


def _count(build, mesh, microbatches: int | None = None) -> dict:
    """One count of a step under a ``CostMode`` (cut to its first
    ``microbatches``), the step and its stand-ins from ``build()``: per
    device, the FLOPs, bytes, peak and
    collectives (:func:`_metrics`, and ``colls`` the records), the last
    microbatch's counts (``trip``, ``CostMode.trip_ends``), the bytes of
    the arguments, of the outputs, of those outputs that are donated
    arguments updated in place, and of the donated arguments; and the
    seconds of the build and of the run."""
    t0 = time.time()
    fn, args, donate = build()
    mode = CostMode(microbatches=microbatches)
    t1 = time.time()
    with mode:
        out = fn(*args)
        mode.boundary("end")
    t_run = time.time() - t1
    out_locals = _locals(out)
    donated = [t for i in donate for t in _locals(args[i])]
    ids = {id(t) for t in donated}
    return {**_metrics(mesh, mode.flops, mode.bytes, mode.collectives),
            "peak": mode.peak, "colls": mode.collectives, "trip": mode.trip,
            "segments": mode.segments, "shift": mode.shift,
            "arg_bytes": sum(_nbytes(t) for t in _locals(args)),
            "out_bytes": sum(_nbytes(t) for t in out_locals),
            "alias_bytes": sum(_nbytes(t) for t in out_locals
                               if id(t) in ids),
            "donated_bytes": sum(_nbytes(t) for t in donated),
            "t_build": t1 - t0, "t_run": t_run}


def _first_microbatch(m: dict, mesh) -> dict:
    """The counts of the step ``m`` counted at two microbatches, at one:
    the second one's FLOPs, bytes and collectives taken away (every op
    outside the microbatch loop is the same at one)."""
    flops, nbytes, (lo, hi) = m["trip"]
    return {**m, **_metrics(mesh, m["flops"] - flops, m["bytes"] - nbytes,
                            m["colls"][:lo] + m["colls"][hi:])}


def _at_depth(cfg: ModelConfig, n: int) -> ModelConfig:
    """``_with_repeat``, an encoder deeper or shallower than the decoder
    kept at its depth."""
    if cfg.enc_repeat in (0, cfg.n_repeat):
        return _with_repeat(cfg, n)
    return dataclasses.replace(_with_repeat(cfg, n),
                               enc_repeat=cfg.enc_repeat)


def _peak(m1: dict, m2: dict, n: int, mu: int) -> int:
    """The peak of the step at depth ``n`` and ``mu`` microbatches from
    its counts at depths 1 and 2 (``m1``, ``m2``), each running two of its
    microbatches (one where ``mu`` is 1): the largest of its segments'
    peaks (``CostMode.boundary``), each affine in depth, since within a
    segment the live bytes rise with the layers of one stack (or not at
    all). A microbatch left out, the third on, starts ``shift`` bytes
    above where the second started (the second adds them: in
    ``make_train_step`` the loss's running sum, 4 bytes) and climbs as the
    second did. That holds only while every microbatch after the second
    leaves the live bytes as it found them, so that the rest and the tail
    start where the second ends: ``make_train_step``'s do, and
    ``tests/test_torch_dryrun_extrapolate.py`` holds the third's shift at
    0 and the peak at μ 3 and 4 to the full count's. A change to the
    accumulation loop that makes later microbatches keep more must change
    this rule."""
    keys = [k for k, _ in m1["segments"]]
    if keys != [k for k, _ in m2["segments"]]:
        raise RuntimeError("depths 1 and 2 of the step have other segments")
    shift = m1["shift"] + (n - 1) * (m2["shift"] - m1["shift"])
    peak = 0
    for (key, p1), (_, p2) in zip(m1["segments"], m2["segments"]):
        p = p1 + (n - 1) * (p2 - p1)
        peak = max(peak, p, p + shift if mu > 2 and key[1] == 1 else 0)
    return peak


def extrapolated_metrics(arch: str, shape: str, mesh, cfg: ModelConfig,
                         cell: ShapeCell, microbatches: int | None = None,
                         remat: str = "full") -> dict:
    """A train cell's per-device counts from its step at (n, μ) ∈ {1,2}²,
    extrapolated bilinearly to the cell's depth N (``cfg.n_repeat``; the
    prefix layers run in every variant) and microbatches M, as the
    reference's ``extrapolated_metrics`` does:

        m(N, M) = m11 + (N−1)Δn + (M−1)Δμ + (N−1)(M−1)Δnμ

    A variant at μ runs the first μ of the step's M microbatches (``CostMode
    (microbatches=μ)``), each of the plan's rows, so that each microbatch
    after the first adds the same ops as in the whole step: the
    reference's variants, at the global batch over μ, would change the
    rows of each and an MoE layer's capacity with them. The step is
    counted at μ 2, and its count at μ 1 read off that count, the second
    microbatch's counts taken away (:func:`_first_microbatch`). FLOPs,
    bytes and the collectives' wire bytes, by op, counts and by axis
    extrapolate so; with M = 1 or N = 1 the variants collapse. The peak
    comes from the same two counts (:func:`_peak`), segment by segment.
    Every donated argument must come back updated in place; the bytes out
    beside them are depth 1's."""
    n = cfg.n_repeat
    mu = train_microbatches(arch, microbatches,
                            _rank_rows(input_specs(cfg, cell, mesh)))

    def count(depth: int, mb: int) -> dict:
        return _count(functools.partial(
            build_lowerable, arch, shape, mesh, cfg=_at_depth(cfg, depth),
            force_mb=mu, cell=cell, remat=remat), mesh, microbatches=mb)

    if mu > 1:
        m12 = count(1, 2)
        m22 = count(2, 2) if n > 1 else m12
        m11, m21 = (_first_microbatch(m, mesh) for m in (m12, m22))
    else:
        m11 = count(1, 1)
        m21 = count(2, 1) if n > 1 else m11
        m12, m22 = m11, m21

    def bilinear(get):
        a = get(m11)
        dn = get(m21) - a
        dm = get(m12) - a
        dnm = get(m22) - get(m21) - get(m12) + a
        return a + (n - 1) * dn + (mu - 1) * dm + (n - 1) * (mu - 1) * dnm

    def by_key(name):
        # in the order of first sight, the whole step's order
        keys = dict.fromkeys(k for m in (m11, m21, m12, m22)
                             for k in m[name])
        return {k: bilinear(lambda m, k=k: m[name].get(k, 0))
                for k in keys}

    out = {k: bilinear(lambda m, k=k: m[k])
           for k in ("flops", "bytes", "wire")}
    out.update(by_op=by_key("by_op"), counts=by_key("counts"),
               by_axis=by_key("by_axis"))
    out["peak"] = _peak(m12, m22, n, mu)
    for m in (m11, m21, m12, m22):
        if m["alias_bytes"] != m["donated_bytes"]:
            raise RuntimeError(f"{arch}: the step returns a donated "
                               f"argument that it did not update in place")
    out["extra_out_bytes"] = m11["out_bytes"] - m11["alias_bytes"]
    variants = {id(m): m for m in (m11, m21, m12, m22)}.values()
    out["t_build"] = sum(m["t_build"] for m in variants)
    out["t_run"] = sum(m["t_run"] for m in variants)
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             *, mesh_shape=None,
             cfg: ModelConfig | None = None, cell: ShapeCell | None = None,
             microbatches: int | None = None, remat: str = "full",
             full: bool = False):
    """One cell's record. A train cell's FLOPs, bytes, collectives and
    peak come from :func:`extrapolated_metrics` (the reference's
    ``metrics=True``), or, with ``full``, from one count of the whole
    step, which they equal; the other cells' from one count. ``mesh_shape``,
    ``cfg``, ``cell``, ``microbatches`` and ``remat`` replace the
    production mesh, the registered config, the workload shape, the train
    plan's microbatches and the full remat, to dry-run a cut-down cell
    (e.g. one a single card trains)."""
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
    build = functools.partial(build_lowerable, arch, shape, mesh, cfg=cfg,
                              force_mb=microbatches, cell=cell, remat=remat)
    if cell.kind == "train" and not full:
        t0 = time.time()
        _, args, donate = build()     # the full depth's stand-ins
        t_lower = time.time() - t0
        mx = extrapolated_metrics(arch, shape, mesh, cfg, cell,
                                  microbatches, remat)
        arg_bytes = sum(_nbytes(t) for t in _locals(args))
        alias_bytes = sum(_nbytes(t) for i in donate
                          for t in _locals(args[i]))
        out_bytes = alias_bytes + mx["extra_out_bytes"]
        t_lower += mx["t_build"]
    else:
        mx = _count(build, mesh)
        arg_bytes, out_bytes, alias_bytes = (
            mx["arg_bytes"], mx["out_bytes"], mx["alias_bytes"])
        t_lower = mx["t_build"]
    t_run = mx["t_run"]
    temp_bytes = max(0, mx["peak"] - (out_bytes - alias_bytes))
    hbm = arg_bytes + out_bytes + temp_bytes - alias_bytes

    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mf = model_flops(cfg, cell.kind, tokens,
                     paper_heads=PAPER_HEADS.get(arch))
    rl = Roofline(flops=mx["flops"], bytes_accessed=mx["bytes"],
                  wire_bytes=mx["wire"], n_devices=n_dev,
                  model_flops=mf, wire_by_axis=mx["by_axis"])
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
        coll_by_op={k: round(v) for k, v in mx["by_op"].items()},
        coll_counts=mx["counts"],
        wire_by_axis={k: round(v) for k, v in mx["by_axis"].items()},
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
            f"{rl.wire_bytes/2**20:.1f} MiB on wire {mx['counts']}"
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
        t0 = time.time()
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
        print(f"  {arch} × {shape} × {rec['mesh']}: {rec['status']} in "
              f"{time.time() - t0:.1f} s", flush=True)
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

"""Render the dry-run JSONL records into the roofline tables (the
reference's ``launch/report.py``; the single-pod tables take the 2-D
mesh, whatever its shape).

  PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.jsonl
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict


def load(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    # keep the LAST record per (arch, shape, mesh) — reruns override
    dedup = {}
    for r in out:
        dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return list(dedup.values())


def _single_pod(r: dict) -> bool:
    """A record of a 2-D (data, model) mesh: the reference's 16x16, the
    port's 32x8."""
    return len(r["mesh"].split("x")) == 2


def _ms(x) -> str:
    return f"{x*1e3:.1f}"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | HBM/dev | fits | compile |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "OK":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK "
                f"| {r['hbm_per_device']/2**30:.2f} GiB "
                f"| {'yes' if r['fits_hbm'] else 'NO'} "
                f"| {r.get('t_compile_s','')}s |"
            )
        else:
            reason = r.get("reason") or r.get("error", "")
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                f"| {r['status']} | — | — | {reason[:60]} |"
            )
    return "\n".join(lines)


def roofline_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | t_comp ms | t_mem ms | t_coll ms | bottleneck "
        "| MODEL_FLOPS/HLO | roofline-frac (MFU) | move-the-needle |",
        "|---|---|---|---|---|---|---|---|---|"[:-4],
    ]
    hints = {
        "compute": "reduce recompute (remat policy) / causal block-skip",
        "memory": "larger flash tiles; fuse norms; bf16 masters",
        "collective": "Megatron-SP (AR→RS+AG); FSDP-only plan for small "
        "dense; overlap grads",
    }
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if not _single_pod(r):
            continue
        if r["status"] != "OK":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | "
                f"{r['status']}: {r.get('reason', r.get('error',''))[:48]} "
                f"| — | — | — |"
            )
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {_ms(r['t_compute'])} | {_ms(r['t_memory'])} "
            f"| {_ms(r['t_collective'])} | {r['bottleneck']} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['mfu']:.3f} "
            f"| {hints[r['bottleneck']]} |"
        )
    return "\n".join(lines)


def collective_detail(recs: list[dict]) -> str:
    lines = ["| arch | shape | wire GiB/dev | by op |", "|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if not _single_pod(r) or r["status"] != "OK":
            continue
        ops = ", ".join(
            f"{k}:{v/2**30:.2f}" for k, v in sorted(
                r.get("coll_by_op", {}).items(), key=lambda kv: -kv[1]
            )
        )
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['wire_bytes_per_device']/2**30:.2f} | {ops} |"
        )
    return "\n".join(lines)


def summarize(recs):
    n_ok = sum(1 for r in recs if r["status"] == "OK")
    n_skip = sum(1 for r in recs if r["status"] == "SKIP")
    n_fail = sum(1 for r in recs if r["status"] == "FAIL")
    by_mesh = defaultdict(lambda: [0, 0, 0])
    for r in recs:
        i = {"OK": 0, "SKIP": 1, "FAIL": 2}[r["status"]]
        by_mesh[r["mesh"]][i] += 1
    return n_ok, n_skip, n_fail, dict(by_mesh)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.jsonl"
    recs = load(path)
    n_ok, n_skip, n_fail, by_mesh = summarize(recs)
    print(f"### Dry-run status: {n_ok} OK / {n_skip} SKIP / {n_fail} FAIL "
          f"{by_mesh}\n")
    print("#### Cell table (both meshes)\n")
    print(dryrun_table(recs))
    print("\n#### Roofline (single-pod, per step per device)\n")
    print(roofline_table(recs))
    print("\n#### Collective breakdown (single-pod)\n")
    print(collective_detail(recs))


if __name__ == "__main__":
    main()

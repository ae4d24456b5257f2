#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. card    the GPU's name and power limit (nvidia-smi) and CUDA version.
2. build   nvcc builds every kernel from ``src/repro_torch/kernels/csrc``.
3. kernel  each kernel against its plain PyTorch version on the card, at
           the reference's test shapes and two more (D=100, k=64), in
           fp32 and bf16, a tie case, a fewer-than-k-active case, and the
           real size (2**20 rows x 768, fp32, 20% inactive, k=4, B in
           1/4/16/64); with times, below 16 queries also of the block of
           16 the kernel would use without its smaller blocks.
4. stage1  a 2**20-entry ``CortexCache`` at D=768 on the kernel backend
           against the numpy backend on the same contents: candidate
           se_ids identical and in the same order, except that entries
           whose sims lie within 2e-5 of each other may swap (paraphrase
           sims can sit closer than two fp32 summation orders differ),
           the last candidate with the entry just below the list too;
           where the candidate sets are identical, the lookup outcome
           (hit, entry, judge score) is identical too.
5. serve   ``run_once`` on the kernel backend (launch counts reset just
           before, read just after) equals ``backend="numpy"``, at the
           defaults and in an eviction-heavy run; then the kernel against
           its plain version on that run's own device index.
6. main    the kernel against its plain version at the main path's shape
           (8192 x 128, B = 1, 4 and 16), then its times there.
7. the ``kernels`` line: per kernel, its launches on the phase-5 main path,
   max abs error against the plain version over phases 3, 5 and 6, and
   its time, the plain version's, one library call's and the card's
   bound, at the main path's shape.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the port's sources beside this file, it prints no result and
exits non-zero. Tolerances: vals within 2e-5 (fp32 sums in another
order); rows equal wherever the value is a real score and its gap to its
neighbours in the ranking exceeds 2e-5; rows exactly equal on ties.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
NEG = -3.0e38
TOL = 2e-5
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 CUDA-core FLOP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
REPEATS = 20
REAL_N = 1 << 20          # the real-size index: 2**20 rows x 768
N_INTENTS = 131072        # x 8 paraphrases fill the real-size cache


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timed_ms(fn, repeats: int = REPEATS) -> float:
    """Median over ``repeats`` single calls, each between CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, repeats: int = REPEATS):
    """Device time per call, summed over the CUDA kernels a call launches
    (torch.profiler); None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / repeats / 1e3 if total_us > 0 else None


def bound(n: int, d: int, b: int, k: int) -> tuple[float, str]:
    """Least time on the card for fp32 inputs: each input read once and
    each output written once over HBM, or 2*N*D*B fp32 operations at
    CUDA-core peak."""
    nbytes = n * d * 4 + n + b * d * 4 + b * k * 8
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2.0 * n * d * b / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, *, exact_rows: bool = False) -> float:
    """Hold the kernel's (vals, rows) against the plain version's. ``want``
    carries k+1 columns so the k-th entry's gap to the next is known.
    Returns the max abs difference over real (non-NEG) values."""
    gv, gr = (t.cpu() for t in got)
    wv, wr = (t.cpu() for t in want)
    k = gv.shape[1]
    real = wv[:, :k] > NEG / 2
    check(torch.equal(real, gv > NEG / 2), "NEG entries differ")
    err = float((gv - wv[:, :k]).abs()[real].max()) if real.any() else 0.0
    check(err <= TOL, f"vals differ by {err}")
    if exact_rows:
        check(torch.equal(gr, wr[:, :k]), f"tie rows differ:\n{gr}\n{wr}")
        return err
    gap_next = (wv[:, :k] - wv[:, 1:k + 1]).abs()
    gap_prev = torch.cat([torch.full_like(wv[:, :1], float("inf")),
                          (wv[:, 1:k] - wv[:, :k - 1]).abs()], dim=1)
    sure = real & (gap_next > TOL) & (gap_prev > TOL)
    check(torch.equal(gr[sure], wr[:, :k][sure]), "rows differ")
    return err


def hold(ann_topk, ann_topk_plain, emb, act, q, k, *,
         exact_rows: bool = False) -> float:
    """The kernel against its plain version on the same inputs (the plain
    version with k+1 columns, see ``compare``); the max abs error. Below
    16 queries the block of 16 is held too, as ``measure`` times it."""
    want = ann_topk_plain(emb, act, q, k + 1)
    err = compare(ann_topk(emb, act, q, k), want, exact_rows=exact_rows)
    if q.shape[0] < 16:
        err = max(err, compare(ann_topk(emb, act, q, k, qb=16), want,
                               exact_rows=exact_rows))
    return err


def phase_kernel(ann_topk, ann_topk_plain, dev):
    max_err = 0.0

    def run(emb, act, q, k, *, exact_rows=False):
        nonlocal max_err
        max_err = max(max_err, hold(ann_topk, ann_topk_plain, emb, act, q, k,
                                    exact_rows=exact_rows))

    rng = np.random.default_rng(0)
    cases = 0
    # the reference's kernel-test shapes (tests/test_kernels.py:17), then
    # a width the 16-byte loads do not divide and the largest k over a
    # partial second block of queries
    for n, d, b, k in [(1000, 128, 4, 4), (513, 64, 1, 8),
                       (2048, 256, 16, 4), (64, 32, 2, 4),
                       (700, 100, 3, 5), (3000, 64, 20, 64)]:
        for dt in (torch.float32, torch.bfloat16):
            emb = rng.standard_normal((n, d)).astype(np.float32)
            emb /= np.linalg.norm(emb, axis=1, keepdims=True)
            act = rng.random(n) > 0.2
            q = rng.standard_normal((b, d)).astype(np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            run(torch.from_numpy(emb).to(dev, dt), torch.from_numpy(act).to(dev),
                torch.from_numpy(q).to(dev, dt), k)
            cases += 1
    # ties: exact-duplicate rows in other tiles; each query IS a duplicated
    # row, so its best score ties bitwise between the two copies
    n, d, b, k = 3000, 128, 8, 4
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    src = rng.choice(n // 2, b, replace=False)
    dst = n // 2 + rng.choice(n // 2, b, replace=False)
    emb[dst] = emb[src]
    act = np.ones(n, bool)
    run(torch.from_numpy(emb).to(dev), torch.from_numpy(act).to(dev),
        torch.from_numpy(emb[src].copy()).to(dev), k, exact_rows=True)
    cases += 1
    # fewer active rows than k
    n, d, b, k = 1000, 64, 3, 8
    emb = rng.standard_normal((n, d)).astype(np.float32)
    act = np.zeros(n, bool)
    act[[5, 600, 999]] = True
    run(torch.from_numpy(emb).to(dev), torch.from_numpy(act).to(dev),
        torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev),
        k)
    cases += 1

    # real size: 2**20 rows x 768 fp32, 20% inactive; queries near rows
    n, d, k = REAL_N, 768, 4
    g = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn((n, d), device=dev, generator=g)
    emb /= emb.norm(dim=1, keepdim=True)
    act = torch.rand(n, device=dev, generator=g) > 0.2
    sizes = []
    for b in (1, 4, 16, 64):
        pick = torch.randint(0, n, (b,), device=dev, generator=g)
        q = emb[pick] + 0.1 * torch.randn((b, d), device=dev, generator=g)
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
        run(emb, act, q, k)
        cases += 1
        sizes.append(measure(ann_topk, ann_topk_plain, emb, act, q, k))
    return max_err, cases, sizes


def measure(ann_topk, ann_topk_plain, emb, act, q, k) -> dict:
    """Times of the kernel (with the query block it picks, and below 16
    queries with the block of 16 too), the plain version and the library
    call, and the card's bound."""
    from repro_torch.kernels.ann_topk import query_block

    n, d = emb.shape
    b = q.shape[0]

    def library():
        s = torch.where(act[None, :], q @ emb.T, NEG)
        return torch.topk(s, k, dim=1)

    def kernel():
        return ann_topk(emb, act, q, k)

    def plain():
        return ann_topk_plain(emb, act, q, k)

    def block16():
        return ann_topk(emb, act, q, k, qb=16)

    bound_ms, bound_by = bound(n, d, b, k)
    out = {"n": n, "d": d, "b": b, "k": k, "qb": query_block(b),
           "ms": timed_ms(kernel), "plain_ms": timed_ms(plain),
           "library_ms": timed_ms(library), "device_ms": device_ms(kernel),
           "plain_device_ms": device_ms(plain),
           "library_device_ms": device_ms(library),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if b < 16:
        out["qb16_ms"] = timed_ms(block16)
        out["qb16_device_ms"] = device_ms(block16)
    return out


def check_ranking(ids_a, sims_a, ids_b, sims_b, next_b: float) -> int:
    """Hold candidate list a (se_ids, sims; similarity-descending) to list
    b: equal length, sims within TOL position by position, and the same
    se_ids in the same order except inside near-tie groups, runs of b's
    sims within TOL of each other, where fp32 sums taken in another order
    may swap entries. ``next_b`` is the sim of the entry ranked just below
    b's last (from a search one deeper): the last group may swap with it
    only when it lies within TOL. Returns how many positions were
    swapped."""
    check(len(ids_a) == len(ids_b), f"candidate counts differ: {ids_a} "
          f"{sims_a.tolist()} vs {ids_b} {sims_b.tolist()}")
    check(bool(np.all(np.abs(sims_a - sims_b) <= TOL)), "sims differ")
    below = np.append(sims_b[1:], next_b)
    start = 0
    for i in range(len(ids_b)):
        if sims_b[i] - below[i] > TOL:
            check(set(ids_a[start:i + 1]) == set(ids_b[start:i + 1]),
                  f"candidates differ outside near-ties: {ids_a} "
                  f"{sims_a.tolist()} vs {ids_b} {sims_b.tolist()}, next "
                  f"{next_b}")
            start = i + 1
    return sum(x != y for x, y in zip(ids_a, ids_b))


def phase_stage1(dev):
    from repro_torch.core.cache import make_cache
    from repro_torch.core.judge import OracleJudge
    from repro_torch.data.world import SemanticWorld

    t0 = time.perf_counter()
    n_intents, paras, dim = N_INTENTS, 8, 768
    world = SemanticWorld(n_intents=n_intents, dim=dim, seed=0)
    queries = [world.query(i, p) for i in range(n_intents) for p in range(paras)]
    embs = np.stack([world.embed(q) for q in queries])
    values = [world.answer(q) for q in queries]
    t_world = time.perf_counter() - t0

    caches = {}
    for backend, device in (("kernel", dev), ("numpy", "cpu")):
        cache = make_cache(capacity_bytes=1 << 40, dim=dim,
                           judge=OracleJudge(world, seed=2),
                           index_capacity=n_intents * paras, backend=backend,
                           device=device)
        cache.insert_block(queries, embs, values, now=0.0, cost=0.01,
                           latency=0.2, size=1024, staticity=10, ttl=1e9)
        caches[backend] = cache
    del embs
    t_fill = time.perf_counter() - t0 - t_world

    rng = np.random.default_rng(1)
    top_k = caches["numpy"].seri.top_k
    hits = cands = swaps = same_sets = hits_moved = 0
    now = 1.0
    t_search = {"kernel": 0.0, "numpy": 0.0}
    for _ in range(4):
        held = [world.query(int(i), paras + int(p)) for i, p in
                zip(rng.integers(0, n_intents, 16), rng.integers(0, 50, 16))]
        qe = np.stack([world.embed(q) for q in held])
        out = {}
        for backend, cache in caches.items():
            t = time.perf_counter()
            blocks, _ = cache.stage1_batch_flagged(held, qe, now)
            results = cache.lookup_batch(held, qe, now)
            t_search[backend] += time.perf_counter() - t
            out[backend] = (blocks, results)
        (bk, rk), (bn, rn) = out["kernel"], out["numpy"]
        # the numpy ranking one deeper than the lists: the entry below each
        _, deeper = caches["numpy"].seri.index._search_brute(qe, top_k + 1)
        for (ck, sk), (cn, sn), a, b, nxt in zip(bk, bn, rk, rn, deeper):
            ik, i_n = [c.se_id for c in ck], [c.se_id for c in cn]
            swaps += check_ranking(ik, sk, i_n, sn, float(nxt[len(i_n)]))
            cands += len(ck)
            hit_k = a.se.se_id if a.hit else None
            hit_n = b.se.se_id if b.hit else None
            check((a.n_candidates, a.judge_calls)
                  == (b.n_candidates, b.judge_calls), "lookups differ")
            if set(ik) == set(i_n):
                # same candidates: the judge scores the same pairs (each
                # seeded by its pair), so the outcome must be the same
                same_sets += 1
                check((a.hit, hit_k, a.best_score)
                      == (b.hit, hit_n, b.best_score),
                      f"hits differ: {hit_k} vs {hit_n}")
            else:
                hits_moved += int(hit_k != hit_n)
            hits += int(a.hit)
        now += 1.0
    check(cands > 0 and hits > 0, "stage 1 found nothing to compare")
    return {"rows": n_intents * paras, "dim": dim, "queries": 64,
            "candidates": cands, "identical_sets": same_sets,
            "near_tie_swaps": swaps, "hits": hits,
            "hits_moved_by_near_ties_below": hits_moved,
            "world_s": t_world, "fill_s": t_fill,
            "host_s_kernel_backend": t_search["kernel"],
            "host_s_numpy_backend": t_search["numpy"]}


def run_keeping_cache(**kw):
    """``run_once(**kw)`` and the cache it built, for checks after it."""
    from repro_torch.launch import serve

    made = []
    make_cache = serve.make_cache

    def keep(*args, **kwargs):
        made.append(make_cache(*args, **kwargs))
        return made[-1]

    serve.make_cache = keep
    try:
        summary = serve.run_once(**kw)
    finally:
        serve.make_cache = make_cache
    return summary, made[0]


def phase_serve(ann_topk, ann_topk_plain, dev):
    from repro_torch.launch.serve import run_once

    runs = []
    launches = 0
    max_err = 0.0
    g = torch.Generator(device=dev).manual_seed(2)
    for kw in ({}, dict(cache_ratio=0.05, eviction="lcfu", n_requests=300,
                        concurrency=16)):
        ann_topk.launches = 0
        ann_topk.plain_calls = 0
        t = time.perf_counter()
        got, cache = run_keeping_cache(
            workload="zipf", mode="cortex", backend="kernel", device=dev, **kw)
        wall = time.perf_counter() - t
        n_launch, n_plain = ann_topk.launches, ann_topk.plain_calls
        check(n_launch > 0, "the main path launched no ann_topk kernel")
        check(n_plain == 0, "the CUDA path took the plain version")
        # the kernel against its plain version on this run's device index,
        # with queries near its live entries, one at a time and as 16
        index = cache.seri.index
        emb, act = index.emb_dev, index.active_dev
        live = torch.nonzero(act).flatten()
        check(live.numel() >= 16, "the run left fewer than 16 live entries")
        for b in (1, 16):
            pick = live[torch.randperm(live.numel(), device=dev,
                                       generator=g)[:b]]
            q = emb[pick] + 0.05 * torch.randn((b, emb.shape[1]), device=dev,
                                               generator=g)
            q = (q / q.norm(dim=1, keepdim=True)).contiguous()
            max_err = max(max_err, hold(ann_topk, ann_topk_plain, emb, act, q,
                                        cache.seri.top_k))
        want = run_once(workload="zipf", mode="cortex", backend="numpy",
                        device="cpu", **kw)
        diff = {key: (got.get(key), want.get(key))
                for key in set(got) | set(want) if got.get(key) != want.get(key)}
        check(not diff, f"summary differs from the numpy backend: {diff}")
        if not kw:
            launches = n_launch
        runs.append({"kwargs": kw, "launches": n_launch, "wall_s": wall,
                     "hit_rate": got.get("hit_rate"),
                     "evictions": got.get("evictions"),
                     "index_rows": emb.shape[0], "live_rows": live.numel()})
    check(runs[1]["evictions"], "the eviction run evicted nothing")
    return launches, runs, max_err


def phase_main_shape(ann_topk, ann_topk_plain, dev):
    """The kernel against its plain version, then times, at the main path's
    shape: run_once's index (8192 x 128, 20% inactive) and its
    micro-batches (one query, nearly always; 4; and 16)."""
    g = torch.Generator(device=dev).manual_seed(1)
    out = []
    max_err = 0.0
    for b in (1, 4, 16):
        emb = torch.randn((8192, 128), device=dev, generator=g)
        emb /= emb.norm(dim=1, keepdim=True)
        act = torch.rand(8192, device=dev, generator=g) > 0.2
        q = torch.randn((b, 128), device=dev, generator=g)
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
        max_err = max(max_err, hold(ann_topk, ann_topk_plain, emb, act, q, 4))
        out.append(measure(ann_topk, ann_topk_plain, emb, act, q, 4))
    return out, max_err


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.ann_topk import ann_topk, ann_topk_plain

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    emit(phase="card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    built = build.build_all()
    for name, b in built.items():
        print(f"--- nvcc {name}.cu ({b.seconds:.1f} s)\n{b.log}",
              file=sys.stderr)
    emit(phase="build", seconds=time.perf_counter() - t,
         built=sorted(n for n, b in built.items() if b.log is not None),
         sources=list(build.SOURCES))

    t = time.perf_counter()
    max_err, cases, sizes = phase_kernel(ann_topk, ann_topk_plain, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(phase="kernel", cases=cases, max_abs_err=max_err, real_size=sizes,
         seconds=time.perf_counter() - t)

    t = time.perf_counter()
    stage1 = phase_stage1(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(phase="stage1", **stage1, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    launches, runs, serve_err = phase_serve(ann_topk, ann_topk_plain, dev)
    emit(phase="serve", runs=runs, max_abs_err=serve_err,
         seconds=time.perf_counter() - t)

    main_sizes, main_err = phase_main_shape(ann_topk, ann_topk_plain, dev)
    emit(phase="main", max_abs_err=main_err)
    max_err = max(max_err, serve_err, main_err)
    main = main_sizes[0]
    print(card, flush=True)
    emit(kernels=[{
        "name": "ann_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ann_topk.cu",
        "replaces": "src/repro/kernels/ann_topk.py:27",
        "launches": launches, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "device_ms": main["device_ms"],
        "shape": {k: main[k] for k in ("n", "d", "b", "k")},
        "sizes": main_sizes + sizes,
    }])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

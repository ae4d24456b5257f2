#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. card    the GPU's name and power limit (nvidia-smi) and CUDA version.
2. build   nvcc builds every kernel from ``src/repro_torch/kernels/csrc``,
           one process per source, all at once.
3. kernel  ann_topk against its plain PyTorch version on the card, at
           the reference's test shapes and two more (D=100, k=64), in
           fp32 and bf16, a tie case, a fewer-than-k-active case, and the
           real size (2**20 rows x 768, fp32, 20% inactive, k=4, B in
           1/4/16/64); with times, below 16 queries also of the block of
           16 the kernel would use without its smaller blocks.
   kernel_quant  ann_topk_quant likewise: the tier test's shape (300 x 32,
           B=16, k=16), D=48/50/100, k=64, ties, fewer than k active, and
           2**20 x 768 int8 (20% inactive, k=16, B in 1/16), with times.
   kernel_ivf  ann_topk_ivf and ann_topk_ivf_quant likewise: the
           reference's kernel-test shapes, D=100/50, k above the bucket
           size, disabled probes, duplicates inside a bucket, bitwise
           parity of the routed and the brute scan, and C=512 buckets x
           4096 slots x 768 (half valid, nprobe=64, B in 1/16; k=4 fp32,
           k=16 int8), with times.
4. stage1  a 2**20-entry ``CortexCache`` at D=768 on the kernel backend
           against the numpy backend on the same contents: candidate
           se_ids identical and in the same order, except that entries
           whose sims lie within 2e-5 of each other may swap (paraphrase
           sims can sit closer than two fp32 summation orders differ),
           the last candidate with the entry just below the list too;
           where the candidate sets are identical, the lookup outcome
           (hit, entry, judge score) is identical too.
   stage1_warm  the same contents as a warm-tier int8 ``QuantIndex`` on
           both backends (``quant_index_from_numpy``): ids and sims
           bitwise equal.
   stage1_clustered  a C=512, nprobe=64 router trained once on the
           kernel index and carried to the numpy index: the routed scans
           agree within phase 4's near-tie allowance.
5. serve   ``run_once`` on the kernel backend (launch counts reset just
           before, read just after) equals ``backend="numpy"``, at the
           defaults, in an eviction-heavy run, and for (a) the repo's
           tiered config, (b) zipf with clustering, (c) tiered and
           clustered where both routers train: kernels 1, 2, 3 and all
           four launch, no plain version runs; then every kernel against
           its plain version on the run's own device layouts, and the new
           kernels' times at run (c)'s shapes.
6. main    ann_topk against its plain version at the main path's shape
           (8192 x 128, B = 1, 4 and 16), then its times there.
7. the ``kernels`` line: per kernel, its launches on its serve run, max
   abs error against the plain version over every phase, and its time,
   the plain version's, one library call's and the card's bound, at its
   main-path shape, with the real-size times under ``sizes``.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the port's sources beside this file, it prints no result and
exits non-zero. Tolerances: fp32 vals within 2e-5 (sums in another
order); rows equal wherever the value is a real score and its gap to its
neighbours in the ranking exceeds 2e-5; rows exactly equal on ties. int8
kernels: vals bitwise equal (atol 0), rows equal wherever the value is a
real score.
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
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 CUDA-core FLOP/s,
# dense int8 tensor-core OP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
REPEATS = 20
REAL_N = 1 << 20          # the real-size index: 2**20 rows x 768
N_INTENTS = 131072        # x 8 paraphrases fill the real-size cache
# the routed scan at real size: the repo's own rule at N = 2**20
# (benchmarks/figures.py:390-391), and buckets of 4096 slots, half valid
REAL_C, REAL_CAP, REAL_NPROBE = 512, 4096, 64


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


def bound(act: torch.Tensor, d: int, b: int, k: int) -> tuple[float, str]:
    """Least time on the card for a brute fp32 scan on these inputs: the
    active mask, the active rows and the queries read once, the results
    written once, over HBM; or 2*D*B fp32 operations per active row at
    CUDA-core peak. An inactive row scores NEG whatever it holds, so its
    payload is not counted."""
    n, live = act.numel(), int(act.sum())
    nbytes = n + live * d * 4 + b * d * 4 + b * k * 8
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2.0 * live * d * b / FP32_FLOPS * 1e3
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

    bound_ms, bound_by = bound(act, d, b, k)
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
    return world, caches, {"rows": n_intents * paras, "dim": dim, "queries": 64,
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
    factories = {name: getattr(serve, name)
                 for name in ("make_cache", "make_tiered_cache")}

    def keeping(factory):
        def keep(*args, **kwargs):
            made.append(factory(*args, **kwargs))
            return made[-1]
        return keep

    for name, factory in factories.items():
        setattr(serve, name, keeping(factory))
    try:
        summary = serve.run_once(**kw)
    finally:
        for name, factory in factories.items():
            setattr(serve, name, factory)
    return summary, made[0]


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


# --------------------------------------------------- the int8 and IVF kernels

def compare_exact(got, want) -> float:
    """Hold (vals, slots or rows) to a result that must agree bitwise (an
    int8 kernel against its plain version, the routed scan against the
    brute one): vals equal everywhere (NEG entries included), rows equal
    wherever the value is a real score. Returns 0.0, the error."""
    gv, gr = (t.cpu() for t in got)
    wv, wr = (t.cpu() for t in want)
    check(torch.equal(gv, wv), f"vals that must agree bitwise differ by "
          f"{float((gv - wv).abs().max())}")
    real = wv > NEG / 2
    check(torch.equal(gr[real], wr[real]), "rows that must agree differ")
    return 0.0


def compare_probes(got, want, *, exact_rows: bool = False) -> float:
    """The fp32 routed scan's (B, nprobe, k) finalists against the plain
    version's (B, nprobe, k + 1), probe by probe, as ``compare`` holds
    ann_topk."""
    b, nprobe, k = got[0].shape
    flat = [t.reshape(b * nprobe, -1) for t in (*got, *want)]
    return compare(flat[:2], flat[2:], exact_rows=exact_rows)


def quantize_dev(x: torch.Tensor):
    """Symmetric per-row int8 of x on its device (core/tiers.py's rule)."""
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), scale.float().contiguous()


def unit_rows(g, n: int, d: int, dev) -> torch.Tensor:
    x = torch.randn((n, d), device=dev, generator=g)
    return x / x.norm(dim=1, keepdim=True)


def near(rows: torch.Tensor, g, noise: float = 0.05) -> torch.Tensor:
    """Unit queries a little off the given rows."""
    q = rows + noise * torch.randn(rows.shape, device=rows.device, generator=g)
    return (q / q.norm(dim=1, keepdim=True)).contiguous()


def bound_quant(act: torch.Tensor, d: int, b: int, k: int
                ) -> tuple[float, str]:
    """Least time for ann_topk_quant on these inputs: the active mask, each
    active row's int8 values and scale, the int8 queries and their scales
    read once, the results written once; or 2*D*B int8 operations per
    active row at the int8 tensor-core peak."""
    n, live = act.numel(), int(act.sum())
    nbytes = n + live * (d + 4) + b * (d + 4) + b * k * 8
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2.0 * live * d * b / INT8_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ivf(sel, en, valid, d: int, k: int, quant: bool
              ) -> tuple[float, str]:
    """Least time for a routed scan on these inputs: for each distinct
    probed bucket its valid mask and its valid slots (payload, and the int8
    scale), the queries and the routing read once, the finalists written
    once; or 2*D operations per valid slot of every enabled probe, at the
    fp32 CUDA-core or int8 tensor-core peak. An invalid slot scores NEG
    whatever it holds, so its payload is not counted."""
    b, nprobe = sel.shape
    cap = valid.shape[1]
    probed = sel[en > 0].long()
    distinct = probed.unique()
    per_slot = d + 4 if quant else d * 4
    nbytes = (distinct.numel() * cap + int(valid[distinct].sum()) * per_slot
              + b * (d + 4 if quant else d * 4)
              + b * nprobe * 8 + b * nprobe * k * 8)
    ops = 2.0 * d * int(valid[probed].sum())
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / (INT8_OPS if quant else FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timings(kernel, plain, library) -> dict:
    """Event-timed and profiler device times of the kernel, its plain
    version and the library yardstick (None where there is none)."""
    out = {"ms": timed_ms(kernel), "device_ms": device_ms(kernel),
           "plain_ms": timed_ms(plain), "plain_device_ms": device_ms(plain),
           "library_ms": None, "library_device_ms": None}
    if library is not None:
        out["library_ms"] = timed_ms(library)
        out["library_device_ms"] = device_ms(library)
    return out


def measure_quant(emb_q, scales, act, qq, qs, k) -> dict:
    from repro_torch.kernels.ann_topk_quant import (ann_topk_quant,
                                                    ann_topk_quant_plain)
    n, d = emb_q.shape
    b = qq.shape[0]
    # torch._int_mm's CUDA shape rules: more than 16 rows, D and the query
    # count multiples of 8; the query block is padded with zero rows to a
    # multiple of 8, and the scores of the padding are dropped
    qq_t = torch.cat([qq, qq.new_zeros((-b % 8, d))]).T.contiguous()

    def library():
        # int8 products through cuBLAS (torch._int_mm), then the rescale,
        # the mask and a stable sort
        s = torch._int_mm(emb_q, qq_t)[:, :b].T.float() * scales[None, :]
        s = torch.where(act[None, :], s * qs[:, None], NEG)
        return torch.sort(-s, dim=1, stable=True).indices[:, :k]

    has_lib = n > 16 and d % 8 == 0
    out = {"n": n, "d": d, "b": b, "k": k,
           **timings(lambda: ann_topk_quant(emb_q, scales, act, qq, qs, k),
                     lambda: ann_topk_quant_plain(emb_q, scales, act, qq,
                                                  qs, k),
                     library if has_lib else None),
           "library": ("torch._int_mm (queries padded to a multiple of 8) "
                       "+ rescale + stable sort" if has_lib
                       else "none: torch._int_mm needs D a multiple of 8")}
    out["bound_ms"], out["bound_by"] = bound_quant(act, d, b, k)
    return out


def measure_ivf(sel, en, q, buckets, valid, k, *, quant=None) -> dict:
    """Times of the fp32 routed scan, or with ``quant = (q_scales,
    bucket_scale)`` of the int8 one (q then holds the int8 queries)."""
    from repro_torch.kernels import ann_topk_ivf as ivf
    b, nprobe = sel.shape
    c, cap, d = buckets.shape
    if quant is None:
        args = (sel, en, q, buckets, valid, k)
        kernel, plain = ivf.ann_topk_ivf, ivf.ann_topk_ivf_plain
    else:
        qs, bscale = quant
        args = (sel, en, q, qs, buckets, bscale, valid, k)
        kernel, plain = ivf.ann_topk_ivf_quant, ivf.ann_topk_ivf_quant_plain

    def library():
        # one batched matmul over every (query, probe)'s gathered bucket,
        # in fp32 (int8 products sum exactly there), then a stable sort
        sb = sel.long()
        s = torch.bmm(buckets[sb].reshape(b * nprobe, cap, d).float(),
                      q.float().repeat_interleave(nprobe, 0)[:, :, None])
        s = s.reshape(b, nprobe, cap)
        if quant is not None:
            s = s * bscale[sb] * qs[:, None, None]
        s = torch.where(valid[sb] & (en > 0)[:, :, None], s, NEG)
        return torch.sort(-s, dim=2, stable=True).indices[..., :k]

    bound_ms, bound_by = bound_ivf(sel, en, valid, d, k, quant is not None)
    return {"b": b, "nprobe": nprobe, "c": c, "cap": cap, "d": d, "k": k,
            **timings(lambda: kernel(*args), lambda: plain(*args), library),
            "library": "gathered buckets, torch.bmm + stable sort",
            "bound_ms": bound_ms, "bound_by": bound_by}


def hold_quant(emb_q, scales, act, qq, qs, k) -> float:
    from repro_torch.kernels.ann_topk_quant import (ann_topk_quant,
                                                    ann_topk_quant_plain)
    return compare_exact(ann_topk_quant(emb_q, scales, act, qq, qs, k),
                         ann_topk_quant_plain(emb_q, scales, act, qq, qs, k))


def hold_ivf(sel, en, q, buckets, valid, k, *, exact_rows=False) -> float:
    from repro_torch.kernels.ann_topk_ivf import (ann_topk_ivf,
                                                  ann_topk_ivf_plain)
    return compare_probes(
        ann_topk_ivf(sel, en, q, buckets, valid, k),
        ann_topk_ivf_plain(sel, en, q, buckets, valid, k + 1),
        exact_rows=exact_rows)


def hold_ivf_quant(sel, en, qq, qs, buckets_q, bscale, valid, k) -> float:
    from repro_torch.kernels.ann_topk_ivf import (ann_topk_ivf_quant,
                                                  ann_topk_ivf_quant_plain)
    args = (sel, en, qq, qs, buckets_q, bscale, valid, k)
    return compare_exact(ann_topk_ivf_quant(*args),
                         ann_topk_ivf_quant_plain(*args))


def phase_kernel_quant(dev):
    """ann_topk_quant against its plain version: the reference's tier-test
    shape (tests/test_tiers.py:94), widths the 16-byte loads do not divide,
    ties, fewer active rows than k, and the real size."""
    g = torch.Generator(device=dev).manual_seed(3)
    cases = []

    def run(emb, act, q, k):
        eq, es = quantize_dev(emb)
        qq, qs = quantize_dev(q)
        cases.append(hold_quant(eq, es, act, qq, qs, k))

    for n, d, b, k in [(300, 32, 16, 16), (700, 48, 3, 16), (700, 100, 5, 16),
                       (1100, 50, 2, 8), (3000, 64, 20, 64)]:
        emb = unit_rows(g, n, d, dev)
        act = torch.rand(n, device=dev, generator=g) > 0.2
        run(emb, act, near(emb[:b], g), k)
    # ties: exact-duplicate rows in other tiles, each query a duplicated row
    n, d, b = 3000, 128, 8
    emb = unit_rows(g, n, d, dev)
    src = torch.randperm(n // 2, device=dev, generator=g)[:b]
    dst = n // 2 + torch.randperm(n // 2, device=dev, generator=g)[:b]
    emb[dst] = emb[src]
    run(emb, torch.ones(n, dtype=torch.bool, device=dev), emb[src].clone(), 16)
    # fewer active rows than k
    emb = unit_rows(g, 1000, 64, dev)
    act = torch.zeros(1000, dtype=torch.bool, device=dev)
    act[[5, 600, 999]] = True
    run(emb, act, unit_rows(g, 3, 64, dev), 16)

    # real size: 2**20 rows x 768 int8 (0.8 GB), 20% inactive, k = 16
    n, d, k = REAL_N, 768, 16
    emb_q, scales = quantize_dev(unit_rows(g, n, d, dev))
    act = torch.rand(n, device=dev, generator=g) > 0.2
    sizes = []
    for b in (1, 16):
        pick = torch.randint(0, n, (b,), device=dev, generator=g)
        deq = emb_q[pick].float() * scales[pick][:, None]
        qq, qs = quantize_dev(near(deq, g, 0.1))
        cases.append(hold_quant(emb_q, scales, act, qq, qs, k))
        sizes.append(measure_quant(emb_q, scales, act, qq, qs, k))
    return max(cases), len(cases), sizes


def random_probes(g, b: int, c: int, nprobe: int, dev, p_off: float = 0.0):
    """(sel, enabled): nprobe distinct buckets per query, a share p_off of
    the probes disabled."""
    sel = torch.rand((b, c), device=dev, generator=g).argsort(dim=1)
    sel = sel[:, :nprobe].to(torch.int32).contiguous()
    en = (torch.rand((b, nprobe), device=dev, generator=g) >= p_off)
    return sel, en.to(torch.int32).contiguous()


def hold_brute_routed_parity(g, dev) -> float:
    """A row scores bitwise the same in the brute scan (ann_topk) and the
    routed scan (ann_topk_ivf), the shared summation order of dot.cuh:
    N rows laid out as C buckets of consecutive rows, every bucket
    probed, the finalists merged; values and rows must be equal."""
    from repro_torch.kernels.ann_topk import ann_topk
    from repro_torch.kernels.ann_topk_ivf import ann_topk_ivf
    from repro_torch.kernels.ops import _merge_probes

    c, cap, d, b, k = 16, 64, 128, 8, 8
    emb = unit_rows(g, c * cap, d, dev)
    act = torch.rand(c * cap, device=dev, generator=g) > 0.3
    q = near(emb[torch.randint(0, c * cap, (b,), device=dev, generator=g)], g)
    sel = torch.arange(c, dtype=torch.int32, device=dev).repeat(b, 1)
    en = torch.ones_like(sel)
    vals, slots = ann_topk_ivf(sel, en, q, emb.reshape(c, cap, d),
                               act.reshape(c, cap), k)
    rows = torch.arange(c * cap, dtype=torch.int32, device=dev)
    got = _merge_probes(vals, slots, sel, rows.reshape(c, cap), k)
    return compare_exact(got, ann_topk(emb, act, q, k))


def phase_kernel_ivf(dev):
    """ann_topk_ivf and ann_topk_ivf_quant against their plain versions:
    the reference's kernel-test shapes (tests/test_kernels.py:90-92 and
    :130), widths the wide loads do not divide, k above the bucket size,
    disabled probes, duplicate rows inside one bucket, bitwise parity with
    the brute scan, and the real size."""
    g = torch.Generator(device=dev).manual_seed(4)
    errs3, errs4 = [], []

    def run(sel, en, buckets, valid, q, k, *, exact_rows=False):
        errs3.append(hold_ivf(sel, en, q, buckets, valid, k,
                              exact_rows=exact_rows))
        c, cap, d = buckets.shape
        bq, bs = quantize_dev(buckets.reshape(c * cap, d))
        qq, qs = quantize_dev(q)
        errs4.append(hold_ivf_quant(sel, en, qq, qs, bq.reshape(c, cap, d),
                                    bs.reshape(c, cap), valid, k))

    for c, cap, d, b, nprobe, k in [(8, 16, 32, 4, 3, 2), (16, 64, 64, 8, 5, 4),
                                    (4, 8, 16, 1, 4, 3), (8, 32, 48, 4, 4, 6),
                                    (8, 32, 100, 3, 4, 16),
                                    (8, 40, 50, 3, 4, 5), (4, 8, 32, 2, 3, 16)]:
        buckets = torch.randn((c, cap, d), device=dev, generator=g)
        valid = torch.rand((c, cap), device=dev, generator=g) > 0.3
        sel, en = random_probes(g, b, c, nprobe, dev, p_off=0.2)
        run(sel, en, buckets, valid,
            torch.randn((b, d), device=dev, generator=g), k)
    # duplicates inside one bucket: every query is a row copied to three
    # more slots of its own bucket, so its best score ties bitwise
    c, cap, d, b, nprobe, k = 16, 64, 128, 6, 4, 4
    buckets = unit_rows(g, c * cap, d, dev).reshape(c, cap, d)
    valid = torch.ones((c, cap), dtype=torch.bool, device=dev)
    sel, en = random_probes(g, b, c, nprobe, dev)
    q = torch.empty((b, d), device=dev)
    for i in range(b):
        bk = int(sel[i, 0])
        buckets[bk, [9, 30, 41, 60]] = buckets[bk, 17].clone()
        q[i] = buckets[bk, 17]
    run(sel, en, buckets, valid, q, k, exact_rows=True)
    errs3.append(hold_brute_routed_parity(g, dev))

    # real size: C=512 buckets x 4096 slots x 768, half the slots valid,
    # 64 probes a query; k=4 fp32 (6.4 GB), k=16 int8 (1.6 GB)
    c, cap, d, nprobe = REAL_C, REAL_CAP, 768, REAL_NPROBE
    valid = torch.rand((c, cap), device=dev, generator=g) < 0.5
    sizes3, sizes4 = [], []
    buckets = unit_rows(g, c * cap, d, dev).reshape(c, cap, d)
    bq, bs = quantize_dev(buckets.reshape(c * cap, d))
    bq, bs = bq.reshape(c, cap, d), bs.reshape(c, cap)
    probes = {b: random_probes(g, b, c, nprobe, dev) for b in (1, 16)}
    queries = {b: near(buckets[probes[b][0][:, 0].long(), 0], g, 0.1)
               for b in (1, 16)}
    for b, (sel, en) in probes.items():
        errs3.append(hold_ivf(sel, en, queries[b], buckets, valid, 4))
        sizes3.append(measure_ivf(sel, en, queries[b], buckets, valid, 4))
    del buckets
    torch.cuda.empty_cache()
    for b, (sel, en) in probes.items():
        qq, qs = quantize_dev(queries[b])
        errs4.append(hold_ivf_quant(sel, en, qq, qs, bq, bs, valid, 16))
        sizes4.append(measure_ivf(sel, en, qq, bq, valid, 16, quant=(qs, bs)))
    return (max(errs3), max(errs4), len(errs3) + len(errs4), sizes3, sizes4)


# --------------------------------------------- real-size warm and clustered

def held_queries(world, rng, n_intents: int, paras: int, b: int):
    held = [world.query(int(i), paras + int(p)) for i, p in
            zip(rng.integers(0, n_intents, b), rng.integers(0, 50, b))]
    return np.stack([world.embed(q) for q in held])


def phase_stage1_warm(dev, world, caches):
    """The warm tier's index at real size: the phase-4 contents quantized
    once into a port QuantIndex on the kernel backend and one on the numpy
    backend (``quant_index_from_numpy``). The coarse int8 scores are exact
    on both and the fp32 rescore is the same host code, so ids and sims
    must be bitwise equal."""
    from repro_torch.convert import quant_index_from_numpy
    from repro_torch.core.tiers import quantize_rows

    t0 = time.perf_counter()
    src = caches["numpy"].seri.index
    emb_q, scale = quantize_rows(src.emb)
    state = (emb_q, scale, src.active, src.row_se, src._free)
    idx = {"kernel": quant_index_from_numpy(*state, backend="kernel",
                                            device=dev),
           "numpy": quant_index_from_numpy(*state, backend="numpy",
                                           device="cpu")}
    del emb_q, scale
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    k = caches["numpy"].seri.top_k
    found = 0
    t_search = {"kernel": 0.0, "numpy": 0.0}
    for b in (16, 1, 16):
        qe = held_queries(world, rng, N_INTENTS, 8, b)
        out = {}
        for backend, index in idx.items():
            t = time.perf_counter()
            out[backend] = index.search_batch(qe, k, tau_sim=-1.0)
            t_search[backend] += time.perf_counter() - t
        for (ids_k, sims_k), (ids_n, sims_n) in zip(out["kernel"],
                                                    out["numpy"]):
            check(ids_k == ids_n, f"warm ids differ: {ids_k} vs {ids_n}")
            check(np.array_equal(sims_k, sims_n), "warm sims differ")
            found += len(ids_k)
    check(found > 0, "the warm index found nothing")
    return {"rows": len(src), "dim": src.dim, "queries": 33,
            "candidates": found, "build_s": t_build,
            "host_s_kernel_backend": t_search["kernel"],
            "host_s_numpy_backend": t_search["numpy"]}


def router_state(rt) -> dict:
    """The state ``cluster_router_from_numpy`` carries."""
    return dict(centroids=rt.centroids, counts=rt.counts, assign=rt.assign,
                members=rt._member_lists, rng_state=rt.rng.bit_generator.state,
                muts=rt._muts, mb_counts=rt._mb_counts, trained=rt.trained,
                refreshes=rt.refreshes)


def phase_stage1_clustered(dev, world, caches):
    """The clustered hot tier at real size: C=512, nprobe=64 over the
    phase-4 index. The router trains once (``refresh``) on the kernel
    index and its state is carried to the numpy index; the kernel's routed
    scan is then held to the numpy routed scan with phase 4's near-tie
    allowance (exact ties between buckets would merge in probe order, the
    reference's documented caveat; the synthetic world has none)."""
    from repro_torch.convert import cluster_router_from_numpy
    from repro_torch.core.clustering import ClusterConfig, ClusterRouter

    t0 = time.perf_counter()
    kidx = caches["kernel"].seri.index
    nidx = caches["numpy"].seri.index
    cfg = ClusterConfig(n_clusters=REAL_C, nprobe=REAL_NPROBE, seed=5)
    kidx.router = ClusterRouter(kidx.capacity, kidx.dim, cfg)
    kidx.router.refresh(kidx)
    nidx.router = cluster_router_from_numpy(cfg, nidx.capacity,
                                            **router_state(kidx.router))
    t_train = time.perf_counter() - t0
    t = time.perf_counter()
    lay = kidx.router.kernel_layout(kidx)
    if lay.payload.is_cuda:
        torch.cuda.synchronize()
    t_layout = time.perf_counter() - t
    rng = np.random.default_rng(6)
    k = caches["numpy"].seri.top_k
    cands = swaps = 0
    scanned = {"kernel": [], "numpy": []}
    t_search = {"kernel": 0.0, "numpy": 0.0}
    for b in (16, 1, 16):
        qe = held_queries(world, rng, N_INTENTS, 8, b)
        out = {}
        for backend, index in (("kernel", kidx), ("numpy", nidx)):
            t = time.perf_counter()
            out[backend] = index.search_batch(qe, k, tau_sim=-1.0)
            t_search[backend] += time.perf_counter() - t
            scanned[backend].append(index.last_scanned)
        deeper = nidx.search_batch(qe, k + 1, tau_sim=-1.0)
        for (ik, sk), (i_n, sn), (_, sd) in zip(out["kernel"], out["numpy"],
                                                deeper):
            nxt = float(sd[k]) if len(sd) > k else NEG
            swaps += check_ranking(ik, sk, i_n, sn, nxt)
            cands += len(ik)
    check(cands > 0, "the clustered index found nothing")
    # one query probes 64 of 512 clusters: about an eighth of the rows
    check(scanned["kernel"][1] < len(kidx) // 4,
          f"the routed scan of one query read {scanned['kernel'][1]} rows")
    cap = lay.bucket_rows.shape[1]
    return {"rows": len(kidx), "dim": kidx.dim, "n_clusters": REAL_C,
            "nprobe": REAL_NPROBE, "cap": cap,
            "layout_gb": REAL_C * cap * kidx.dim * 4 / 1e9,
            "queries": 33, "candidates": cands, "near_tie_swaps": swaps,
            "rows_scanned_per_search_kernel": scanned["kernel"],
            "rows_scanned_per_search_numpy": scanned["numpy"],
            "train_s": t_train, "layout_s": t_layout,
            "host_s_kernel_backend": t_search["kernel"],
            "host_s_numpy_backend": t_search["numpy"]}


# ------------------------------------------- serve: tiers and clustering

# the run_once configurations on the card: the main path (zipf defaults)
# and an eviction-heavy run; then (a) the repo's tiered config
# (benchmarks/figures.py:281-288), brute force; (b) zipf defaults with
# clustering (the hot router trains); (c) tiered and clustered at a size
# where both routers train
SERVE_RUNS = {
    "defaults": {},
    "evict": dict(cache_ratio=0.05, eviction="lcfu", n_requests=300,
                  concurrency=16),
    "a_tiered": dict(workload="longtail", n_requests=700, n_intents=688,
                     dim=64, tail_len=640, cache_ratio=0.18, concurrency=8,
                     max_ttl=1800.0, seed=31, warm_frac=0.5),
    "b_clustered": dict(workload="zipf", cluster=True),
    "c_tiered_clustered": dict(workload="longtail", n_intents=3000,
                               n_requests=3000, tail_len=2800,
                               concurrency=16, cache_ratio=0.3,
                               warm_frac=0.5, cluster=True),
}


def kernel_wrappers() -> dict:
    from repro_torch.kernels.ann_topk import ann_topk
    from repro_torch.kernels.ann_topk_ivf import (ann_topk_ivf,
                                                  ann_topk_ivf_quant)
    from repro_torch.kernels.ann_topk_quant import ann_topk_quant
    return {"ann_topk": ann_topk, "ann_topk_quant": ann_topk_quant,
            "ann_topk_ivf": ann_topk_ivf,
            "ann_topk_ivf_quant": ann_topk_ivf_quant}


def reset_counts(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0
        w.plain_calls = 0


def live_pick(active: torch.Tensor, g, b: int) -> torch.Tensor:
    live = torch.nonzero(active).flatten()
    check(live.numel() >= b, f"fewer than {b} live rows")
    return live[torch.randperm(live.numel(), device=active.device,
                               generator=g)[:b]]


def hold_on_run(cache, g, errs: dict) -> dict:
    """Each kernel against its plain version on a finished run's own
    device layout: the hot mirror, the routing centroids and the hot
    buckets, the warm mirror and the warm buckets, with queries near live
    entries, one and 16 at a time. Returns the B=1 inputs for timing."""
    from repro_torch.core.seri import probe_count
    from repro_torch.kernels.ann_topk import ann_topk, ann_topk_plain
    from repro_torch.kernels.ops import _route

    def keep(name, err):
        errs[name] = max(errs[name], err)

    top_k = cache.seri.top_k
    hot = cache.seri.index
    warm = getattr(cache, "warm", None)
    shapes = {}
    for b in (1, 16):
        q = near(hot.emb_dev[live_pick(hot.active_dev, g, b)], g)
        keep("ann_topk", hold(ann_topk, ann_topk_plain, hot.emb_dev,
                              hot.active_dev, q, top_k))
        if hot.router is not None and hot.router.ready:
            lay = hot.router.kernel_layout(hot)
            nprobe = probe_count(hot.router.cfg)
            keep("ann_topk", hold(ann_topk, ann_topk_plain, lay.centroids,
                                  lay.live, q, nprobe))
            sel, en = _route(lay.centroids, lay.live, q, nprobe)
            keep("ann_topk_ivf", hold_ivf(sel, en, q, lay.payload,
                                          lay.bucket_valid, top_k))
            if b == 1:
                shapes["ann_topk_ivf"] = (sel, en, q, lay.payload,
                                          lay.bucket_valid, top_k)
        if warm is None:
            continue
        wi = warm.index
        r = max(top_k * wi.rescore_mult, top_k)
        pick = live_pick(wi.active_dev, g, b)
        q = near(wi.emb_q_dev[pick].float() * wi.scale_dev[pick][:, None], g)
        qq, qs = quantize_dev(q)
        keep("ann_topk_quant", hold_quant(wi.emb_q_dev, wi.scale_dev,
                                          wi.active_dev, qq, qs, r))
        if b == 1:
            shapes["ann_topk_quant"] = (wi.emb_q_dev, wi.scale_dev,
                                        wi.active_dev, qq, qs, r)
        if wi.router is not None and wi.router.ready:
            lay = wi.router.kernel_layout(wi, quant=True)
            nprobe = probe_count(wi.router.cfg)
            sel, en = _route(lay.centroids, lay.live, q, nprobe)
            bq, bs = lay.payload
            keep("ann_topk_ivf_quant", hold_ivf_quant(
                sel, en, qq, qs, bq, bs, lay.bucket_valid, r))
            if b == 1:
                shapes["ann_topk_ivf_quant"] = (sel, en, qq, bq,
                                                lay.bucket_valid, r, qs, bs)
    return shapes


def phase_serve(dev):
    """run_once on the kernel backend for every configuration, each with
    every count set to 0 just before and read just after, held to the
    numpy backend key for key; then every kernel against its plain
    version on the run's own layouts, and the new kernels' times at the
    shapes of run (c)."""
    from repro_torch.launch.serve import run_once

    wrappers = kernel_wrappers()
    g = torch.Generator(device=dev).manual_seed(7)
    errs = {name: 0.0 for name in wrappers}
    runs, main = [], {}
    for name, kw in SERVE_RUNS.items():
        reset_counts(wrappers)
        t = time.perf_counter()
        got, cache = run_keeping_cache(mode="cortex", backend="kernel",
                                       device=dev, **kw)
        wall = time.perf_counter() - t
        launches = {n: w.launches for n, w in wrappers.items()}
        check(launches["ann_topk"] > 0, f"{name}: no ann_topk launch")
        check(not any(w.plain_calls for w in wrappers.values()),
              f"{name}: the CUDA path took a plain version")
        if name == "evict":
            check(got["evictions"] > 0, "the eviction run evicted nothing")
        hot_rt = cache.seri.index.router
        warm_rt = cache.warm.index.router if "warm_frac" in kw else None
        if "warm_frac" in kw:
            check(launches["ann_topk_quant"] > 0,
                  f"{name}: no ann_topk_quant launch")
            check(got["demotions"] > 0 and got["warm_hits"] > 0,
                  f"{name}: no demotion or no warm hit")
        if kw.get("cluster"):
            check(hot_rt.ready, f"{name}: the hot router never trained")
            check(launches["ann_topk_ivf"] > 0,
                  f"{name}: no ann_topk_ivf launch")
        if warm_rt is not None:
            check(warm_rt.ready, f"{name}: the warm router never trained")
            check(all(launches.values()),
                  f"{name}: not every kernel launched: {launches}")
        want = run_once(mode="cortex", backend="numpy", device="cpu", **kw)
        diff = {key: (got.get(key), want.get(key))
                for key in set(got) | set(want) if got.get(key) != want.get(key)}
        check(not diff, f"{name}: summary differs from the numpy backend: "
              f"{diff}")
        shapes = hold_on_run(cache, g, errs)
        runs.append({"run": name, "kwargs": kw, "launches": launches,
                     "wall_s": wall, "hit_rate": got["hit_rate"],
                     "evictions": got.get("evictions"),
                     "demotions": got.get("demotions"),
                     "warm_hits": got.get("warm_hits"),
                     "hot_router_ready": bool(hot_rt and hot_rt.ready),
                     "warm_router_ready": bool(warm_rt and warm_rt.ready)})
        if name == "c_tiered_clustered":
            main = {"launches": launches, "sizes": {
                "ann_topk_quant": measure_quant(*shapes["ann_topk_quant"]),
                "ann_topk_ivf": measure_ivf(*shapes["ann_topk_ivf"]),
                "ann_topk_ivf_quant": measure_ivf(
                    *shapes["ann_topk_ivf_quant"][:6],
                    quant=shapes["ann_topk_ivf_quant"][6:])}}
    return runs, errs, main


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
    quant_err, quant_cases, quant_sizes = phase_kernel_quant(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(phase="kernel_quant", cases=quant_cases, max_abs_err=quant_err,
         real_size=quant_sizes, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    ivf_err, ivfq_err, ivf_cases, ivf_sizes, ivfq_sizes = phase_kernel_ivf(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(phase="kernel_ivf", cases=ivf_cases, max_abs_err_fp32=ivf_err,
         max_abs_err_int8=ivfq_err, real_size_fp32=ivf_sizes,
         real_size_int8=ivfq_sizes, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    world, caches, stage1 = phase_stage1(dev)
    torch.cuda.synchronize()
    emit(phase="stage1", **stage1, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    emit(phase="stage1_warm", **phase_stage1_warm(dev, world, caches),
         seconds=time.perf_counter() - t)
    t = time.perf_counter()
    emit(phase="stage1_clustered",
         **phase_stage1_clustered(dev, world, caches),
         seconds=time.perf_counter() - t)
    del world, caches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    runs, serve_errs, run_c = phase_serve(dev)
    emit(phase="serve", runs=runs, max_abs_err=serve_errs,
         seconds=time.perf_counter() - t)

    main_sizes, main_err = phase_main_shape(ann_topk, ann_topk_plain, dev)
    emit(phase="main", max_abs_err=main_err)
    main = main_sizes[0]
    errs = {"ann_topk": max(max_err, main_err, serve_errs["ann_topk"]),
            "ann_topk_quant": max(quant_err, serve_errs["ann_topk_quant"]),
            "ann_topk_ivf": max(ivf_err, serve_errs["ann_topk_ivf"]),
            "ann_topk_ivf_quant": max(ivfq_err,
                                      serve_errs["ann_topk_ivf_quant"])}
    launches_by_run = {name: {r["run"]: r["launches"][name] for r in runs}
                       for name in errs}
    kernels = [{
        "name": "ann_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ann_topk.cu",
        "replaces": "src/repro/kernels/ann_topk.py:27",
        "launches": launches_by_run["ann_topk"]["defaults"],
        "launches_by_run": launches_by_run["ann_topk"],
        "max_abs_err": errs["ann_topk"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "device_ms": main["device_ms"],
        "shape": {k: main[k] for k in ("n", "d", "b", "k")},
        "sizes": main_sizes + sizes,
    }]
    new = (("ann_topk_quant", "ann_topk_quant.cu", "ann_topk_quant.py:34",
            quant_sizes),
           ("ann_topk_ivf", "ann_topk_ivf.cu", "ann_topk_ivf.py:47",
            ivf_sizes),
           ("ann_topk_ivf_quant", "ann_topk_ivf.cu", "ann_topk_ivf.py:70",
            ivfq_sizes))
    for name, source, replaces, real in new:
        at = run_c["sizes"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": run_c["launches"][name],
            "launches_by_run": launches_by_run[name],
            "max_abs_err": errs[name],
            **{key: at[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "device_ms")},
            "shape": {key: v for key, v in at.items()
                      if isinstance(v, int)},
            "sizes": [at] + real,
        })
    print(card, flush=True)
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving entry point: run the Cortex engine on a chosen workload and mode.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload zipf \
      --mode cortex --backend kernel --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --backend numpy \
      --device cpu --cache-ratio 0.05 --n-requests 300 --concurrency 16

  PYTHONPATH=src python -m repro_torch.launch.serve --workload longtail \
      --warm-frac 0.5 --cluster --backend kernel --device cuda

Stage 1 runs on the CUDA kernels by default (``backend="kernel"``,
``device="cuda"``): ``ann_topk`` for the brute scan and the routing,
``ann_topk_ivf`` for the clustered scan (``--cluster``), and
``ann_topk_quant``/``ann_topk_ivf_quant`` for the int8 warm tier
(``--warm-frac``); ``device="cpu"`` runs the kernels' plain PyTorch
versions, and ``backend="numpy"`` the host path.
Options whose subsystems are not ported yet raise ``NotImplementedError``
naming their ROADMAP slice.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.cache import make_cache
from repro_torch.core.clustering import ClusterConfig
from repro_torch.core.judge import OracleJudge
from repro_torch.core.tiers import make_tiered_cache
from repro_torch.data.workloads import (longtail_workload, swe_workload,
                                        trend_workload, zipf_workload)
from repro_torch.data.world import SemanticWorld
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.engine import Engine, EngineConfig, ExactCache
from repro_torch.serving.gpu import GPU, GPUConfig
from repro_torch.serving.remote import RemoteDataService

SHARDED = "Sharded stage 1"
FRESHNESS = "Freshness, federation, robustness"
TELEMETRY = "Observability export and telemetry"
STAGE2 = "Real stage-2 compute"


def _unported(option: str, roadmap_slice: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet (ROADMAP slice '{roadmap_slice}')")


def build_workload(world, name: str, n: int, seed: int, zipf_s: float = 0.99,
                   tail_len: int | None = None,
                   trend_duration: float | None = None):
    if name == "zipf":
        return zipf_workload(world, n, seed=seed, zipf_s=zipf_s)
    if name == "trend":
        # trend_duration compresses the same request count into a
        # shorter virtual window — the §16 burst-QPS knob (default
        # 600 s; 60 s is a 10× elevated-QPS flash crowd)
        if trend_duration is not None:
            return trend_workload(world, n, seed=seed,
                                  duration=trend_duration)
        return trend_workload(world, n, seed=seed)
    if name == "swe":
        return swe_workload(world, max(n // 5, 1), seed=seed)
    if name == "longtail":
        return longtail_workload(world, n, seed=seed, tail_len=tail_len)
    if name == "churn":
        raise _unported("workload 'churn'", FRESHNESS)
    raise ValueError(name)


def run_once(
    *,
    workload: str = "zipf",
    mode: str = "cortex",
    n_requests: int = 800,
    cache_ratio: float = 0.4,
    n_intents: int = 1000,
    dim: int = 128,
    eviction: str = "lcfu",
    concurrency: int | None = None,
    qpm: float | None = 100.0,
    colocated: bool = True,
    gpu_capacity: float | None = None,
    judge_acc: float = 0.98,
    judge_band: float | None = None,
    judge_adaptive_band: bool = False,
    judge_compute: str = "oracle",
    judge_d_model: int = 128,
    judge_max_len: int = 128,
    recalibrate_every: float | None = None,
    prefetch: bool = True,
    max_ttl: float = 3600.0,
    zipf_s: float = 0.99,
    em_p_base: float = 0.79,
    judge_timeout: float = 0.25,
    warmup_frac: float = 0.0,
    warm_frac: float | None = None,
    warm_value_ratio: float = 0.4,
    warm_access_latency: float = 0.01,
    tail_len: int | None = None,
    churn_period: float | None = None,
    invalidation: bool = False,
    refresh_ahead: bool = False,
    cluster: bool = False,
    n_clusters: int = 64,
    nprobe: int | None = 8,
    t_cache_per_row: float = 0.0,
    shards: int = 1,
    t_shard_merge: float = 0.0,
    trace: str | None = None,
    sample_interval: float | None = None,
    slo: list | None = None,
    timeseries: str | None = None,
    trend_duration: float | None = None,
    stale_age_reservoir: int | None = None,
    faults: list | None = None,
    overload: str | None = None,
    backend: str = "kernel",
    device="cuda",
    seed: int = 0,
) -> dict:
    """One engine run; the summary dict equals the reference's
    ``repro.launch.serve.run_once`` for the same arguments."""
    for option, asked, roadmap_slice in (
        ("shards > 1", shards > 1, SHARDED),
        ("churn_period", churn_period is not None, FRESHNESS),
        ("invalidation", invalidation, FRESHNESS),
        ("refresh_ahead", refresh_ahead, FRESHNESS),
        ("faults", bool(faults), FRESHNESS),
        ("overload", overload is not None, FRESHNESS),
        ("sample_interval", sample_interval is not None, TELEMETRY),
        ("slo", bool(slo), TELEMETRY),
        ("timeseries", timeseries is not None, TELEMETRY),
        ("trace", trace is not None, TELEMETRY),
        ("judge_compute='model'", judge_compute == "model", STAGE2),
    ):
        if asked:
            raise _unported(option, roadmap_slice)
    world = SemanticWorld(n_intents=n_intents, dim=dim, seed=seed)
    reqs = build_workload(world, workload, n_requests, seed + 1,
                          zipf_s=zipf_s, tail_len=tail_len,
                          trend_duration=trend_duration)
    cap = int(cache_ratio * world._sizes.sum())
    cache = exact = None
    if mode in ("cortex", "cortex-nojudge"):
        from repro_torch.core.judge_pipeline import (AdmissionBand,
                                                     JudgePipeline,
                                                     default_judge_cfg)

        oracle = OracleJudge(world, accuracy=judge_acc, seed=seed + 2)
        jcfg = default_judge_cfg(d_model=judge_d_model)
        band = None
        if judge_band is not None:
            band = AdmissionBand(width=judge_band,
                                 adaptive=judge_adaptive_band)
        # the ONE judge seam (DESIGN.md §14): admission band + model-
        # derived token cost. judge_band=None is today's engine, event
        # for event.
        judge = JudgePipeline(oracle, judge_cfg=jcfg, max_len=judge_max_len,
                              band=band)
        # clustered (IVF) stage-1 routing, DESIGN.md §12; nprobe=None
        # probes every cluster (the brute-force-parity mode)
        ccfg = ClusterConfig(
            n_clusters=n_clusters, nprobe=nprobe, seed=seed + 5,
        ) if cluster else None
        if warm_frac:
            # tiered storage at EQUAL total bytes: the warm slice comes
            # OUT of the same budget, it is never additional capacity
            warm_bytes = int(cap * warm_frac)
            # the warm tier's extra access latency is an engine-side
            # virtual-time cost: EngineConfig.t_cache_warm (below)
            cache = make_tiered_cache(
                hot_bytes=cap - warm_bytes, warm_bytes=warm_bytes,
                dim=dim, judge=judge, eviction=eviction, max_ttl=max_ttl,
                warm_value_ratio=warm_value_ratio, cluster=ccfg,
                backend=backend, device=device,
            )
        else:
            cache = make_cache(
                capacity_bytes=cap, dim=dim, judge=judge, eviction=eviction,
                max_ttl=max_ttl, cluster=ccfg, backend=backend,
                device=device,
            )
    elif mode == "exact":
        exact = ExactCache(cap, max_ttl=max_ttl)
    clock = VirtualClock()
    remote = RemoteDataService(qpm=qpm, seed=seed + 3)
    eng = Engine(
        world=world,
        requests=reqs,
        mode=mode,
        cache=cache,
        exact=exact,
        remote=remote,
        gpu=GPU(GPUConfig(colocated=colocated)
                if gpu_capacity is None else
                GPUConfig(capacity=gpu_capacity, colocated=colocated)),
        cfg=EngineConfig(
            closed_loop=concurrency,
            prefetch=prefetch,
            recalibrate_every=recalibrate_every,
            em_p_base=em_p_base,
            judge_timeout=judge_timeout,
            warmup_frac=warmup_frac,
            t_cache_warm=warm_access_latency,
            t_cache_per_row=t_cache_per_row,
            t_shard_merge=t_shard_merge,
            stale_age_reservoir=stale_age_reservoir,
            seed=seed + 4,
        ),
        clock=clock,
    )
    return eng.run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="zipf",
                    choices=["zipf", "trend", "swe", "longtail", "churn"])
    ap.add_argument("--mode", default="cortex",
                    choices=["vanilla", "exact", "cortex", "cortex-nojudge"])
    ap.add_argument("--backend", default="kernel", choices=["kernel", "numpy"],
                    help="stage 1 on the ann_topk kernel, or on the host "
                         "numpy path")
    ap.add_argument("--device", default="cuda",
                    help="device of the kernel backend's index: 'cuda' "
                         "(default; an error without CUDA) or 'cpu' (the "
                         "kernel's plain PyTorch version)")
    ap.add_argument("--n-requests", type=int, default=800)
    ap.add_argument("--cache-ratio", type=float, default=0.4)
    ap.add_argument("--eviction", default="lcfu",
                    choices=["lcfu", "lru", "lfu"])
    ap.add_argument("--concurrency", type=int, default=None)
    ap.add_argument("--qpm", type=float, default=100.0)
    ap.add_argument("--no-rate-limit", action="store_true")
    ap.add_argument("--dedicated-judge", action="store_true")
    ap.add_argument("--gpu-capacity", type=float, default=None,
                    help="per-chip token-eq/s budget (default 3000); with "
                         "--dedicated-judge, 1500 matches the colocated "
                         "single-chip budget (the Fig 6 comparison)")
    ap.add_argument("--judge-band", type=float, default=None,
                    help="adaptive-admission band width around tau_sim "
                         "(DESIGN.md §14); None/0 = judge everything")
    ap.add_argument("--judge-adaptive-band", action="store_true",
                    help="recalibrate the band width alongside tau_lsm "
                         "(needs --recalibrate-every)")
    ap.add_argument("--judge-compute", default="oracle",
                    choices=["oracle", "model"],
                    help="'model' (real tiny-LM prefill) is not ported yet")
    ap.add_argument("--judge-d-model", type=int, default=128,
                    help="judge model width; sets the FLOPs-derived "
                         "judge token cost (16.0 token-eq at 128)")
    ap.add_argument("--judge-max-len", type=int, default=128,
                    help="judge prefill length in tokens")
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--recalibrate-every", type=float, default=None)
    ap.add_argument("--t-cache-per-row", type=float, default=0.0,
                    help="stage-1 latency per row scanned (the scan-"
                         "proportional model; 0 = legacy flat cost)")
    ap.add_argument("--warm-frac", type=float, default=None,
                    help="split this fraction of the byte budget into an "
                         "int8/zlib warm tier (DESIGN.md §10)")
    ap.add_argument("--cluster", action="store_true",
                    help="clustered (IVF) stage-1 routing (DESIGN.md §12)")
    ap.add_argument("--n-clusters", type=int, default=64)
    ap.add_argument("--nprobe", type=int, default=8,
                    help="clusters probed per query; 0 = all (the "
                         "brute-force-parity mode)")
    ap.add_argument("--trend-duration", type=float, default=None,
                    help="trend workload: compress the same requests "
                         "into this many virtual seconds (default 600)")
    ap.add_argument("--stale-age-reservoir", type=int, default=None,
                    help="bound the stale-age histogram's raw samples "
                         "to a seeded reservoir of this size")
    # options of subsystems not ported yet: accepted so that asking for
    # them names the ROADMAP slice instead of failing to parse
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--churn-period", type=float, default=None)
    ap.add_argument("--invalidation", action="store_true")
    ap.add_argument("--refresh-ahead", action="store_true")
    ap.add_argument("--faults", action="append", default=None)
    ap.add_argument("--overload", default=None, choices=["on", "off"])
    ap.add_argument("--sample-interval", type=float, default=None)
    ap.add_argument("--slo", action="append", default=None)
    ap.add_argument("--timeseries", default=None)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--regions", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.regions > 1:
        raise _unported("regions > 1", FRESHNESS)
    s = run_once(
        workload=args.workload,
        mode=args.mode,
        n_requests=args.n_requests,
        cache_ratio=args.cache_ratio,
        eviction=args.eviction,
        concurrency=args.concurrency,
        qpm=None if args.no_rate_limit else args.qpm,
        colocated=not args.dedicated_judge,
        gpu_capacity=args.gpu_capacity,
        judge_band=args.judge_band,
        judge_adaptive_band=args.judge_adaptive_band,
        judge_compute=args.judge_compute,
        judge_d_model=args.judge_d_model,
        judge_max_len=args.judge_max_len,
        recalibrate_every=args.recalibrate_every,
        prefetch=not args.no_prefetch,
        warm_frac=args.warm_frac,
        churn_period=args.churn_period,
        invalidation=args.invalidation,
        refresh_ahead=args.refresh_ahead,
        cluster=args.cluster,
        n_clusters=args.n_clusters,
        nprobe=args.nprobe or None,
        t_cache_per_row=args.t_cache_per_row,
        shards=args.shards,
        trace=args.trace,
        sample_interval=args.sample_interval,
        slo=args.slo,
        timeseries=args.timeseries,
        trend_duration=args.trend_duration,
        stale_age_reservoir=args.stale_age_reservoir,
        faults=args.faults,
        overload=args.overload,
        backend=args.backend,
        device=args.device,
        seed=args.seed,
    )
    print(json.dumps(s, indent=2, default=float))
    return s


if __name__ == "__main__":
    main()

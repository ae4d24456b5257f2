"""Serving entry point: run the Cortex engine on a chosen workload and mode.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload zipf \
      --mode cortex --backend kernel --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --backend numpy \
      --device cpu --cache-ratio 0.05 --n-requests 300 --concurrency 16

  PYTHONPATH=src python -m repro_torch.launch.serve --workload longtail \
      --warm-frac 0.5 --cluster --backend kernel --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --cluster --shards 8 \
      --t-cache-per-row 2e-5 --t-shard-merge 1e-4 --backend kernel

Stage 1 runs on the CUDA kernels by default (``backend="kernel"``,
``device="cuda"``): ``ann_topk`` for the brute scan and the routing,
``ann_topk_ivf`` for the clustered scan (``--cluster``),
``ann_topk_quant``/``ann_topk_ivf_quant`` for the int8 warm tier
(``--warm-frac``), and ``ann_topk_ivf_sharded``/
``ann_topk_ivf_quant_sharded`` for the clustered scans partitioned into
cluster-ownership shards (``--shards``, every shard on the one device);
``device="cpu"`` runs the kernels' plain PyTorch
versions, and ``backend="numpy"`` the host path. ``--judge-compute model``
also pays the tiny-LM judge's prefill on ``device`` (its attention the
``flash_attention_fwd`` kernel) for every judge micro-batch; decisions
stay the oracle's, so the summary is the oracle run's.

  PYTHONPATH=src python -m repro_torch.launch.serve --judge-compute model \
      --device cpu

Freshness (``--churn-period``, ``--invalidation``, ``--refresh-ahead``)
drops and rewrites rows of the device mirrors mid-run; ``--regions N``
runs a federation with one cache, and so one set of mirrors, per region:

  PYTHONPATH=src python -m repro_torch.launch.serve --workload churn \
      --churn-period 20 --invalidation --refresh-ahead
  PYTHONPATH=src python -m repro_torch.launch.serve --workload trend \
      --trend-duration 12 --sample-interval 5 --overload on \
      --slo p99:window.latency_p99:<=:5.0 \
      --faults origin_brownout:50:150:error_rate=0.6,throttle=0.2 \
      --trace build/tr --timeseries build/ts
  PYTHONPATH=src python -m repro_torch.launch.serve --regions 3 \
      --topology peered --peek-timeout 0.25 \
      --faults region_outage:20:45:region=1
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.cache import make_cache
from repro_torch.core.clustering import ClusterConfig
from repro_torch.core.freshness import (ChangeFeed, FreshnessConfig,
                                        FreshnessManager)
from repro_torch.core.judge import OracleJudge
from repro_torch.core.tiers import make_tiered_cache
from repro_torch.data.workloads import (churn_workload, longtail_workload,
                                        swe_workload, trend_workload,
                                        zipf_workload)
from repro_torch.data.world import MutableWorld, SemanticWorld
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.engine import Engine, EngineConfig, ExactCache
from repro_torch.serving.gpu import GPU, GPUConfig
from repro_torch.serving.remote import RemoteDataService

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
        return churn_workload(world, n, seed=seed, zipf_s=zipf_s)
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
    churn_max_period: float | None = None,
    churn_frac: float = 1.0,
    invalidation: bool = False,
    refresh_ahead: bool = False,
    feed_delay: float = 0.15,
    refresh_min_freq: int = 1,
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
    # churn_period switches the ground truth to a MutableWorld whose
    # low-staticity intents update every churn_period seconds (DESIGN.md
    # §11); None keeps the immutable world, and stale_hits stays 0.
    if churn_period is not None:
        world = MutableWorld(
            n_intents=n_intents, dim=dim, seed=seed,
            churn_min_period=churn_period,
            churn_max_period=churn_max_period or churn_period * 8.0,
            churn_frac=churn_frac,
        )
    else:
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
        model = None
        if judge_compute == "model":
            # pay real tiny-LM prefill per judge micro-batch (the
            # calibration shim: oracle decisions, model compute)
            from repro_torch.core.judge import ModelJudge

            model = ModelJudge(cfg=jcfg, max_len=judge_max_len,
                               seed=seed + 6, device=device)
        # the ONE judge seam (DESIGN.md §14): admission band + model-
        # derived token cost + optional real compute. judge_band=None
        # (and oracle compute) is today's engine, event for event.
        judge = JudgePipeline(oracle, compute=model, judge_cfg=jcfg,
                              max_len=judge_max_len, band=band)
        # clustered (IVF) stage-1 routing, DESIGN.md §12; nprobe=None
        # probes every cluster (the brute-force-parity mode). shards>1
        # (the §13 cluster-ownership partition) requires the router, so
        # it implies --cluster on its own.
        ccfg = ClusterConfig(
            n_clusters=n_clusters, nprobe=nprobe, seed=seed + 5,
            n_shards=max(1, shards),
        ) if (cluster or shards > 1) else None
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
    # §17 fault injection: parse --faults specs into a FaultSchedule
    # (brownouts live in the remote service, judge slowdown in the
    # engine); None = today's fault-free run, byte-identical
    fault_sched = None
    if faults:
        from repro_torch.serving.faults import FaultSchedule

        fault_sched = (faults if hasattr(faults, "region_down")
                       else FaultSchedule.parse(faults))
    remote = RemoteDataService(qpm=qpm, seed=seed + 3, faults=fault_sched)
    freshness = None
    if cache is not None and (invalidation or refresh_ahead):
        # invalidation drops rows of the index mirrors, refresh-ahead
        # rewrites a live entry in place
        feed = ChangeFeed(world, clock) if invalidation else None
        freshness = FreshnessManager(
            cache=cache, remote=remote, world=world, clock=clock,
            cfg=FreshnessConfig(
                invalidation=invalidation, refresh_ahead=refresh_ahead,
                feed_delay=feed_delay, refresh_min_freq=refresh_min_freq,
            ),
            feed=feed,
        )
    tracer = None
    if trace is not None:
        from repro_torch.obs.trace import Tracer

        tracer = Tracer()
    # §16 monitor is created BEFORE the engine so the §17 overload
    # controller can read its breach state; the sampler that feeds it
    # starts right after construction (ordering only — no behavior
    # change for telemetry-only runs)
    sampler = monitor = None
    if slo and sample_interval is None:
        raise ValueError("slo requires sample_interval")
    if timeseries is not None and sample_interval is None:
        raise ValueError("timeseries requires sample_interval")
    if sample_interval is not None and slo:
        from repro_torch.obs.slo import SLOMonitor

        monitor = SLOMonitor(slo, tracer=tracer)
    ctrl = None
    if overload is not None:
        if overload not in ("on", "off"):
            raise ValueError(f"overload must be 'on'/'off', got {overload!r}")
        from repro_torch.serving.overload import (OverloadConfig,
                                                  OverloadController)

        ctrl = OverloadController(
            OverloadConfig(enabled=(overload == "on")),
            monitor=monitor, tracer=tracer,
        )
        if freshness is not None:
            freshness.overload = ctrl
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
        freshness=freshness,
        tracer=tracer,
        overload=ctrl,
        faults=fault_sched,
    )
    # §16 continuous telemetry: interval sampling of the registry +
    # optional SLO monitoring (monitor built above). Strictly
    # observational — with these off the engine sees the exact same
    # event stream (gated byte-identical).
    if sample_interval is not None:
        from repro_torch.obs.sampler import TimeSeriesSampler

        sampler = TimeSeriesSampler(clock, sample_interval, [eng],
                                    monitor=monitor)
        sampler.start()
    out = eng.run()
    if sampler is not None:
        sampler.finalize()
        # telemetry-enabled runs get extra keys ONLY — with
        # sample_interval=None the summary is byte-identical
        out["timeseries_samples"] = len(sampler.samples)
        if monitor is not None:
            out["slo_breaches"] = monitor.breaches
            out["slo_recoveries"] = monitor.recoveries
        if timeseries is not None:
            from repro_torch.obs.export import export_timeseries

            paths = export_timeseries(sampler, monitor, timeseries)
            out["timeseries_path"] = paths["timeseries"]
            if "alerts" in paths:
                out["alerts_path"] = paths["alerts"]
    if tracer is not None:
        from repro_torch.obs.analyze import check_conservation
        from repro_torch.obs.export import export_trace

        paths = export_trace(tracer, trace)
        violations = check_conservation(tracer, eng.records)
        # traced runs get extra keys ONLY — with trace=None the summary
        # is byte-identical to the untraced engine's
        out["trace_jsonl"] = paths["jsonl"]
        out["trace_chrome"] = paths["chrome"]
        out["trace_spans"] = len(tracer.spans)
        out["trace_conservation_violations"] = len(violations)
        if violations:
            raise AssertionError(
                "span conservation violated:\n" + "\n".join(violations[:20])
            )
    return out


def run_federated(
    *,
    n_regions: int = 3,
    topology: str = "peered",
    n_requests: int = 300,
    n_intents: int = 300,
    dim: int = 64,
    overlap: float = 0.5,
    rtt: float = 0.08,
    faults: list | None = None,
    peek_timeout: float | None = None,
    overload: str | None = None,
    sample_interval: float | None = None,
    slo: list | None = None,
    trace: str | None = None,
    backend: str = "kernel",
    device="cuda",
    seed: int = 0,
) -> dict:
    """Multi-region entry point (--regions > 1): region-skewed request
    streams through a FederationRunner, with the §17 robustness knobs
    (--faults / --peek-timeout / --overload) on the federation path.
    Every region's stage 1 runs on ``backend`` over its own index mirror
    on ``device``. Returns the runner's {aggregate, regions} summary,
    equal to the reference's ``repro.launch.serve.run_federated``."""
    from repro_torch.data.workloads import region_workloads
    from repro_torch.serving.federation import FederationRunner

    world = SemanticWorld(n_intents=n_intents, dim=dim, seed=seed)
    streams = region_workloads(
        world, max(n_requests // n_regions, 1), n_regions,
        overlap=overlap, seed=seed + 1,
    )
    tracer = None
    if trace is not None:
        from repro_torch.obs.trace import Tracer

        tracer = Tracer()
    runner = FederationRunner(
        world=world, region_requests=streams, topology=topology,
        rtt=rtt, faults=faults or None, peek_timeout=peek_timeout,
        overload=overload, tracer=tracer,
        sample_interval=sample_interval, slos=slo, backend=backend,
        device=device, seed=seed,
    )
    out = runner.run()
    if tracer is not None:
        from repro_torch.obs.export import export_trace

        paths = export_trace(tracer, trace)
        out["aggregate"]["trace_jsonl"] = paths["jsonl"]
        out["aggregate"]["trace_spans"] = len(tracer.spans)
    return out


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
                    help="device of the kernel backend's index and of the "
                         "model judge: 'cuda' (default; an error without "
                         "CUDA) or 'cpu' (the kernels' plain PyTorch "
                         "versions)")
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
                    help="'model' pays real tiny-LM prefill per judge "
                         "micro-batch on --device (decisions stay "
                         "oracle-faithful)")
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
    ap.add_argument("--shards", type=int, default=1,
                    help="partition the stage-1 index into this many "
                         "cluster-ownership shards (DESIGN.md §13; "
                         "implies --cluster)")
    ap.add_argument("--t-shard-merge", type=float, default=0.0,
                    help="cross-shard top-k merge cost per stage-1 pass "
                         "(only charged when --shards > 1)")
    ap.add_argument("--trend-duration", type=float, default=None,
                    help="trend workload: compress the same requests "
                         "into this many virtual seconds (default 600)")
    ap.add_argument("--stale-age-reservoir", type=int, default=None,
                    help="bound the stale-age histogram's raw samples "
                         "to a seeded reservoir of this size")
    ap.add_argument("--churn-period", type=float, default=None,
                    help="mutable world: class-1 intents update every this"
                         " many seconds (DESIGN.md §11)")
    ap.add_argument("--invalidation", action="store_true",
                    help="subscribe the cache to the origin change feed")
    ap.add_argument("--refresh-ahead", action="store_true",
                    help="revalidate hot entries instead of dropping them")
    ap.add_argument("--trace", default=None, metavar="PREFIX",
                    help="record a request-lifecycle trace (DESIGN.md "
                         "§15): writes PREFIX.jsonl + PREFIX.chrome.json "
                         "(Perfetto-loadable) and verifies the span "
                         "conservation law")
    ap.add_argument("--sample-interval", type=float, default=None,
                    metavar="SECONDS",
                    help="continuous telemetry (DESIGN.md §16): sample "
                         "the metrics registry every this many VIRTUAL "
                         "seconds; strictly observational")
    ap.add_argument("--slo", action="append", default=None, metavar="SPEC",
                    help="declarative SLO (repeatable; needs "
                         "--sample-interval): "
                         "name:metric:op:bound[:breach_after[:recover_"
                         "after]], e.g. p99:window.latency_p99:<=:3.0:2:2")
    ap.add_argument("--timeseries", default=None, metavar="PREFIX",
                    help="write PREFIX.timeseries.jsonl (+ PREFIX.alerts"
                         ".jsonl when --slo is set); needs "
                         "--sample-interval")
    ap.add_argument("--faults", action="append", default=None,
                    metavar="SPEC",
                    help="inject a deterministic fault window (DESIGN.md "
                         "§17; repeatable): kind:start:end[:k=v,...], "
                         "kinds region_outage / wan_degrade / "
                         "origin_brownout / judge_slowdown")
    ap.add_argument("--overload", default=None, choices=["on", "off"],
                    help="arm the §17 OverloadController ('off' = armed "
                         "but every policy disabled)")
    ap.add_argument("--peek-timeout", type=float, default=None,
                    help="federation peek deadline in seconds (§17, "
                         "needs --regions > 1): a silent peer counts as "
                         "a NAK, with a per-peer circuit breaker")
    ap.add_argument("--regions", type=int, default=1,
                    help="run a multi-region federation of this many "
                         "regions, one cache (one set of index mirrors on "
                         "--device) per region, instead of the solo "
                         "engine")
    ap.add_argument("--topology", default="peered",
                    choices=["local", "peered", "global"],
                    help="federation topology for --regions > 1")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.regions > 1:
        s = run_federated(
            n_regions=args.regions,
            topology=args.topology,
            n_requests=args.n_requests,
            faults=args.faults,
            peek_timeout=args.peek_timeout,
            overload=args.overload,
            sample_interval=args.sample_interval,
            slo=args.slo,
            trace=args.trace,
            backend=args.backend,
            device=args.device,
            seed=args.seed,
        )
        print(json.dumps(s, indent=2, default=float))
        return s

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
        t_shard_merge=args.t_shard_merge,
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

"""End-to-end serving (the paper's primary scenario), the port of
the reference's ``examples/serve_cortex.py``: a search agent serving
batched requests behind the Cortex cache, compared against the vanilla
and exact-match baselines on a Zipf-0.99 workload. The cortex mode's
stage 1 runs on kernel 1 (``ann_topk``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_cortex [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.examples import printer
from repro_torch.launch.serve import run_once

MODES = ("vanilla", "exact", "cortex")


def serve_cortex(device="cuda", backend: str = "kernel",
                 n_requests: int = 600) -> tuple[list[str], dict]:
    """The three modes at ``n_requests`` on ``backend`` / ``device``:
    ``(lines, {mode: run_once's summary})``, the lines printed."""
    lines, say = printer()
    summaries = {}

    say(f"{'mode':16s} {'thpt':>6s} {'lat':>7s} {'p99':>7s} {'hit%':>6s} "
        f"{'API':>5s} {'$':>7s} {'EM':>5s}")
    for mode in MODES:
        s = summaries[mode] = run_once(
            workload="zipf", mode=mode, n_requests=n_requests,
            cache_ratio=0.4, concurrency=8, seed=0, backend=backend,
            device=device,
        )
        say(f"{mode:16s} {s['throughput_rps']:6.2f} "
            f"{s['latency_mean']:7.2f} {s['latency_p99']:7.2f} "
            f"{s['hit_rate']*100:6.1f} {s['api_calls']:5d} "
            f"{s['cost_total']:7.2f} {s['em']:5.3f}")
    say("\n(cortex converts paraphrase locality into hits; vanilla/exact are "
        "pinned by the 100 QPM rate limit — paper Figs 7/10)")
    return lines, summaries


def main(argv=None) -> tuple[list[str], dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_cortex(resolve_device(args.device))


if __name__ == "__main__":
    main()

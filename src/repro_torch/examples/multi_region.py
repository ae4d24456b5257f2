"""Multi-region federation demo (DESIGN.md §9), the port of the
reference's ``examples/multi_region.py``.

Three agent regions — US (cheap fast WAN), EU, and APAC (slow expensive
WAN, tight rate limit) — each run their own Cortex cache against a
region-skewed workload with 60% shared-hot overlap, on ONE shared
virtual clock. On a local miss the federation router peeks sibling
caches at inter-region RTT and transfers the value (with provenance and
the source entry's remaining TTL) before paying the origin WAN fetch.
Each region's stage 1 runs on kernel 1 (``ann_topk``) over its own index
mirror on the device.

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_region [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.data.workloads import region_workloads
from repro_torch.data.world import SemanticWorld
from repro_torch.device import resolve_device
from repro_torch.examples import printer
from repro_torch.serving.federation import FederationRunner, RegionConfig

REGIONS = [
    RegionConfig(name="us", wan_lat_lo=0.25, wan_lat_hi=0.4,
                 wan_cost=0.004, qpm=120.0),
    RegionConfig(name="eu", wan_lat_lo=0.3, wan_lat_hi=0.5,
                 wan_cost=0.005, qpm=100.0),
    RegionConfig(name="apac", wan_lat_lo=0.45, wan_lat_hi=0.7,
                 wan_cost=0.008, qpm=60.0),
]

# asymmetric WAN: us<->eu is close, apac is far from both
RTT = np.array([
    [0.00, 0.07, 0.14],
    [0.07, 0.00, 0.16],
    [0.14, 0.16, 0.00],
])

TOPOLOGIES = ("local", "peered", "global")


def multi_region(device="cuda", backend: str = "kernel",
                 n_requests: int = 250) -> tuple[list[str], dict]:
    """The three topologies at ``n_requests`` a region on ``backend`` /
    ``device``: ``(lines, {topology: the runner's summary})``, the lines
    printed."""
    lines, say = printer()
    summaries = {}

    world = SemanticWorld(n_intents=500, dim=64, seed=42)
    streams = region_workloads(world, n_requests, len(REGIONS), overlap=0.6,
                               seed=43)
    say(f"{'topology':<8} {'lat_ms':>8} {'remote_ms':>10} {'hit':>6} "
        f"{'peer_hit':>9} {'api':>5} {'cost_$':>7}")
    for topo in TOPOLOGIES:
        runner = FederationRunner(
            world=world, region_requests=streams, topology=topo,
            region_cfgs=REGIONS, rtt=RTT, seed=44, backend=backend,
            device=device,
        )
        s = summaries[topo] = runner.run()
        a = s["aggregate"]
        say(f"{topo:<8} {a['latency_mean']*1e3:>8.1f} "
            f"{a['remote_time_mean']*1e3:>10.1f} {a['hit_rate']:>6.3f} "
            f"{a['peer_hit_rate']:>9.3f} {a['api_calls']:>5} "
            f"{a['api_cost']:>7.3f}")
        if topo == "peered":
            say("  per-region (peered):")
            for name, rs in s["regions"].items():
                say(f"    {name:<5} lat={rs['latency_mean']*1e3:.1f}ms "
                    f"remote={rs['remote_time_mean']*1e3:.1f}ms "
                    f"hit={rs['hit_rate']:.3f} "
                    f"peer_transfers={rs['peer_transfers']} "
                    f"api={rs['api_calls']}")
            fs = runner.federation.stats
            say(f"  federation: peeks={fs.peeks} "
                f"peer_hits={fs.peer_hits} "
                f"transfer_kb={fs.transfer_bytes/1e3:.1f} "
                f"expired_leases={fs.expired_leases}")
    return lines, summaries


def main(argv=None) -> tuple[list[str], dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return multi_region(resolve_device(args.device))


if __name__ == "__main__":
    main()

"""Quickstart: the Cortex semantic cache in ~60 lines, the port of the
reference's ``examples/quickstart.py``.

Builds a synthetic semantic world, inserts a few tool results, and shows
the two-stage semantic hit pipeline, the confusable-pair rejection (why
the judge exists), LCFU eviction and TTL aging. Stage 1 runs on kernel 1
(``ann_topk``) over an index mirrored on the device.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.cache import make_cache
from repro_torch.core.judge import OracleJudge
from repro_torch.data.world import SemanticWorld
from repro_torch.device import resolve_device
from repro_torch.examples import printer


def quickstart(device="cuda", backend: str = "kernel") -> list[str]:
    """The walk-through on a cache whose stage 1 is ``backend`` on
    ``device``; prints its lines and returns them."""
    lines, say = printer()

    world = SemanticWorld(n_intents=100, dim=64, seed=0)
    judge = OracleJudge(world, accuracy=1.0, seed=0)
    cache = make_cache(
        capacity_bytes=50_000, dim=world.dim, judge=judge,
        tau_sim=0.9, tau_lsm=0.9, max_ttl=600.0, backend=backend,
        device=device,
    )

    # 1. miss -> fetch remotely -> admit as a Semantic Element
    q0 = world.query(intent=7, paraphrase=0)
    emb0 = world.embed(q0)
    res = cache.lookup(q0, emb0, now=0.0)
    say(f"first lookup: hit={res.hit}  (cold cache)")
    cache.insert(q0, emb0, world.fetch(q0), now=0.0, cost=0.005,
                 latency=0.4, size=world.value_size(q0))

    # 2. a *paraphrase* of the same intent -> semantic HIT (exact-match
    # would miss)
    q1 = world.query(intent=7, paraphrase=13)
    res = cache.lookup(q1, world.embed(q1), now=1.0)
    say(f"paraphrase lookup: hit={res.hit}  value={res.se.value!r}")

    # 3. a confusable intent (cos ~ 0.93 > tau_sim!) -> ANN candidate,
    # judge REJECTS
    pair = world.intents[7].confusable_with
    if pair is None:
        pair = next(i.iid for i in world.intents
                    if i.confusable_with is not None)
        qx = world.query(pair, 0)
        cache.insert(qx, world.embed(qx), world.fetch(qx), now=1.0,
                     cost=0.005, latency=0.4, size=world.value_size(qx))
        pair = world.intents[pair].confusable_with
    qc = world.query(pair, 2)
    res = cache.lookup(qc, world.embed(qc), now=2.0)
    say(f"confusable lookup: candidates={res.n_candidates} hit={res.hit} "
        f"(judge rejected a false positive)")

    # 4. LCFU: fill beyond capacity; cheap/ephemeral items are evicted
    # first
    now = 3.0
    for i in range(30, 60):
        q = world.query(i, 0)
        cache.insert(q, world.embed(q), world.fetch(q), now=now, cost=0.005,
                     latency=0.4, size=world.value_size(q))
        now += 0.1
    say(f"after pressure: items={len(cache)} "
        f"evictions={cache.stats.evictions} "
        f"usage={cache.usage}/{cache.capacity_bytes}B")

    # 5. TTL aging: ephemeral items (staticity 1-3) expire quickly
    expired = cache.purge_expired(now + 3600.0)
    say(f"after 1h: {expired} items TTL-expired, {len(cache)} remain")
    say(f"stats: {cache.stats}")
    return lines


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return quickstart(resolve_device(args.device))


if __name__ == "__main__":
    main()

"""Unified metrics registry + shared statistics helpers (DESIGN.md §15).

Three things live here:

* :func:`percentile` — THE percentile used repo-wide (engine summary,
  federation summary, benchmark figures, trace attribution). One pinned
  interpolation method, so a quantile in a BENCH gate and the same
  quantile in a trace report can never drift apart.
* :class:`FixedHistogram` — a fixed-bucket histogram that *keeps its raw
  values*. The legacy summary computed ``np.mean(list)`` over raw
  samples; numpy's pairwise summation is not bit-equal to a running
  ``sum/count``, so a histogram that only kept bucket counts could not
  reproduce the legacy ``stale_age_mean`` byte-for-byte.
* :class:`MetricsRegistry` — a pull-based registry: components register
  *collector* callables under a namespace, ``snapshot()`` flattens them
  into one ``"ns.key" -> value`` dict, and ``delta()`` subtracts two
  snapshots. Pull-based means the existing increment sites
  (``CacheStats``, ``PipelineStats``, ``TierStats``, remote counters…)
  keep their exact code paths — the registry observes them, so every
  legacy number stays bit-identical while ``summary()`` is rebuilt on
  top of ``snapshot()``.

:class:`ScanMetrics` gives the stage-1 scan-volume counters (previously
ad-hoc ``CortexCache`` instance attributes, deliberately outside
``CacheStats``) a first-class home with the batch-granularity
caveat documented where the numbers are defined.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

# stale-age bucket edges (seconds) — the §11 staleness histogram
STALE_AGE_EDGES = (30.0, 60.0, 120.0, 300.0, 600.0, 1800.0)


def percentile(values: Sequence[float] | np.ndarray, q: float) -> float:
    """Repo-wide percentile: linear interpolation, pinned explicitly.

    ``np.percentile``'s default *is* linear today, but the repo's
    bit-identity gates compare quantiles computed in three different
    modules — pinning the method here makes that contract explicit and
    survives a numpy default change.
    """
    return float(np.percentile(np.asarray(values), q, method="linear"))


class FixedHistogram:
    """Fixed-bucket histogram over ``[0, e0), [e0, e1), …, [e_last, inf)``.

    Two retention modes:

    * **raw (default, ``max_samples=None``)** — keeps every sample:
      bucket counts are derived on demand, and ``mean`` is
      ``np.mean(values)`` — bit-identical to the pre-registry summary
      code that held a bare ``list[float]``. Sample volume on the
      stale-age path is small (one float per *stale* serve), so raw
      retention is the right default and the ``stale_age_mean``
      bit-parity contract is untouched.
    * **bounded reservoir (``max_samples=N``)** — for long burst runs:
      ``values`` holds a deterministic (seeded) Algorithm-R reservoir of
      at most N samples, while bucket counts and the mean come from
      exact incremental counters (``count`` / running sum) — the
      histogram and mean stay exact at any volume; only the raw-sample
      *list* is bounded. The reservoir RNG is private and only consumed
      in this mode, so default-mode behavior is untouched.
    """

    __slots__ = ("edges", "values", "max_samples", "count",
                 "_counts", "_sum", "_rng")

    def __init__(self, edges: Sequence[float] = STALE_AGE_EDGES, *,
                 max_samples: int | None = None, seed: int = 0):
        self.edges = tuple(float(e) for e in edges)
        self.values: list[float] = []
        if max_samples is not None and max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self.max_samples = max_samples
        self.count = 0
        # exact incremental bucket counts (len(edges)+1 buckets) + sum:
        # only consulted in reservoir mode, maintained in both
        self._counts = [0] * (len(self.edges) + 1)
        self._sum = 0.0
        self._rng = (np.random.default_rng(seed)
                     if max_samples is not None else None)

    def _bucket(self, v: float) -> int:
        for i, hi in enumerate(self.edges):
            if v < hi:
                return i
        return len(self.edges)

    def add(self, v: float) -> None:
        self._counts[self._bucket(v)] += 1
        self._sum += v
        self.count += 1
        if self.max_samples is None:
            self.values.append(v)
        elif len(self.values) < self.max_samples:
            self.values.append(v)
        else:
            # Algorithm R: the i-th sample (1-based) replaces a resident
            # with probability N/i — seeded, so deterministic
            j = int(self._rng.integers(0, self.count))
            if j < self.max_samples:
                self.values[j] = v

    def __len__(self) -> int:
        """Total samples *added* (== ``len(values)`` in raw mode; may
        exceed it in reservoir mode)."""
        return self.count

    def to_dict(self) -> dict[str, int]:
        """Bucket counts under the legacy summary keys: ``"0-30"``,
        ``"30-60"``, …, ``"1800+"`` (``%g``-formatted edges). Exact in
        BOTH modes — reservoir mode reads the incremental counters."""
        if self.max_samples is None:
            hist: dict[str, int] = {}
            lo = 0.0
            for hi in self.edges:
                hist[f"{lo:g}-{hi:g}"] = sum(
                    1 for a in self.values if lo <= a < hi
                )
                lo = hi
            hist[f"{lo:g}+"] = sum(1 for a in self.values if a >= lo)
            return hist
        hist = {}
        lo = 0.0
        for i, hi in enumerate(self.edges):
            hist[f"{lo:g}-{hi:g}"] = self._counts[i]
            lo = hi
        hist[f"{lo:g}+"] = self._counts[len(self.edges)]
        return hist

    @property
    def mean(self) -> float:
        """Raw mode: ``np.mean(values)`` (the bit-parity contract).
        Reservoir mode: exact running ``sum/count`` over EVERY sample —
        not an estimate from the reservoir."""
        if self.max_samples is None:
            return float(np.mean(self.values)) if self.values else 0.0
        return self._sum / self.count if self.count else 0.0


@dataclasses.dataclass
class ScanMetrics:
    """Stage-1 scan-volume counters (DESIGN.md §12/§13).

    **Batch-granularity caveat**: stage 1 runs as *batched passes* — one
    masked matmul over every query that co-arrived in the host window —
    so ``last_rows`` is rows touched by the last PASS, not the last
    query, and ``total_rows`` advances once per pass. Dividing
    ``total_rows`` by per-query ``lookups`` (as ``rows_per_lookup``
    does) is therefore an *amortized* per-query figure: co-batched
    queries share one scan. ``last_max_shard_rows`` is the busiest
    shard's slice of the last pass — the quantity the §13 latency model
    charges (shards stream in parallel); at one shard it equals
    ``last_rows``.
    """

    last_rows: int = 0            # rows scanned by the last stage-1 pass
    total_rows: int = 0           # cumulative rows over all passes
    last_max_shard_rows: int = 0  # busiest shard's rows, last pass (§13)
    total_max_shard_rows: int = 0 # cumulative max-shard rows

    def note_pass(self, rows: int, max_shard_rows: int | None = None) -> None:
        """Record one stage-1 pass. ``max_shard_rows`` defaults to
        ``rows`` (the unsharded index IS one shard)."""
        m = rows if max_shard_rows is None else max_shard_rows
        self.last_rows = int(rows)
        self.total_rows += int(rows)
        self.last_max_shard_rows = int(m)
        self.total_max_shard_rows += int(m)

    def add_warm_pass(self, rows: int, max_shard_rows: int | None = None) -> None:
        """Fold a warm-tier consult into the CURRENT pass (§10): the hot
        and warm scans of one flush count as one pass's volume."""
        m = rows if max_shard_rows is None else max_shard_rows
        self.last_rows += int(rows)
        self.total_rows += int(rows)
        self.last_max_shard_rows += int(m)
        self.total_max_shard_rows += int(m)


class MetricsRegistry:
    """Pull-based metrics registry.

    Components ``register(namespace, collector)`` where ``collector`` is
    a zero-arg callable returning a flat ``{key: number-or-hist-dict}``
    mapping. ``snapshot()`` invokes every collector and flattens to
    ``"namespace.key"`` — a point-in-time copy safe to stash (the
    engine's warm-up snapshot) or diff (:meth:`delta`).
    """

    def __init__(self):
        self._collectors: list[tuple[str, Callable[[], Mapping]]] = []

    def register(self, namespace: str, collector: Callable[[], Mapping]) -> None:
        """Idempotent per namespace: re-registering REPLACES the prior
        collector in place (keeping its snapshot position), so engines
        rebuilt inside a sweep loop sharing one registry can't silently
        double-collect — the last registration wins."""
        for i, (ns, _) in enumerate(self._collectors):
            if ns == namespace:
                self._collectors[i] = (namespace, collector)
                return
        self._collectors.append((namespace, collector))

    def unregister(self, namespace: str) -> bool:
        """Drop a namespace's collector; returns whether it existed."""
        for i, (ns, _) in enumerate(self._collectors):
            if ns == namespace:
                del self._collectors[i]
                return True
        return False

    def namespaces(self) -> list[str]:
        return [ns for ns, _ in self._collectors]

    def snapshot(self) -> dict[str, float | int | dict]:
        out: dict[str, float | int | dict] = {}
        for ns, collect in self._collectors:
            for k, v in collect().items():
                out[f"{ns}.{k}"] = v
        return out

    @staticmethod
    def delta(cur: Mapping, base: Mapping) -> dict:
        """``cur - base`` for every numeric key in ``cur`` (missing base
        keys count as 0; non-numeric values pass through from ``cur``)."""
        out = {}
        for k, v in cur.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                out[k] = v
            else:
                b = base.get(k, 0)
                b = b if isinstance(b, (int, float)) and \
                    not isinstance(b, bool) else 0
                out[k] = v - b
        return out

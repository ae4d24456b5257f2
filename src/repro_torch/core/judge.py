"""The lightweight semantic judge (LSM) — Seri stage 2 (paper §4.2).

Given (new query, cached result) the judge emits a confidence score
S_lsm ∈ [0,1] that the cached result answers the query, plus a staticity
estimate (1–10) at admission time.

* ``OracleJudge`` — decision-faithful judge for behavioural experiments:
  knows the synthetic world's ground-truth intent equivalence and flips
  decisions with configurable TPR/FPR noise. Its *scores* are drawn from
  two calibrated beta-like distributions so threshold recalibration
  (Algorithm 1) has a real precision curve to sweep.
* ``ModelJudge`` — a real tiny cross-encoder on the port's model stack
  (prefill-only, single score token — the profile that makes co-location
  cheap, §4.4); its attention is the ``flash_attention_fwd`` kernel. With
  random weights its decisions are meaningless; it exists to measure the
  judge's true compute footprint and to drive the co-location scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class JudgeVerdict:
    score: float
    equivalent: bool      # score >= threshold decided by caller (Seri)
    staticity: int = 5


class OracleJudge:
    """Ground-truth-backed judge with calibrated score noise.

    Score noise is seeded per **(pair, nth-scoring-of-that-pair)** from a
    stable hash of the pair text — not drawn from one shared stream — so
    scores do not depend on how requests are micro-batched, reordered
    across lanes, or interleaved with other requests (DESIGN.md §8:
    batched and scalar execution stay bit-identical). Re-scoring the
    same pair later re-rolls (the judge's borderline mistakes stay
    transient, so threshold recalibration sees fresh noise, as with the
    original shared-stream model)."""

    def __init__(self, world, accuracy: float = 0.98, seed: int = 0,
                 max_pairs: int = 65536):
        self.world = world
        self.seed = seed
        # score distributions: equivalent pairs ~ high, others ~ low
        self.acc = accuracy
        # nth-scoring counter per pair, LRU-bounded at max_pairs (same
        # idiom as MarkovPrefetcher._prev): an evicted pair that comes
        # back re-rolls from n=0, which only perturbs borderline-noise
        # replay on workloads with > max_pairs distinct live pairs
        self.max_pairs = max_pairs
        self._pair_counts: dict = {}

    @staticmethod
    def _u01(x: int, salt: int) -> float:
        """splitmix64 finalizer -> uniform in [0, 1). Counter-based
        hashing is ~10× cheaper than constructing a Generator per pair,
        which matters because scoring sits on the hot lookup path."""
        m = (1 << 64) - 1
        x = (x + salt * 0x9E3779B97F4A7C15) & m
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) & m
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & m
        x ^= x >> 31
        return x / 2.0**64

    def _pair_score(self, q: str, c: str) -> float:
        import zlib

        n = self._pair_counts.pop((q, c), 0)
        self._pair_counts[(q, c)] = n + 1  # reinsert = move to LRU tail
        if len(self._pair_counts) > self.max_pairs:
            self._pair_counts.pop(next(iter(self._pair_counts)))
        ent = zlib.crc32(f"{q}\x00{c}".encode())
        base = (ent << 32) ^ (n << 8) ^ (self.seed & 0xFF)
        same = self.world.same_intent(q, c)
        correct = self._u01(base, 1) < self.acc
        positive = same if correct else not same
        # Beta(1, b) via inverse CDF: x = 1 - (1-u)^(1/b)
        u = self._u01(base, 2)
        if positive:
            # P(score < 0.9) ≈ 0.04 — a few true matches fall below
            # τ_lsm=0.9; with capacity/TTL misses this lands at the
            # paper's ~85-88% steady-state hit rates
            return (1.0 - u) ** (1.0 / 30.0)
        return 1.0 - (1.0 - u) ** (1.0 / 19.0)

    def score_pairs(
        self, queries: Sequence[str], cached_keys: Sequence[str]
    ) -> np.ndarray:
        """S_lsm per (query, cached) pair."""
        out = np.empty(len(queries), np.float32)
        for i, (q, c) in enumerate(zip(queries, cached_keys)):
            out[i] = self._pair_score(q, c)
        return out

    def staticity(self, query: str) -> int:
        return self.world.staticity(query)


class ModelJudge:
    """Tiny cross-encoder: prefill-only classification (one score).

    The score of a pair is sigmoid(mean of the last position's hidden
    state) of ``"{query} [SEP] {cached}"`` as byte tokens. ``params`` (the
    port's LM parameters, e.g. from ``convert.lm_params_from_numpy``)
    replaces the seeded init, which draws on ``device``.

    :meth:`score` is the function the reference jits. On a CUDA device
    ``score_pairs`` runs it as a CUDA graph per (B, max_len), captured at
    the first micro-batch of that shape on one pool
    (``kernels/graphs.StepGraph``): the tokens go into the graph's static
    buffer from pinned memory, and the (B,) scores come down. On the CPU
    it calls :meth:`score` eagerly."""

    def __init__(self, cfg=None, max_len: int = 128, seed: int = 1,
                 device="cuda", params=None):
        from repro_torch.configs import get_config, shrink
        from repro_torch.core.embedder import byte_tokens
        from repro_torch.models.lm import LM
        from repro_torch.nn.param import init_params

        cfg = cfg or shrink(get_config("qwen3-0.6b"), d_model=128, vocab=512,
                            n_repeat=2)
        self.cfg = cfg
        self.max_len = max_len
        self.device = resolve_device(device)
        self._byte_tokens = byte_tokens
        self.lm = LM(cfg)
        self.params = params if params is not None else init_params(
            self.lm.param_specs(),
            torch.Generator(device=self.device).manual_seed(seed),
            self.device)
        self._graphs: dict = {}        # (B, max_len) -> (graph, tokens)
        self._pool = None

    def score(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens on the judge's device -> (B,) fp32 scores."""
        x = self.lm._embed(self.params, tokens)
        x, _, _ = self.lm._run_stack(self.params, x,
                                     self.lm._positions(tokens))
        # single-token classification readout (prefill-only profile)
        return torch.sigmoid(torch.mean(x[:, -1, :].float(), dim=-1))

    def score_pairs(self, queries, cached_keys) -> np.ndarray:
        toks = np.stack([
            self._byte_tokens(f"{q} [SEP] {c}", self.max_len)
            for q, c in zip(queries, cached_keys)
        ]) % self.cfg.vocab_size
        host = torch.from_numpy(toks.astype(np.int32))
        if self.device.type != "cuda":
            with torch.inference_mode():
                out = self.score(host.to(self.device))
            return out.cpu().numpy().astype(np.float32)
        graph, buf = self._graph_for(host.shape)
        buf.copy_(host.pin_memory(), non_blocking=True)
        return graph.replay().cpu().numpy().astype(np.float32)

    def _graph_for(self, shape) -> tuple:
        """The graph of :meth:`score` on a static token buffer of
        ``shape``, captured the first time it is asked for."""
        key = tuple(shape)
        if key not in self._graphs:
            from repro_torch.kernels.graphs import StepGraph

            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            buf = torch.zeros(key, dtype=torch.int32, device=self.device)

            def step():
                with torch.inference_mode():
                    return self.score(buf)

            self._graphs[key] = (StepGraph(step, self._pool), buf)
        return self._graphs[key]

    @property
    def graph_pool_bytes(self) -> int:
        """What the captures added to the judge's graph pool."""
        return sum(g.pool_bytes for g, _ in self._graphs.values())

    def staticity(self, query: str) -> int:
        # stable across processes (Python's hash() is salted per run,
        # which made admission TTLs irreproducible)
        import zlib

        return 1 + (zlib.crc32(query.encode()) % 10)


class HybridJudge:
    """Oracle decisions + model compute (used by e2e benchmarks so both the
    semantics AND the measured judge cost are faithful).

    Kept for back-compat; ``core/judge_pipeline.JudgePipeline(oracle,
    compute=model)`` is the same shim plus admission and cost derivation,
    and is what the serving stack threads through."""

    def __init__(self, oracle: OracleJudge, model: Optional[ModelJudge] = None):
        self.oracle = oracle
        self.model = model

    def score_pairs(self, queries, cached_keys) -> np.ndarray:
        if self.model is not None:
            self.model.score_pairs(queries, cached_keys)  # pay the compute
        return self.oracle.score_pairs(queries, cached_keys)

    def staticity(self, query: str) -> int:
        return self.oracle.staticity(query)

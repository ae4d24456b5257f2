"""JudgePipeline — the one stage-2 seam (DESIGN.md §14).

Every layer that judges — the serving engine's micro-batched dispatcher,
``CortexCache``/``TieredCache`` batched lookups (including warm-promotion
validation), and federation's peek/lease validation — routes through one
:class:`JudgePipeline`, which owns three things:

* **Adaptive admission** (:class:`AdmissionBand`): a confidence band
  around τ_sim. Stage-1 candidates whose similarity clears the band's
  upper edge are trusted without paying judge latency (bypass hit); the
  stage-1 gate drops to the band's lower edge so borderline candidates
  that used to be silent misses get judged instead; anything below the
  lower edge goes straight to origin. Only the uncertain band pays the
  judge. ``width == 0`` collapses to each seam's legacy policy — the
  engine judges every candidate, federation peeks stay ANN-only — so the
  band machinery is event-neutral when disabled.
* **Model-derived cost**: the judge job's token-equivalent cost on the
  GPU lanes derives from the judge model config's prefill FLOPs
  (``launch/roofline.model_flops``) normalized by one agent-model token,
  instead of a hard-coded constant. Changing the judge's ``d_model``
  changes the measured judge latency.
* **Calibration shim** (generalizing ``HybridJudge``): decision
  semantics come from a ground-truth-faithful scorer (``OracleJudge``)
  while the compute — both the virtual-time cost above and, when
  ``compute`` is set, real tiny-LM ``score_pairs`` work — is
  model-faithful. Benchmarks stay comparable; the co-location scheduler
  sees the real footprint.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs.trace import BACKGROUND, NULL_TRACER
from repro_torch.serving.gpu import judge_batch_tokens


def default_judge_cfg(d_model: int = 128, vocab: int = 512,
                      n_repeat: int = 2):
    """The reproduction's stage-2 judge model: the tiny qwen3-family
    cross-encoder ``ModelJudge`` instantiates (prefill-only, single
    score token)."""
    from repro_torch.configs import get_config, shrink

    return shrink(get_config("qwen3-0.6b"), d_model=d_model, vocab=vocab,
                  n_repeat=n_repeat)


def agent_reference_cfg():
    """The reproduction's co-located *agent* model: same shrink family as
    the judge but at the source model's native width (d_model=1024).
    One prefill token of this config is the GPU lanes' token-equivalent
    unit, so judge cost is expressed in the same currency as
    ``think_tokens``/``answer_tokens``."""
    from repro_torch.configs import get_config, shrink

    return shrink(get_config("qwen3-0.6b"), d_model=1024, vocab=512,
                  n_repeat=2)


def judge_token_cost(judge_cfg=None, max_len: int = 128,
                     agent_cfg=None) -> float:
    """Token-equivalent cost of ONE judge prefill, derived from model
    configs: judge prefill FLOPs over ``max_len`` tokens divided by the
    per-token prefill FLOPs of the agent reference model. The default
    judge config (d_model=128) costs 16.0 token-eq; d_model=256 costs
    32.0 — the co-location scheduler prices the actual model."""
    from repro_torch.launch.roofline import model_flops

    judge_cfg = judge_cfg if judge_cfg is not None else default_judge_cfg()
    agent_cfg = agent_cfg if agent_cfg is not None else agent_reference_cfg()
    return (model_flops(judge_cfg, "prefill", max_len)
            / model_flops(agent_cfg, "prefill", 1))


@dataclasses.dataclass
class AdmissionBand:
    """Confidence band of total ``width`` centered on τ_sim.

    ``classify`` edges are pinned (tests/test_judge_pipeline.py):
    ``sim >= hi`` is *trust* (upper edge INCLUSIVE — a candidate exactly
    at the edge bypasses), ``lo <= sim < hi`` is *uncertain* (lower edge
    INCLUSIVE — a candidate exactly at the stage-1 gate is judged, never
    silently dropped), ``sim < lo`` is *reject*. ``adaptive`` arms the
    engine's recalibration tick to re-derive the width from the stage-1
    similarity precision curve alongside τ_lsm."""

    width: float = 0.0
    adaptive: bool = False

    def lo(self, tau_sim: float) -> float:
        return tau_sim - self.width / 2.0

    def hi(self, tau_sim: float) -> float:
        return tau_sim + self.width / 2.0

    def classify(self, sim: float, tau_sim: float) -> str:
        if sim >= self.hi(tau_sim):
            return "trust"
        if sim >= self.lo(tau_sim):
            return "uncertain"
        return "reject"


@dataclasses.dataclass
class PipelineStats:
    judged_pairs: int = 0       # (query, key) pairs actually scored
    judge_batches: int = 0      # score_pairs calls (micro-batches)
    bypass_hits: int = 0        # band trust: hit served without a judge
    band_judged: int = 0        # engine entries that paid judge latency
    lease_validations: int = 0  # federation in-band leases judged
    lease_rejections: int = 0   # ... of which the judge rejected


class JudgePipeline:
    """One dispatch seam for stage-2 validation.

    ``decisions`` supplies the scores that drive hit/miss semantics
    (``OracleJudge`` in behavioural runs, ``ModelJudge`` end to end when
    semantics-faithfulness is not required). ``compute``, when set, is a
    ``ModelJudge`` whose ``score_pairs`` is *paid* (real tiny-LM prefill)
    and discarded — the calibration shim. ``base_tokens`` is the
    virtual-time cost of one unbatched judge job; by default it derives
    from ``judge_cfg`` via :func:`judge_token_cost` (which is also how
    ``compute``'s config prices itself when given).
    """

    def __init__(
        self,
        decisions,
        *,
        compute=None,
        judge_cfg=None,
        max_len: int = 128,
        band: Optional[AdmissionBand] = None,
        base_tokens: Optional[float] = None,
    ):
        self.decisions = decisions
        self.compute = compute
        if judge_cfg is None:
            judge_cfg = (compute.cfg if compute is not None
                         else getattr(decisions, "cfg", None))
        self.judge_cfg = (judge_cfg if judge_cfg is not None
                          else default_judge_cfg())
        self.max_len = (compute.max_len if compute is not None else max_len)
        self.band = band
        self.base_tokens = (
            base_tokens if base_tokens is not None
            else judge_token_cost(self.judge_cfg, self.max_len)
        )
        self.stats = PipelineStats()
        self._tracer = NULL_TRACER
        self._clock = None
        self._region = 0

    def bind_tracer(self, tracer, clock, region: int = 0) -> None:
        """Arm §15 tracing: holder-side lease validations emit a
        background marker stamped with this pipeline's region. Purely
        observational — no virtual-time effect."""
        self._tracer = tracer
        self._clock = clock
        self._region = region

    # ------------------------------------------------------------ scoring

    def score_pairs(self, queries: Sequence[str],
                    cached_keys: Sequence[str]) -> np.ndarray:
        """THE scoring seam: one call per micro-batch. Pays the real
        model compute when the shim is armed, returns the decision
        scorer's values."""
        self.stats.judge_batches += 1
        self.stats.judged_pairs += len(queries)
        if self.compute is not None:
            self.compute.score_pairs(queries, cached_keys)
        return self.decisions.score_pairs(queries, cached_keys)

    def staticity(self, query: str) -> int:
        return self.decisions.staticity(query)

    # ---------------------------------------------------------- admission

    def stage1_gate(self, tau_sim: float) -> float:
        """Similarity gate stage 1 should apply: the band's lower edge
        when a band is armed (borderline candidates surface so the judge
        can recover them), τ_sim otherwise."""
        if self.band is not None and self.band.width > 0:
            return self.band.lo(tau_sim)
        return tau_sim

    def admit(self, sims, tau_sim: float) -> str:
        """Engine-side admission for one candidate block (sims are the
        surviving stage-1 similarities, descending). Returns ``"miss"``
        (no candidates), ``"bypass"`` (best candidate clears the band's
        upper edge — serve it without judging), or ``"judge"``. With no
        band (or width 0) every non-empty block is judged — the legacy
        judge-everything engine, event for event."""
        if not len(sims):
            return "miss"
        if self.band is None or self.band.width <= 0:
            return "judge"
        if self.band.classify(float(sims[0]), tau_sim) == "trust":
            self.stats.bypass_hits += 1
            return "bypass"
        self.stats.band_judged += 1
        return "judge"

    def validate_lease(self, query: str, key: str, sim: float,
                       tau_sim: float, tau_lsm: float) -> bool:
        """Federation peek/lease validation. A probe site has no judge
        lane, so the band IS the policy: trust leases ship ANN-only (as
        every lease did before the band existed — width 0 keeps that
        legacy exactly), in-band leases pay one judge score and must
        clear τ_lsm, below-band candidates never surface (the stage-1
        gate). Cost note: peer-side judge time is folded into the probe
        RTT, matching the half-RTT granularity of the peek protocol."""
        if self.band is None or self.band.width <= 0:
            return True
        if self.band.classify(sim, tau_sim) != "uncertain":
            return True
        self.stats.lease_validations += 1
        if self._tracer.enabled and self._clock is not None:
            self._tracer.marker(BACKGROUND, "lease_validate",
                                self._clock.now, self._region)
        score = float(self.score_pairs([query], [key])[0])
        if score >= tau_lsm:
            return True
        self.stats.lease_rejections += 1
        return False

    # ------------------------------------------------------------- timing

    def batch_tokens(self, m: int, marginal: float = 0.5) -> float:
        """Virtual-time cost of a judge micro-batch of ``m`` requests:
        the co-location formula (``serving/gpu.judge_batch_tokens``)
        over the model-derived base cost."""
        return judge_batch_tokens(self.base_tokens, m, marginal)


def as_pipeline(judge) -> JudgePipeline:
    """Wrap a raw judge object in a default pipeline (no band, cost
    derived from the default judge config); a JudgePipeline passes
    through unchanged. The seam every ``Seri`` construction funnels
    through."""
    if isinstance(judge, JudgePipeline):
        return judge
    return JudgePipeline(judge)

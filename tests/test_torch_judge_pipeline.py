"""The port's ``core/judge_pipeline.py`` (DESIGN.md §14) against the JAX
package's: analogues of tests/test_judge_pipeline.py's 13 tests, each
running the reference's case on both packages' objects and holding the
port's answers, counters and costs to the reference's.

Tolerances: none. The band edges, the admission decisions, the pipeline's
counters, the token costs and the oracle's scores are the reference's
numpy code carried over, so they are equal; the model judge's scores are
bitwise batch-invariant in each package (its cross-package agreement is
tests/test_torch_judge.py's). The model judge runs on the CPU (kernel 6's
plain version).
"""
import numpy as np
import pytest

from repro.core.judge import ModelJudge as RefModelJudge
from repro.core.judge import OracleJudge as RefOracle
from repro.core.judge_pipeline import AdmissionBand as RefBand
from repro.core.judge_pipeline import JudgePipeline as RefPipeline
from repro.core.judge_pipeline import as_pipeline as ref_as_pipeline
from repro.core.judge_pipeline import default_judge_cfg as ref_judge_cfg
from repro.core.judge_pipeline import judge_token_cost as ref_token_cost
from repro.data.world import SemanticWorld as RefWorld
from repro_torch.core.judge import ModelJudge, OracleJudge
from repro_torch.core.judge_pipeline import (AdmissionBand, JudgePipeline,
                                             as_pipeline, default_judge_cfg,
                                             judge_token_cost)
from repro_torch.data.world import SemanticWorld

WORLD = SemanticWorld(n_intents=60, dim=32, seed=7)
REF_WORLD = RefWorld(n_intents=60, dim=32, seed=7)


def _both(**kw):
    """(port, reference) oracles of the reference test's settings."""
    return (OracleJudge(WORLD, accuracy=0.98, seed=1, **kw),
            RefOracle(REF_WORLD, accuracy=0.98, seed=1, **kw))


def _pipes(width=0.1, **kw):
    port, ref = _both()
    band = {} if width is None else {"band": AdmissionBand(width=width)}
    ref_band = {} if width is None else {"band": RefBand(width=width)}
    return (JudgePipeline(port, **band, **kw),
            RefPipeline(ref, **ref_band, **kw))


def _stats(pipe) -> dict:
    return dict(vars(pipe.stats))


def test_band_edges_pinned():
    tau = 0.9
    for band in (AdmissionBand(width=0.1), RefBand(width=0.1)):
        assert band.lo(tau) == pytest.approx(0.85)
        assert band.hi(tau) == pytest.approx(0.95)
    port, ref = AdmissionBand(width=0.1), RefBand(width=0.1)
    assert (port.lo(tau), port.hi(tau)) == (ref.lo(tau), ref.hi(tau))
    for sim in (ref.hi(tau), ref.hi(tau) - 1e-9, ref.lo(tau),
                ref.lo(tau) - 1e-9, 0.0, 1.0):
        assert port.classify(sim, tau) == ref.classify(sim, tau)
    assert port.classify(port.hi(tau), tau) == "trust"
    assert port.classify(port.lo(tau), tau) == "uncertain"
    assert port.classify(port.lo(tau) - 1e-9, tau) == "reject"


def test_admit_high_sim_bypasses_judge():
    port, ref = _pipes()
    sims = np.array([0.97, 0.91])
    assert port.admit(sims, 0.9) == ref.admit(sims, 0.9) == "bypass"
    assert _stats(port) == _stats(ref)
    assert port.stats.bypass_hits == 1 and port.stats.band_judged == 0


def test_admit_uncertain_band_pays_judge():
    port, ref = _pipes()
    sims = np.array([0.91])
    assert port.admit(sims, 0.9) == ref.admit(sims, 0.9) == "judge"
    assert _stats(port) == _stats(ref)
    assert port.stats.band_judged == 1 and port.stats.bypass_hits == 0


def test_admit_low_sim_shortcut_to_miss():
    port, ref = _pipes()
    assert port.stage1_gate(0.9) == ref.stage1_gate(0.9)
    assert port.stage1_gate(0.9) == pytest.approx(0.85)
    assert port.admit(np.array([]), 0.9) == ref.admit(np.array([]), 0.9) \
        == "miss"


def test_width_zero_is_legacy_per_seam():
    for width in (0.0, None):
        port, ref = _pipes(width)
        s = np.array([0.999])
        assert port.admit(s, 0.9) == ref.admit(s, 0.9) == "judge"
        assert port.stage1_gate(0.9) == ref.stage1_gate(0.9) == 0.9
        assert port.validate_lease("q", "k", 0.5, 0.9, 0.9) is \
            ref.validate_lease("q", "k", 0.5, 0.9, 0.9) is True
        assert port.stats.lease_validations == 0
        assert _stats(port) == _stats(ref)


def test_validate_lease_in_band_judges():
    port, ref = _pipes()
    assert port.validate_lease("q", "k", 0.97, 0.9, 0.9) is \
        ref.validate_lease("q", "k", 0.97, 0.9, 0.9) is True
    assert port.stats.lease_validations == 0
    for i in range(6):
        q, k = WORLD.query(i % 3, i), WORLD.query(i % 3, 0)
        for sim in (0.86, 0.9, 0.94):
            assert port.validate_lease(q, k, sim, 0.9, 0.9) == \
                ref.validate_lease(q, k, sim, 0.9, 0.9)
    assert _stats(port) == _stats(ref)
    assert port.stats.lease_validations == port.stats.judged_pairs == 18


def test_judge_token_cost_tracks_d_model():
    for d in (64, 128, 256):
        assert judge_token_cost(default_judge_cfg(d_model=d)) == \
            ref_token_cost(ref_judge_cfg(d_model=d))
    assert judge_token_cost(default_judge_cfg(d_model=128)) == \
        pytest.approx(16.0)
    assert judge_token_cost(default_judge_cfg(d_model=256)) == \
        pytest.approx(32.0)


def test_pipeline_base_tokens_from_cfg_no_constant():
    for d in (64, 256):
        port = JudgePipeline(_both()[0], judge_cfg=default_judge_cfg(
            d_model=d))
        ref = RefPipeline(_both()[1], judge_cfg=ref_judge_cfg(d_model=d))
        assert port.base_tokens == ref.base_tokens
        for m, marginal in ((1, 0.5), (4, 0.5), (7, 0.25)):
            assert port.batch_tokens(m, marginal) == \
                ref.batch_tokens(m, marginal)
    small = JudgePipeline(_both()[0], judge_cfg=default_judge_cfg(d_model=64))
    big = JudgePipeline(_both()[0], judge_cfg=default_judge_cfg(d_model=256))
    assert big.base_tokens > small.base_tokens
    assert small.batch_tokens(4, 0.5) == pytest.approx(
        small.base_tokens * 2.5)


def test_model_judge_batch_bit_identical_to_solo():
    """DESIGN.md §8 in each package: any micro-batch split of the pairs
    gives the batched scores bitwise."""
    qs = [WORLD.query(i % 4, i) for i in range(6)]
    ks = [WORLD.query(i % 4, i + 1) for i in range(6)]
    for judge in (ModelJudge(cfg=default_judge_cfg(d_model=64), max_len=32,
                             seed=3, device="cpu"),
                  RefModelJudge(cfg=ref_judge_cfg(d_model=64), max_len=32,
                                seed=3)):
        batched = judge.score_pairs(qs, ks)
        for cut in (1, 2, 5):
            parts = np.concatenate([judge.score_pairs(qs[:cut], ks[:cut]),
                                    judge.score_pairs(qs[cut:], ks[cut:])])
            assert np.array_equal(batched, parts)


def test_pipeline_scores_come_from_decisions_not_compute():
    port_oracle, ref_oracle = _both()
    model = ModelJudge(cfg=default_judge_cfg(d_model=64), max_len=32, seed=3,
                       device="cpu")
    ref_model = RefModelJudge(cfg=ref_judge_cfg(d_model=64), max_len=32,
                              seed=3)
    port = JudgePipeline(port_oracle, compute=model)
    ref = RefPipeline(ref_oracle, compute=ref_model)
    q, k = [WORLD.query(0, 0), WORLD.query(1, 2)], \
        [WORLD.query(0, 1), WORLD.query(2, 0)]
    assert np.array_equal(port.score_pairs(q, k), ref.score_pairs(q, k))
    assert _stats(port) == _stats(ref)
    assert port.stats.judge_batches == 1


def test_staticity_stable_and_deterministic():
    judge = ModelJudge(cfg=default_judge_cfg(d_model=64), max_len=32,
                       device="cpu")
    ref = RefModelJudge(cfg=ref_judge_cfg(d_model=64), max_len=32)
    for q in ("some query", WORLD.query(3, 1), ""):
        vals = {judge.staticity(q) for _ in range(5)}
        assert len(vals) == 1 and 1 <= next(iter(vals)) <= 10
        assert judge.staticity(q) == ref.staticity(q)


def test_oracle_pair_counts_lru_bounded():
    port, ref = _both(max_pairs=8)
    pairs = [(WORLD.query(i % 50, i), WORLD.query(i % 50, 0))
             for i in range(50)]
    for q, k in pairs:
        assert np.array_equal(port.score_pairs([q], [k]),
                              ref.score_pairs([q], [k]))
    assert list(port._pair_counts) == list(ref._pair_counts)
    assert len(port._pair_counts) <= 8
    assert pairs[-1] in port._pair_counts
    assert pairs[0] not in port._pair_counts


def test_as_pipeline_idempotent():
    port_oracle, ref_oracle = _both()
    pipe = JudgePipeline(port_oracle)
    assert as_pipeline(pipe) is pipe
    wrapped, ref_wrapped = as_pipeline(port_oracle), \
        ref_as_pipeline(ref_oracle)
    assert isinstance(wrapped, JudgePipeline)
    assert wrapped.band is None and ref_wrapped.band is None
    assert wrapped.base_tokens == ref_wrapped.base_tokens

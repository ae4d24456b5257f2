"""Periodic threshold recalibration — Algorithm 1 (paper §4.2).

Offline, decoupled from the serving path: sample recent (query, cached)
pairs from the eval log, fetch ground truth by re-issuing the query to the
live tool, label semantic equivalence, sweep the judge's precision curve,
and pick the smallest threshold achieving the target precision.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass
class EvalRecord:
    query: str
    cached_key: str
    cached_value: object
    score: float  # S_lsm the judge emitted online
    # stage-1 cosine of the candidate the judge scored; -1.0 = not
    # recorded (pre-band logs). Lets the same tick recalibrate the
    # admission band's trust edge alongside τ_lsm (DESIGN.md §14).
    sim: float = -1.0


@dataclasses.dataclass
class Recalibration:
    tau: float
    precision: float
    n_samples: int
    curve: list  # (threshold, precision, recall)
    # smallest stage-1 similarity whose prefix precision ≥ P_target —
    # the admission band's recalibrated trust edge; None when the
    # sampled records carry no sims
    sim_tau: float | None = None


def precision_curve(scores: np.ndarray, labels: np.ndarray):
    """Sweep thresholds (descending scores); precision/recall at each."""
    # full-sort audit: the cumulative TP/FP sweep needs EVERY
    # threshold in order (find_threshold scans the whole curve), so this
    # is not a top-k selection — and it runs off the serving path, once
    # per recal tick over ≤ 512 samples. argsort stays.
    order = np.argsort(-scores)
    s = scores[order]
    l = labels[order].astype(np.float64)
    tp = np.cumsum(l)
    fp = np.cumsum(1.0 - l)
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / max(l.sum(), 1)
    return [(float(s[i]), float(prec[i]), float(rec[i])) for i in range(len(s))]


def find_threshold(curve, p_target: float, default: float = 0.99) -> float:
    """Smallest threshold whose prefix precision ≥ P_target (max recall)."""
    best = None
    for thr, prec, _rec in curve:
        if prec >= p_target:
            best = thr
    return best if best is not None else default


def recalibrate(
    log: Sequence[EvalRecord],
    fetch_ground_truth: Callable[[str], object],
    evaluate_equiv: Callable[[object, object], bool],
    *,
    p_target: float = 0.99,
    sample_size: int = 64,
    rng: np.random.Generator | None = None,
) -> Recalibration:
    """Algorithm 1. fetch_ground_truth re-issues the query to the live tool
    (costed by the caller); evaluate_equiv compares cached vs ground."""
    rng = rng or np.random.default_rng(0)
    if not log:
        return Recalibration(0.9, 1.0, 0, [])
    idx = rng.permutation(len(log))[: min(sample_size, len(log))]
    sample = [log[i] for i in idx]
    labels = np.array([
        evaluate_equiv(r.cached_value, fetch_ground_truth(r.query))
        for r in sample
    ])
    scores = np.array([r.score for r in sample], np.float64)
    curve = precision_curve(scores, labels)
    tau = find_threshold(curve, p_target)
    # realised precision at tau
    keep = scores >= tau
    prec = float(labels[keep].mean()) if keep.any() else 1.0
    # the SAME labeled sample re-sweeps the stage-1 similarity axis:
    # above sim_tau the ANN alone meets the precision target, which is
    # exactly the "trust" region the admission band may bypass
    sims = np.array([r.sim for r in sample], np.float64)
    sim_tau = None
    if (sims >= 0).all() and len(sims):
        sim_tau = float(find_threshold(precision_curve(sims, labels),
                                       p_target, default=1.0))
    return Recalibration(float(tau), prec, len(sample), curve,
                         sim_tau=sim_tau)

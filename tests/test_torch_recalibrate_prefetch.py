"""The port's threshold recalibration (Algorithm 1, ``core/recalibrate.py``)
and Markov prefetcher (``core/prefetch.py``) against the JAX package's:
analogues of tests/test_recalibrate_prefetch.py's 6 tests.

Both modules are the reference's numpy code carried over, so every
result is held equal, with no tolerance: the precision curve, the
threshold, the recalibration's result and the prefetcher's tables and
predictions. The reference's two property tests (``hypothesis``, absent
here, so they skip) become fixed, seeded draws of the same properties.
"""
import numpy as np
import pytest

from repro.core.prefetch import MarkovPrefetcher as RefPrefetcher
from repro.core.recalibrate import EvalRecord as RefRecord
from repro.core.recalibrate import find_threshold as ref_find_threshold
from repro.core.recalibrate import precision_curve as ref_precision_curve
from repro.core.recalibrate import recalibrate as ref_recalibrate
from repro.data.world import SemanticWorld as RefWorld
from repro_torch.core.prefetch import MarkovPrefetcher
from repro_torch.core.recalibrate import (EvalRecord, find_threshold,
                                          precision_curve, recalibrate)
from repro_torch.data.world import SemanticWorld


def _curves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(map(float, x)) == tuple(map(float, y))


def test_precision_curve_prefix_semantics(rng):
    scores = rng.random(200)
    labels = rng.random(200) > 0.3
    curve = precision_curve(scores, labels)
    _curves_equal(curve, ref_precision_curve(scores, labels))
    for thr, prec, _ in curve[::20]:
        keep = scores >= thr
        assert abs(prec - labels[keep].mean()) < 1e-9


@pytest.mark.parametrize("p_target", [0.5, 0.62, 0.75, 0.9, 0.95, 0.99])
def test_find_threshold_achieves_target(p_target):
    rng = np.random.default_rng(3)
    n = 400
    labels = rng.random(n) < 0.6
    scores = np.where(labels, 1 - rng.beta(1, 19, n), rng.beta(1, 19, n))
    curve = precision_curve(scores, labels)
    tau = find_threshold(curve, p_target)
    assert tau == ref_find_threshold(ref_precision_curve(scores, labels),
                                     p_target)
    keep = scores >= tau
    if keep.any():
        assert labels[keep].mean() >= p_target - 1e-9


def test_recalibrate_end_to_end():
    """The reference test's log, built once with each package's world and
    record type from the same draws; the same sampled result."""
    results = []
    for world_cls, record, fn in ((SemanticWorld, EvalRecord, recalibrate),
                                  (RefWorld, RefRecord, ref_recalibrate)):
        world = world_cls(n_intents=200, dim=64, seed=0)
        rng = np.random.default_rng(0)
        log = []
        for _ in range(300):
            intent = int(rng.integers(0, 100))
            wrong = rng.random() < 0.3
            c_intent = intent + 1 if wrong else intent
            q = world.query(intent, int(rng.integers(0, 20)))
            c = world.query(c_intent % 100, 0)
            score = (float(rng.beta(1, 19)) if wrong
                     else float(1 - rng.beta(1, 19)))
            log.append(record(q, c, world.answer(c), score))
        res = fn(log, world.fetch, world.equivalent, p_target=0.95,
                 sample_size=128, rng=rng)
        results.append(res)
    port, ref = results
    assert port.precision >= 0.9 and 0.0 < port.tau <= 1.0
    assert (port.tau, port.precision) == (ref.tau, ref.precision)
    assert vars(port).keys() == vars(ref).keys()
    for key in vars(ref):
        a, b = getattr(port, key), getattr(ref, key)
        if key == "curve":
            _curves_equal(a, b)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), key


def test_markov_prefetcher_learns_transitions():
    preds = []
    for cls in (MarkovPrefetcher, RefPrefetcher):
        pf = cls(confidence=0.6, min_support=3)
        for _ in range(5):
            for s in ("a", "b", "c"):
                pf.observe(s)
            pf.reset_session()
        preds.append((pf.predict("a"), pf.predict("b"), pf.predict("c")))
    port, ref = preds
    assert port[0] is not None and port[0].state == "b" \
        and port[0].prob == 1.0
    assert port[2] is None
    for a, b in zip(port, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.state, a.prob, a.support) == (b.state, b.prob,
                                                    b.support)


def test_markov_interleaved_sessions_match_sequential():
    """Keyed by session id, any interleaving learns the sequential table,
    in both packages; one shared chain does not."""
    streams = {"s1": ["a", "b", "c", "a", "b"],
               "s2": ["x", "y", "x", "y", "x"],
               "s3": ["b", "a", "b", "a", "b"]}
    sequential = [(k, s) for k in sorted(streams) for s in streams[k]]
    interleaved = [(k, streams[k][i]) for i in range(5)
                   for k in sorted(streams)]

    def learn(cls, order, keyed=True):
        pf = cls(confidence=0.0, min_support=1)
        for key, state in order:
            pf.observe(state, key=key) if keyed else pf.observe(state)
        return dict(pf.trans), dict(pf.totals)

    for cls in (MarkovPrefetcher, RefPrefetcher):
        assert learn(cls, sequential) == learn(cls, interleaved)
        assert learn(cls, interleaved, keyed=False) != \
            learn(cls, sequential)
    assert learn(MarkovPrefetcher, interleaved) == \
        learn(RefPrefetcher, interleaved)
    assert learn(MarkovPrefetcher, interleaved, keyed=False) == \
        learn(RefPrefetcher, interleaved, keyed=False)


@pytest.mark.parametrize("seed", range(6))
def test_markov_probabilities_valid(seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 5, int(rng.integers(2, 201))).tolist()
    port, ref = (cls(confidence=0.0, min_support=1)
                 for cls in (MarkovPrefetcher, RefPrefetcher))
    for s in seq:
        port.observe(s)
        ref.observe(s)
    assert (dict(port.trans), dict(port.totals)) == \
        (dict(ref.trans), dict(ref.totals))
    for s in set(seq):
        pred, want = port.predict(s), ref.predict(s)
        assert (pred is None) == (want is None)
        if pred is not None:
            assert 0.0 < pred.prob <= 1.0
            assert pred.support <= port.totals[s]
            assert (pred.state, pred.prob, pred.support) == \
                (want.state, want.prob, want.support)
